"""Device milliseconds an MPC period of the articulated loop in the
plant's implicit solve (the wb.solve rows of plant.whole_body.step: the
servo and implicit terms on both sides, the 16x16 solve and its count,
twenty substeps), from the matched replays' phase tables; None where the
program has no such rows."""
from cardbench.yardstick import spans as S


def read(ctx):
    return S.phase_ms(ctx, 'wb.solve')
