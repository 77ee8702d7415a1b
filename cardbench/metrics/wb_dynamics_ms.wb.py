"""Device milliseconds an MPC period of the articulated loop in the
plant's dynamics terms (the wb.dynamics rows of plant.whole_body.step,
twenty substeps: rnea.dynamics's mass matrix, bias forces, contact points
and Jacobian), from the matched replays' phase tables; None where the
program has no such rows."""
from cardbench.yardstick import spans as S


def read(ctx):
    return S.phase_ms(ctx, 'wb.dynamics')
