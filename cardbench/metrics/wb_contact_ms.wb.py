"""Device milliseconds an MPC period of the articulated loop in the
plant's ground contact (the wb.contact rows of plant.whole_body.step:
contact_forces, twenty substeps), from the matched replays' phase tables;
None where the program has no such rows."""
from cardbench.yardstick import spans as S


def read(ctx):
    return S.phase_ms(ctx, 'wb.contact')
