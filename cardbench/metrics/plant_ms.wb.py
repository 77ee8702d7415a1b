"""Device milliseconds an MPC period of the articulated loop in its five
plant ticks (period.plant: plant.whole_body, twenty substeps), each traced
replay's device events matched to its capture's phase table node by
node."""
from cardbench.yardstick import spans as S


def read(ctx):
    return S.phase_ms(ctx, 'period.plant')
