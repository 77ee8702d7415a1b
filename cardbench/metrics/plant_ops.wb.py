"""Device activities an MPC period of the articulated loop in its five
plant ticks (period.plant: plant.whole_body), from the phase table of each
matched replay: the graph nodes the host's launch submits."""
from cardbench.yardstick import spans as S


def read(ctx):
    return S.phase_ops(ctx, 'period.plant')
