"""Device time of the fused Riccati kernel with the active-set polish,
``<true>``, a planning step (qp.fused_riccati, csrc/fused_riccati_warp.cu),
from the trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, T.FUSED_TRUE)
