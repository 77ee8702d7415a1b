"""Device time of the fused Riccati kernel ``<false>`` an MPC period of
the closed loop (qp.fused_riccati, csrc/fused_riccati_warp.cu), from the
trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, T.FUSED_FALSE)
