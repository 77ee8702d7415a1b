"""Device time a planning step of the dense path outside the port's own
CUDA kernels: the small PyTorch and library ops of
runtime.controller_tick, mpc, qp.builder and the dense interior point's
KKT assembly (qp.pdip), from the trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, exclude=T.PORT_KERNELS)
