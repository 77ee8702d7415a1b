"""Device time a planning step outside the port's own CUDA kernels: the
small PyTorch and library ops of runtime.controller_tick, mpc and
qp.builder, from the trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, exclude=T.PORT_KERNELS)
