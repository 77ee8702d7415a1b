"""Device time an MPC period outside the port's own CUDA kernels: five
ticks of runtime.controller_tick, five plant.srb steps and the quarantine,
from the trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, exclude=T.PORT_KERNELS)
