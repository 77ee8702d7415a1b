"""Device time of the Cholesky factor and solve kernels a planning step
(qp.chol, csrc/chol.cu), from the trace."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.per_unit_ms(ctx, T.CHOL)
