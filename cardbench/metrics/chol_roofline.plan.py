"""The Cholesky kernels' share of their roofline, in %: the frozen
factor_bytes and solve_bytes of the dense step's KKT matrices (n = 12 x
the horizon), times the launches of every factor and every solve kernel
by the port's counters and the lanes, at the HBM bandwidth, over the
device time of every Cholesky kernel in the traced steps."""
from cardbench.yardstick import trace as T
from cardbench.yardstick import workcounts as W


def read(ctx):
    kernel_ms = T.per_unit_ms(ctx, T.CHOL)
    n = ctx.work.get('kkt_n')
    if kernel_ms is None or n is None:
        return None
    counted = set(T.COUNTED.values())
    factors = sum(ctx.launches.get(c, 0) for c in counted
                  if c.startswith('factor'))
    solves = sum(ctx.launches.get(c, 0) for c in counted
                 if c.startswith('solve'))
    n_bytes = ctx.work['lanes'] * (factors * W.factor_bytes(n)
                                   + solves * W.solve_bytes(n))
    bound, _ = W.bound_s(n_bytes, 0)
    return 100.0 * bound / (kernel_ms * 1e-3)
