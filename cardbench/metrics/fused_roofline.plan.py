"""The fused Riccati kernel ``<false>``'s share of its roofline, in %: the
least time the card could take (the larger of the operations these QPs
need, each lane's freeze iteration through the frozen op_count, at the
float32 peak, and the frozen bytes_per_scenario at the HBM bandwidth)
over the kernel's device time in the traced steps."""
from cardbench.yardstick import trace as T
from cardbench.yardstick import workcounts as W


def read(ctx):
    ops = ctx.work.get('fused_operations')
    kernel_ms = T.per_unit_ms(ctx, T.FUSED_FALSE)
    if ops is None or kernel_ms is None:
        return None
    bound, _ = W.bound_s(ctx.work['fused_bytes'], ops)
    return 100.0 * bound / (kernel_ms * 1e-3 * ctx.units)
