"""The articulated plant's share of its roofline, in %: the least time the
card could take for an MPC period's plant ticks (the larger of the
operations of one substep by the minimal algorithm at the float32 peak
and the bytes of the state in and out at the HBM bandwidth, both frozen
in yardstick/wb_work.py, times the period's substeps and the lanes) over
its device time (plant_ms.wb).  It charges the same work whatever
implements the plant."""
from cardbench.yardstick import spans as S
from cardbench.yardstick import wb_work as W
from cardbench.yardstick import workcounts as WC


def read(ctx):
    plant_ms = S.phase_ms(ctx, 'period.plant')
    lanes = ctx.work.get('lanes')
    substeps = ctx.work.get('plant_substeps')
    if plant_ms is None or not plant_ms or not lanes or not substeps:
        return None
    n = lanes * substeps
    bound, _ = WC.bound_s(n * W.bytes_per_substep(),
                          n * W.operations_per_substep())
    return 100.0 * bound / (plant_ms * 1e-3)
