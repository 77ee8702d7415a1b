"""The fused Riccati kernel with the active-set polish, ``<true>``: its
share of its roofline, in %.  The least time the card could take is the
larger of two: the operations of the configuration's interior-point
iterations and polish steps (polish_rounds x polish_iters) through the
frozen op_count, at the float32 peak, and the frozen bytes_per_scenario at
the HBM bandwidth, for the batch's lanes.  It is divided by the kernel's
device time a traced step.  The settings are read from
configs/hector-h10-polish.json, so that the work is the configuration's,
not what the kernel happens to do; with the polish on no lane freezes, so
the iterations are exact."""
import json
from pathlib import Path

from cardbench.yardstick import trace as T
from cardbench.yardstick import workcounts as W

CONFIG = Path(__file__).resolve().parents[1] / 'configs' / \
    'hector-h10-polish.json'


def read(ctx):
    kernel_ms = T.per_unit_ms(ctx, T.FUSED_TRUE)
    lanes = ctx.work.get('lanes')
    if kernel_ms is None or lanes is None:
        return None
    solver = json.loads(CONFIG.read_text())['solver']
    ops = lanes * W.operations(
        solver['iterations'], solver['polish_rounds'] * solver['polish_iters'])
    bound, _ = W.bound_s(lanes * W.bytes_per_scenario(), ops)
    return 100.0 * bound / (kernel_ms * 1e-3)
