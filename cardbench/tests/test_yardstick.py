"""The trace arithmetic, the rooflines and the frozen work counts, against
numbers worked by hand on synthetic event lists."""

import importlib.util
from pathlib import Path

import pytest

from cardbench.run import TraceContext
from cardbench.yardstick import trace as T
from cardbench.yardstick import workcounts as W

METRICS = Path(__file__).resolve().parents[1] / 'metrics'
FUSED = 'void (anonymous namespace)::fused_riccati_warp_kernel<false>(float)'


def metric(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(events, units=1, wall=0.010, launches=None, work=None, hosts=()):
    return TraceContext(events, list(hosts), units, wall, launches or {},
                        work or {}, 1)


def test_busy_is_the_union_of_spans():
    events = [('a', 0.0, 10.0), ('b', 5.0, 10.0), ('c', 30.0, 5.0),
              ('d', 31.0, 1.0)]
    assert T.busy_us(events) == 20.0


def test_idle_gaps_are_named_by_the_host_activity_that_overlaps_most():
    events = [('a', 0.0, 15.0), ('b', 30.0, 5.0), ('c', 36.0, 1.0)]
    hosts = [('cudaGraphLaunch', 14.0, 10.0), ('aten::copy_', 20.0, 20.0)]
    gaps = T.idle_gaps(events, hosts)
    assert gaps[0][0] == 'host: aten::copy_'
    assert gaps[0][1] == pytest.approx(15e-6)
    assert gaps[1] == ['host: aten::copy_', pytest.approx(1e-6)]


def test_kernel_and_small_op_time_a_unit():
    events = [(FUSED, 0.0, 8000.0), ('add', 8000.0, 500.0),
              ('chol_factor_kernel', 9000.0, 250.0), (FUSED, 20000.0, 8000.0),
              ('mul', 28000.0, 1500.0)]
    c = ctx(events, units=2)
    assert T.per_unit_ms(c, T.FUSED_FALSE) == pytest.approx(8.0)
    assert T.per_unit_ms(c, T.CHOL) == pytest.approx(0.125)
    assert T.per_unit_ms(c, exclude=T.PORT_KERNELS) == pytest.approx(1.0)
    assert T.per_unit_ms(c, T.FUSED_TRUE) is None
    assert metric('small_ops_ms.plan')(c) == pytest.approx(1.0)
    assert metric('fused_kernel_ms.plan')(c) == pytest.approx(8.0)


def test_idle_share():
    # 9.25 ms of device activity a unit against 10 ms of wall time
    events = [(FUSED, 0.0, 8000.0), ('add', 8000.0, 1000.0),
              ('copy', 8500.0, 750.0)]
    assert metric('device_idle.plan')(ctx(events)) == pytest.approx(7.5)
    assert metric('device_idle.plan')(ctx(events, wall=0.0185,
                                          units=1)) == pytest.approx(50.0)
    assert metric('device_ops.loop')(ctx(events, units=3)) == 1.0


def test_fused_roofline():
    # operations at the float32 peak take 4 ms, the bytes 1 ms: the
    # operations bound it; the kernel ran 8 ms in each of 2 units
    work = {'fused_operations': W.FP32_PEAK * 0.004,
            'fused_bytes': W.HBM_BYTES_PER_S * 0.001, 'lanes': 1}
    events = [(FUSED, 0.0, 8000.0), (FUSED, 10000.0, 8000.0)]
    c = ctx(events, units=2, work=work)
    assert metric('fused_roofline.plan')(c) == pytest.approx(25.0)
    assert metric('fused_roofline.plan')(ctx([('add', 0.0, 1.0)],
                                             work=work)) is None


@pytest.mark.parametrize('factor,solve', [
    ('factor_launches', 'solve_launches'),
    ('factor_cluster_launches', 'solve_stream_launches')])
def test_chol_roofline(factor, solve):
    # 4,096 lanes, 15 factors (86,640 B) and 29 solves (30,000 B) a step:
    # 8,886,681,600 B, 2.6527 ms at 3.35 TB/s, over 10 ms of kernels,
    # whichever of the counted kernels runs them
    events = [('chol_factor_kernel', 0.0, 6000.0),
              ('chol_solve_kernel', 6000.0, 4000.0)]
    c = ctx(events, launches={factor: 15.0, solve: 29.0},
            work={'lanes': 4096, 'kkt_n': 120})
    assert metric('chol_roofline.plan')(c) == pytest.approx(
        100 * 8_886_681_600 / 3.35e12 / 0.010)
    assert metric('chol_kernel_ms.plan')(c) == pytest.approx(10.0)


def test_frozen_work_counts():
    assert W.factor_bytes(120) == 86_640 and W.solve_bytes(120) == 30_000
    assert W.factor_bytes(288) == 498_240 and W.solve_bytes(288) == 168_768
    # 823 input floats, 120 answers and 3 statistics
    assert W.bytes_per_scenario() == 3_784
    assert W.operations(8) == 1_198_625
    assert all(W.operations(n) < W.operations(n + 1) for n in range(14))
    assert W.bound_s(3.35e12, 67e12 * 0.5) == (pytest.approx(1.0), 'bytes')


def test_top_ops_labels_counted_kernels():
    events = [(FUSED, 0.0, 8000.0), ('add', 8000.0, 100.0),
              ('add', 8200.0, 100.0)]
    top = T.top_ops(events, {'fused_riccati_warp_kernel<false>': 1.0}, 1)
    assert top[0][0].endswith('(1 a unit by counter)')
    assert top[0][1] == pytest.approx(8e-3)
    assert top[1] == ['add (2 a unit in the trace)', pytest.approx(2e-4)]
