"""The cell plan-polish-32k: its three per-layer metrics on hand-built
contexts, and the cell run on the CPU through the kernel's plain version
(``'riccati_pallas'``), correct with the polish and not correct without
it."""

import importlib.util
from pathlib import Path

import pytest
import torch

from cardbench import run as CR
from cardbench.run import TraceContext
from cardbench.yardstick import workcounts as W

METRICS = Path(__file__).resolve().parents[1] / 'metrics'
TRUE = 'void (anonymous namespace)::fused_riccati_warp_kernel<true>(float)'
FALSE = 'void (anonymous namespace)::fused_riccati_warp_kernel<false>(float)'
CELL = 'plan-polish-32k'


def metric(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(events, units=1, lanes=32768):
    return TraceContext(events, [], units, 0.06, {}, {'lanes': lanes}, 1)


def test_polish_kernel_ms_reads_the_kernel_with_polish_only():
    read = metric('polish_kernel_ms.plan')
    events = [(TRUE, 0.0, 54_870.0), (FALSE, 60_000.0, 13_600.0),
              ('elementwise', 80_000.0, 100.0), (TRUE, 100_000.0, 54_870.0)]
    assert read(ctx(events, units=2)) == pytest.approx(54.87)
    assert read(ctx(events[1:3])) is None


def test_polish_roofline_is_the_hand_computed_bound():
    """14 iterations and 8 x 4 polish steps a lane at 67 TFLOP/s: 3.011 ms
    at 32,768 lanes (operation-bound: the bytes take 0.0385 ms)."""
    read = metric('polish_roofline.plan')
    ops = 32768 * W.operations(14, 32)
    assert ops / 67e12 == pytest.approx(3.011e-3, abs=5e-7)
    assert 32768 * W.bytes_per_scenario() / 3.35e12 < 4e-5
    events = [(TRUE, 0.0, 54_870.0), (TRUE, 100_000.0, 54_870.0),
              (FALSE, 200_000.0, 13_600.0)]
    got = read(ctx(events, units=2))
    assert got == pytest.approx(100.0 * ops / 67e12 / 54.87e-3, rel=1e-12)
    assert 5.4 < got < 5.6
    assert read(ctx(events[2:])) is None


def test_polish_taken_reads_the_counters(monkeypatch):
    from hector_torch.qp import fused_riccati as FR
    read = metric('polish_taken.plan')
    monkeypatch.setattr(FR, 'polish_counts', lambda: (32768 * 10, 3277))
    assert read(ctx([])) == pytest.approx(100.0 * (1 - 3277 / 327680))
    monkeypatch.setattr(FR, 'polish_counts', lambda: (0, 0))
    assert read(ctx([])) is None
    # a program without the counts (the parent of the cell) reads nothing
    monkeypatch.delattr(FR, 'polish_counts')
    assert read(ctx([])) is None


@pytest.fixture
def small(monkeypatch):
    """The cell at 64 lanes, 2 window steps checked, on the CPU under
    'riccati_pallas' (the CPU's 'auto' is the stage solver); ``polish``
    sets polish_rounds."""
    from cardbench.traffic import plan
    monkeypatch.setattr(plan, 'CHECK_STEPS', 2)
    spec = CR.cell_spec

    def shrunk(polish_rounds):
        def cell_spec(w):
            b, e, c, cfg, mix = spec(w)
            solver = dict(cfg['solver'], backend='riccati_pallas',
                          polish_rounds=polish_rounds)
            return b, e, c, dict(cfg, solver=solver), dict(
                mix, batch=64, trace_units=1)
        monkeypatch.setattr(CR, 'cell_spec', cell_spec)
    return shrunk


def run():
    torch.set_num_threads(1)
    return CR.run(CELL, 2**31 + 99, 0.0, 0, device='cpu')


def test_cell_with_polish_is_correct(small):
    small(8)
    r = run()
    assert r['correct'], r['checks']
    assert r['failed'] == 0 and r['attempted'] > 0


def test_cell_with_polish_off_is_not_correct(small):
    small(0)
    r = run()
    assert not r['correct'], r['checks']
