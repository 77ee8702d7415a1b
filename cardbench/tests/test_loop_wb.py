"""The articulated loop's cell, ``loop-wb-1k`` (traffic kind ``loop_wb``):
found by name; on the CPU at a tiny size, correct when unbroken and not
correct for each fault a one-card cell can have (a plant step that
returns its state unchanged, half of the batch left out, the solver's
answer altered by 5 %); a rehearsal in a process of its own loads no
JAX; and the reference of its plant (reference/whole_body.py) imports
nothing of the program or of JAX."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cardbench import run as CR

ROOT = Path(__file__).resolve().parents[2]
CELL = 'loop-wb-1k'
SMALL = dict(batch=12, periods=4, trace_units=1)


@pytest.fixture
def small(monkeypatch):
    from cardbench.traffic import loop
    monkeypatch.setattr(loop, 'CHECK_BATCHES', 1)
    spec = CR.cell_spec

    def shrunk(w):
        b, e, c, cfg, mix = spec(w)
        return b, e, c, cfg, {k: SMALL.get(k, v) for k, v in mix.items()}
    monkeypatch.setattr(CR, 'cell_spec', shrunk)


def run():
    return CR.run(CELL, 2**31 + 77, 0.0, 0, device='cpu')


def _first_half(new, old):
    if isinstance(new, tuple):
        return type(new)(*[_first_half(a, b) for a, b in zip(new, old)])
    n = new.shape[0] // 2
    return torch.cat([new[:n], old[n:]])


def unchanged_state(monkeypatch):
    from hector_torch.plant import whole_body as WB
    monkeypatch.setattr(WB, 'step', lambda state, *a, **k: state)


def half_batch(monkeypatch):
    from hector_torch.plant import whole_body as WB
    step = WB.step
    monkeypatch.setattr(WB, 'step', lambda state, *a, **k:
                        _first_half(step(state, *a, **k), state))


def altered_answer(monkeypatch):
    from hector_torch import mpc as M
    solve = M.solve

    def altered(problem, cfg=None):
        sol = solve(problem, cfg)
        return sol._replace(u=sol.u * 1.05)
    monkeypatch.setattr(M, 'solve', altered)


FAULTS = {'unchanged_state': unchanged_state, 'half_batch': half_batch,
          'altered_answer': altered_answer}


def test_cell_is_found_by_name():
    bench, entry, spec, config, mix = CR.cell_spec(CELL)
    assert (entry['config'], entry['traffic'], entry['chips']) == (
        'hector-h10-wb', 'loop-wb-1k-push', 1)
    assert mix['kind'] == 'loop_wb'
    kind = importlib.import_module('cardbench.traffic.loop_wb')
    e2e, layer = CR.cell_metrics(bench, CELL, kind.END_TO_END)
    assert {m['name'] for m in e2e} == {'loop_lane_s_per_s', 'setup_s'}
    names = {m['name'] for m in layer}
    assert {'plant_ms.wb', 'plant_ops.wb', 'wb_dynamics_ms.wb',
            'wb_contact_ms.wb', 'wb_solve_ms.wb', 'wb_solve_failed.wb',
            'plant_roofline.wb', 'tick_ms.loop', 'fused_kernel_ms.loop',
            'device_ops.loop', 'graph_launch_ms.loop',
            'graph_capture_s'} == names
    loop_mix = json.loads((ROOT / 'cardbench' / 'traffic'
                           / 'loop-1k-push.json').read_text())
    assert {k: v for k, v in mix.items() if k != 'kind'} == {
        k: v for k, v in loop_mix.items() if k != 'kind'}


def test_unbroken_run_is_correct(small):
    r = run()
    assert r['correct'], r['checks']
    assert r['failed'] == 0 and r['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(small, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = run()
    assert not r['correct'], r['checks']


REHEARSAL = r'''
import json
import cardbench.run as CR
from cardbench.traffic import loop
loop.CHECK_BATCHES = 1
spec = CR.cell_spec
def shrunk(w):
    b, e, c, cfg, mix = spec(w)
    return b, e, c, cfg, dict(mix, batch=4, periods=4, trace_units=1)
CR.cell_spec = shrunk
ok = CR.run('loop-wb-1k', 2**31 + 5, 0.0, 0, device='cpu')['correct']
print(json.dumps({'correct': ok, 'forbidden': CR.forbidden_modules()}))
'''


def test_rehearsal_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', REHEARSAL], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {'correct': True, 'forbidden': []}


def test_reference_loads_nothing_of_the_program():
    code = ('import sys, cardbench.reference.whole_body; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"hector", "hector_torch", "jax", "jaxlib", "flax"}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == '[]'
