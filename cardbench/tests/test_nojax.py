"""No JAX: a CPU rehearsal of each traffic kind, in a process of its own,
leaves no top-level module named jax, jaxlib, flax or hector (compared
whole: hector_torch is not hector)."""

import json
import subprocess
import sys
from pathlib import Path

from cardbench import run as CR

ROOT = Path(__file__).resolve().parents[2]

REHEARSAL = r'''
import json, sys
import cardbench.run as CR
small = dict(batch=8, periods=4, trace_units=1)
spec = CR.cell_spec
def shrunk(w):
    b, e, c, cfg, mix = spec(w)
    return b, e, c, cfg, {k: small.get(k, v) for k, v in mix.items()}
CR.cell_spec = shrunk
kinds = {}
for w in [c['name'] for c in CR.load_json(CR.ROOT / 'BENCHMARK.json')
          ['workloads']]:
    kind = shrunk(w)[4]['kind']
    if kind not in kinds:
        kinds[kind] = CR.run(w, 2**31 + 5, 0.0, 0, device='cpu')['correct']
print(json.dumps({'kinds': kinds, 'forbidden': CR.forbidden_modules()}))
'''


def test_rehearsal_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', REHEARSAL], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec['forbidden'] == []
    assert set(rec['kinds']) == {'plan', 'loop'}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'hector_torch_fake', object())
    assert CR.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'hector.qp', object())
    assert CR.forbidden_modules() == ['hector']
