"""The port's headline benchmark (``hector_torch/bench.py``, ``python -m
hector_torch bench``) against the top-level ``bench.py`` that ``python -m
hector bench`` runs.

The chain runs at a small batch in float64 on the CPU, where both
packages' default ``'auto'`` is the Mehrotra stage solver.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector.config import DEFAULT_CONFIG as JCFG
from hector.plant import srb as JSRB

from hector_torch import bench
from hector_torch import cli as TCLI
from hector_torch import prng
from hector_torch import runtime as TRT

torch.set_num_threads(1)
CPU = torch.device('cpu')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float64 chained steps: the same interior point on both sides, apart only
# in rounding order (tests/test_torch_riccati.py holds three chained steps
# to this, in N)
TOL_F64 = 1e-9
# the record's keys in bench.py's order (bench.py:104-109)
KEYS = ['metric', 'value', 'unit', 'vs_baseline']


def _jax_chain(key, batch, chain_len):
    """bench.py:65-88 at ``batch`` lanes and ``chain_len`` steps in
    float64, also returning the final position and f_ff."""
    plant = JSRB.init_plant_state(JCFG, dtype=jnp.float64)
    carry = JRT.init_controller_carry(plant, JCFG)
    cmd = JRT.walking_command(vx=0.5, dtype=jnp.float64)
    tile = lambda x: jnp.broadcast_to(x, (batch,) + x.shape)
    plant, carry, cmd = (jax.tree.map(tile, t) for t in (plant, carry, cmd))
    plan = JRT.plan_step_fn(JCFG)

    @jax.jit
    def chained_steps(key, carry, plant, cmd):
        noise = 1e-6 * jax.random.uniform(key, plant.position.shape,
                                          plant.position.dtype)
        plant = plant._replace(position=plant.position + noise)

        def body(state, _):
            c, p = state
            c, wrench, _motor = jax.vmap(plan)(c, p, cmd)
            p = p._replace(position=p.position + 1e-9 * wrench[:, 0, :3])
            return (c, p), None

        (c, p), _ = jax.lax.scan(body, (carry, plant), None,
                                 length=chain_len)
        return (jnp.sum(p.position) + jnp.sum(c.planner.f_ff), p.position,
                c.planner.f_ff)

    return [np.asarray(x) for x in chained_steps(key, carry, plant, cmd)]


@pytest.mark.parametrize('seed', [0, 99])
def test_chained_steps_match_jax(seed):
    """Three chained steps at 8 lanes from the same key: the scalar the
    benchmark fetches, the final position and the final feed-forward
    forces within 1e-9 of JAX's chain."""
    batch, chain_len = 8, 3
    want, position, f_ff = _jax_chain(jax.random.PRNGKey(seed), batch,
                                      chain_len)
    carry, plant, cmd = bench.initial_state(batch, torch.float64, CPU)
    got, carry, plant = bench.chained_steps(
        TRT.plan_step_fn(), prng.PRNGKey(seed, CPU), carry, plant, cmd,
        chain_len)
    assert got.dim() == 0 and got.dtype == torch.float64
    assert float(np.abs(f_ff).max()) > 10.0
    assert abs(float(got) - float(want)) <= TOL_F64
    np.testing.assert_allclose(plant.position.numpy(), position,
                               atol=TOL_F64, rtol=0)
    np.testing.assert_allclose(carry.planner.f_ff.numpy(), f_ff,
                               atol=TOL_F64, rtol=0)


def test_record_has_the_reference_keys_and_ignores_batch(monkeypatch):
    """`--device cpu bench` prints one JSON line with bench.py's keys in its
    order; --batch changes nothing: the module's BATCH, CHAIN_LEN and REPS
    run (shrunk here)."""
    monkeypatch.setattr(bench, 'BATCH', 4)
    monkeypatch.setattr(bench, 'CHAIN_LEN', 2)
    monkeypatch.setattr(bench, 'REPS', 3)
    calls = []
    run = bench.run

    def spy(*args):
        calls.append(args)
        return run(*args)

    monkeypatch.setattr(bench, 'run', spy)
    for extra in ([], ['--batch', '12345']):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec = TCLI.main(['--device', 'cpu', 'bench'] + extra)
        lines = buf.getvalue().splitlines()
        assert len(lines) == 1
        printed = json.loads(lines[0])
        assert printed == rec and list(printed) == KEYS
        assert printed['metric'] == 'batched_mpc_solves_per_s_per_chip'
        assert printed['unit'] == 'solves/s/chip'
        assert math.isfinite(printed['value']) and printed['value'] > 0
        assert printed['vs_baseline'] == pytest.approx(
            printed['value'] / 6250.0, abs=1e-3)
    assert calls == [(4, 2, 3, CPU)] * 2


def test_bench_without_a_card_exits_2():
    """No silent CPU run: without a card and without --device cpu, bench
    exits 2 naming the fix and prints no record."""
    proc = subprocess.run(
        [sys.executable, '-m', 'hector_torch', 'bench', '--batch', '8'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert 'no CUDA device' in proc.stderr and '--device' in proc.stderr
    assert proc.stdout == ''
