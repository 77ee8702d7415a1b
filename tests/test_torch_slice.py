"""The port's main path against the JAX package: chained planning steps,
a short tier-1 closed loop, and the port importing without JAX.

JAX runs ``backend='riccati'`` with ``mehrotra=False``: the fixed-sigma
interior point that the fused kernel (and so the port's solver) computes.
JAX's own CPU default would pick the Mehrotra solver (mpc.py:163-164).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector.plant import srb as JSRB
from hector.config import DEFAULT_CONFIG as JCFG

from hector_torch import convert
from hector_torch import runtime as TRT
from hector_torch.plant import srb as TSRB
from hector_torch.config import DEFAULT_CONFIG as TCFG

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

JCFG_FS = dataclasses.replace(JCFG, solver=dataclasses.replace(
    JCFG.solver, backend='riccati', mehrotra=False))
REPO = Path(__file__).resolve().parent.parent


def todict(tree):
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {k: todict(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: todict(v) for k, v in tree.items()}
    return np.asarray(tree)


# XLA's jit of the swing IK differs from JAX's own eager evaluation of it
# by up to 2.5e-7 rad in float64 (acos/asin of near-unit arguments,
# measured on these inputs); the port matches eager JAX to 4e-16.  The
# joint targets therefore carry a looser float64 bar than the rest.
JIT_IK_TOL = 1e-6


def assert_tree_close(j, t, tol, path='', overrides=None):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            sub = (overrides or {}).get(k, tol)
            assert_tree_close(j[k], t[k], sub, f'{path}.{k}', overrides)
        return
    j, t = np.asarray(j), np.asarray(t)
    assert j.shape == t.shape, (path, j.shape, t.shape)
    if j.dtype == np.bool_ or np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j, err_msg=path)
    else:
        np.testing.assert_allclose(t, j, atol=tol, rtol=0, err_msg=path)


def _jax_batch(batch, dtype, seed):
    """Perturbed stance states at random gait ticks, mixed walking and
    standing commands, as JAX pytrees with a leading batch axis."""
    rng = np.random.default_rng(seed)
    p1 = JSRB.init_plant_state(JCFG, dtype=dtype)
    c1 = JRT.init_controller_carry(p1, JCFG)

    def tile(x):
        return jnp.broadcast_to(x, (batch,) + x.shape)

    plant = jax.tree.map(tile, p1)
    carry = jax.tree.map(tile, c1)
    plant = plant._replace(
        position=plant.position + rng.normal(0.0, 0.005, (batch, 3)),
        v_world=plant.v_world + rng.normal(0.0, 0.05, (batch, 3)),
        q=plant.q + rng.normal(0.0, 0.01, (batch, 2, 5)))
    plant = jax.tree.map(lambda x: jnp.asarray(x, x.dtype), plant)
    carry = carry._replace(tick=jnp.asarray(rng.integers(0, 400, batch),
                                            jnp.int32))
    cmds = [JRT.walking_command(vx=v, dtype=dtype) for v in
            rng.uniform(-0.2, 0.6, batch - batch // 4)]
    cmds += [JRT.standing_command(dtype)] * (batch // 4)
    cmd = jax.tree.map(lambda *xs: jnp.stack(xs), *cmds)
    return carry, plant, cmd


def _to_port(carry, plant, cmd, tdtype):
    return (convert.from_numpy(TRT.ControllerCarry, todict(carry), tdtype,
                               'cpu'),
            convert.from_numpy(TSRB.PlantState, todict(plant), tdtype, 'cpu'),
            convert.from_numpy(TRT.ScenarioCommand, todict(cmd), tdtype,
                               'cpu'))


# float64: the port and JAX evaluate the same float64 arithmetic; measured
# differences ~1e-13 N on ~150 N forces after three chained steps.
# float32: the bar chip_smoke.py holds the card's step to against the CPU.
@pytest.mark.parametrize('jdtype,tdtype,tol', [
    (jnp.float64, torch.float64, 1e-9),
    (jnp.float32, torch.float32, 1e-2),
], ids=['f64', 'f32'])
def test_plan_step_chain_matches_jax(jdtype, tdtype, tol):
    carry, plant, cmd = _jax_batch(8, jdtype, seed=0)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, tdtype)
    j_step = jax.jit(jax.vmap(JRT.plan_step_fn(JCFG_FS)))
    t_step = TRT.plan_step_fn(TCFG)
    for _ in range(3):
        carry, j_wrench, j_motor = j_step(carry, plant, cmd)
        t_carry, t_wrench, t_motor = t_step(t_carry, t_plant, t_cmd)
        assert float(np.abs(np.asarray(j_wrench)).max()) > 10.0
        np.testing.assert_allclose(t_wrench.numpy(), np.asarray(j_wrench),
                                   atol=tol, rtol=0)
        assert_tree_close(todict(j_motor), convert.to_numpy(t_motor), tol,
                          overrides={'q_des': max(tol, JIT_IK_TOL)})
        # chain as bench.py does: the next state depends on this solution
        plant = plant._replace(
            position=plant.position + 1e-3 * j_wrench[:, 0, :3])
        t_plant = t_plant._replace(
            position=t_plant.position + 1e-3 * t_wrench[:, 0, :3])
    if tdtype == torch.float64:
        assert_tree_close(todict(carry), convert.to_numpy(t_carry), tol)


def test_rollout_matches_jax_period_by_period():
    n_periods = 4
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=1)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float64)
    j_roll = JRT.make_rollout(n_periods, JCFG_FS, batched=True)
    carry, plant, j_diags = j_roll(carry, plant, cmd)
    t_carry, t_plant, t_diags = TRT.make_rollout(n_periods, TCFG)(
        t_carry, t_plant, t_cmd)
    t_diags = {k: v.numpy() for k, v in t_diags.items()}
    j_diags = todict(j_diags)
    assert set(t_diags) == set(j_diags)
    # the jitted IK's 2.5e-7 rad (JIT_IK_TOL) reaches the plant through the
    # joint servo (qd = dq / 0.02 s): measured over 20 ticks, qd differs by
    # 4.7e-7 rad/s, forces by 7.5e-8 N, everything else by < 3e-9
    tol, over = 1e-6, {'qd': 1e-5}
    for k in range(n_periods):
        assert_tree_close({n: v[:, k] for n, v in j_diags.items()},
                          {n: v[:, k] for n, v in t_diags.items()}, tol,
                          f'period {k}', over)
    assert_tree_close(todict(plant), convert.to_numpy(t_plant), tol, '', over)
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), tol, '', over)
    assert not t_diags['fallen'].any()


def test_rollout_quarantines_non_finite_lane():
    """A lane driven non-finite is frozen at its last finite state and
    flipped passive; the other lanes run on unaffected."""
    carry, plant, cmd = _jax_batch(3, jnp.float64, seed=2)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float64)
    roll = TRT.make_rollout(2, TCFG)
    clean_c, clean_p, _ = roll(t_carry, t_plant, t_cmd)
    bad = t_plant.v_world.clone()
    bad[1, 0] = float('inf')
    c, p, d = roll(t_carry, t_plant._replace(v_world=bad), t_cmd)
    assert d['quarantined'][1].all() and not d['quarantined'][[0, 2]].any()
    assert (c.mode[1] == 0) and torch.isfinite(p.position[1]).all()
    assert torch.equal(p.position[[0, 2]], clean_p.position[[0, 2]])


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match='item 11'):
        TRT.make_rollout(2, TCFG, with_disturbance=True)
    with pytest.raises(NotImplementedError, match='item 12'):
        TRT.make_rollout(2, TCFG, estimator='kf')
    cfg = dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, backend='riccati'))
    carry, plant, cmd = _to_port(*_jax_batch(2, jnp.float64, 3),
                                 torch.float64)
    with pytest.raises(NotImplementedError, match='item 6'):
        TRT.plan_step_fn(cfg)(carry, plant, cmd)
    cfg = dataclasses.replace(TCFG, mpc=dataclasses.replace(TCFG.mpc,
                                                            horizon=8))
    with pytest.raises(ValueError, match='horizon'):
        TRT.plan_step_fn(cfg)(carry, plant, cmd)


BLOCKED = """
import sys
for name in ('jax', 'jaxlib', 'hector'):
    sys.modules[name] = None          # any import of these now fails
sys.path.insert(0, {repo!r})
import torch
from hector_torch import runtime as RT
from hector_torch.plant import srb
from hector_torch.config import DEFAULT_CONFIG as CFG

plant = srb.init_plant_state(2, CFG, device='cpu')
carry = RT.init_controller_carry(plant, CFG)
cmd = RT.walking_command(2, vx=0.5, device='cpu')
carry, wrench, motor = RT.plan_step_fn(CFG)(carry, plant, cmd)
carry, wrench, motor = RT.plan_step_fn(CFG)(carry, plant, cmd)
assert torch.isfinite(wrench).all() and torch.isfinite(motor.tau).all()
assert not any(m == 'jax' or m.startswith(('jax.', 'hector.'))
               or m == 'hector' for m in sys.modules if sys.modules[m])
print('ok')
"""


def test_port_runs_with_jax_and_hector_blocked():
    out = subprocess.run([sys.executable, '-c', BLOCKED.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO / 'hector_torch'))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')
