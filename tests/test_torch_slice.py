"""The port's paths against the JAX package: chained planning steps, a
short tier-1 closed loop, and the port importing without JAX.

Main path: JAX runs ``backend='riccati'`` with ``mehrotra=False``, the
fixed-sigma interior point that the fused kernel computes, and the port
runs ``backend='riccati_pallas'``, the fused solver (its plain version on
CPU tensors).  The default ``'auto'`` is the Mehrotra stage solver on a CPU
on both sides (mpc.py:163-164), held to JAX in tests/test_torch_riccati.py.
Dense path: both sides run the condensed dense interior
point under the same backend name, ``'xla'`` or ``'pallas_interpret'``.
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

from hector import control as JC
from hector import gait as JG
from hector import kinematics as JK
from hector import mpc as JM
from hector import runtime as JRT
from hector.plant import srb as JSRB
from hector.config import DEFAULT_CONFIG as JCFG, JOINT_OFFSETS

from hector_torch import control as TC
from hector_torch import convert
from hector_torch import gait as TG
from hector_torch import kinematics as TK
from hector_torch import mpc as TM
from hector_torch import runtime as TRT
from hector_torch.plant import srb as TSRB
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.qp import builder as TB
from hector_torch.qp import riccati as TR

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

JCFG_FS = dataclasses.replace(JCFG, solver=dataclasses.replace(
    JCFG.solver, backend='riccati', mehrotra=False))
REPO = Path(__file__).resolve().parent.parent


def _with_solver(cfg, **kw):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **kw))


# the port's side of JCFG_FS: the fused solver by name ('auto' on CPU
# tensors is the Mehrotra stage solver)
TCFG_FS = _with_solver(TCFG, backend='riccati_pallas')


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
    t_step = TRT.plan_step_fn(TCFG_FS)
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


# The dense path in float64: both sides build the same condensed QP and run
# the same Mehrotra iteration under the same backend name; measured
# differences after three chained steps are ~1e-11 N.
@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret'])
def test_dense_plan_step_chain_matches_jax(backend):
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=4)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float64)
    j_step = jax.jit(jax.vmap(JRT.plan_step_fn(
        _with_solver(JCFG, backend=backend))))
    t_step = TRT.plan_step_fn(_with_solver(TCFG, backend=backend))
    for _ in range(3):
        carry, j_wrench, j_motor = j_step(carry, plant, cmd)
        t_carry, t_wrench, t_motor = t_step(t_carry, t_plant, t_cmd)
        assert float(np.abs(np.asarray(j_wrench)).max()) > 10.0
        np.testing.assert_allclose(t_wrench.numpy(), np.asarray(j_wrench),
                                   atol=1e-9, rtol=0)
        assert_tree_close(todict(j_motor), convert.to_numpy(t_motor), 1e-9,
                          overrides={'q_des': JIT_IK_TOL})
        plant = plant._replace(
            position=plant.position + 1e-3 * j_wrench[:, 0, :3])
        t_plant = t_plant._replace(
            position=t_plant.position + 1e-3 * t_wrench[:, 0, :3])
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), 1e-9)


def _jax_mpc_args(carry, plant, cmd):
    """The arguments controller_tick hands mpc_update, for one JAX lane."""
    est = JC.estimate_state(plant.position, plant.v_world, plant.quat,
                            plant.omega_world)
    v_des = jnp.stack([cmd.vx, cmd.vy, jnp.zeros_like(cmd.vx)])
    planner, _ = JM.integrate_position_setpoint(carry.planner, est, v_des,
                                                JCFG)
    p_foot_w = JM.foot_positions_world(est, JK.foot_position(plant.q, JCFG),
                                       JCFG)
    iteration, _ = JG.phase_state(carry.tick,
                                  JCFG.mpc.iterations_between_mpc,
                                  JRT.N_SEGMENTS)
    gait = JG.mpc_gait_table(iteration, cmd.gait_offsets, cmd.gait_durations,
                             JRT.N_SEGMENTS).astype(plant.position.dtype)
    return (planner, est, plant.q + jnp.asarray(JOINT_OFFSETS), p_foot_w,
            v_des, cmd.yaw_rate, cmd.roll, cmd.pitch, gait)


def _port_mpc_args(carry, plant, cmd):
    est = TC.estimate_state(plant.position, plant.v_world, plant.quat,
                            plant.omega_world)
    v_des = torch.stack([cmd.vx, cmd.vy, torch.zeros_like(cmd.vx)], -1)
    planner, _ = TM.integrate_position_setpoint(carry.planner, est, v_des,
                                                TCFG)
    p_foot_w = TM.foot_positions_world(est, TK.foot_position(plant.q, TCFG),
                                       TCFG)
    iteration, _ = TG.phase_state(carry.tick,
                                  TCFG.mpc.iterations_between_mpc,
                                  TRT.N_SEGMENTS)
    gait = TG.mpc_gait_table(iteration, cmd.gait_offsets, cmd.gait_durations,
                             TRT.N_SEGMENTS).to(plant.position.dtype)
    q_data = plant.q + torch.tensor(JOINT_OFFSETS, dtype=plant.q.dtype)
    return (planner, est, q_data, p_foot_w, v_des, cmd.yaw_rate, cmd.roll,
            cmd.pitch, gait)


def test_dense_mpc_update_matches_jax():
    """mpc_update itself under the dense backend: planner state, wrench and
    the whole QPSolution."""
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=5)
    t_args = _port_mpc_args(*_to_port(carry, plant, cmd, torch.float64))
    j_cfg = _with_solver(JCFG, backend='xla')
    j_state, j_wrench, j_sol = jax.vmap(
        lambda c, p, m: JM.mpc_update(*_jax_mpc_args(c, p, m), j_cfg))(
            carry, plant, cmd)
    t_state, t_wrench, t_sol = TM.mpc_update(
        *t_args, _with_solver(TCFG, backend='xla'))
    np.testing.assert_allclose(t_wrench.numpy(), np.asarray(j_wrench),
                               atol=1e-9, rtol=0)
    assert_tree_close(todict(j_state), convert.to_numpy(t_state), 1e-9)
    np.testing.assert_allclose(t_sol.u.numpy(), np.asarray(j_sol.u),
                               atol=1e-9, rtol=0)
    for name in ('mu', 'r_dual', 'r_prim'):
        np.testing.assert_allclose(getattr(t_sol, name).numpy(),
                                   np.asarray(getattr(j_sol, name)),
                                   atol=1e-12, rtol=1e-6, err_msg=name)


def test_dense_matches_fused_riccati_in_closed_loop():
    """Inside the port, the dense interior point against the fused Riccati
    solver on the same closed-loop states: the stance wrench f_ff within
    2e-3 N, the bar tests/test_riccati.py::test_mpc_update_riccati_backend_
    matches_dense holds JAX's two solvers to."""
    plant = TSRB.init_plant_state(2, TCFG, dtype=torch.float64, device='cpu')
    cmd = TRT.walking_command(2, vx=0.4, dtype=torch.float64, device='cpu')
    cfg_d = _with_solver(TCFG, backend='dense_auto')
    cfg_r = TCFG_FS
    c_d = c_r = TRT.init_controller_carry(plant, TCFG)
    for tick in range(6):
        do = tick % TCFG.mpc.mpc_cadence == 0
        c_d, motor_d, w_d, s_d, _ = TRT.controller_tick(c_d, plant, cmd, do,
                                                        cfg_d)
        c_r, _, _, _, _ = TRT.controller_tick(c_r, plant, cmd, do, cfg_r)
        assert float(c_d.planner.f_ff.abs().max()) > 10.0
        np.testing.assert_allclose(c_r.planner.f_ff.numpy(),
                                   c_d.planner.f_ff.numpy(), atol=2e-3,
                                   rtol=0)
        plant = TSRB.step(plant, motor_d, w_d, s_d, cfg=TCFG)


# what each backend name solves on CPU tensors: (builder, problem form)
FORMS = {'dense_auto': (TM.build_dense, TB.QPData),
         'pallas': (TM.build_dense, TB.QPData),
         'auto': (TM.build_stage, TR.StageQPData),
         'riccati': (TM.build_stage, TR.StageQPData),
         'riccati_pallas': (TM.build_parts, TB.StageQPParts)}


@pytest.mark.parametrize('backend', list(FORMS))
def test_solve_checks_its_problem_form(backend):
    """mpc.solve takes QPData under the dense backends, StageQPData under
    'riccati' (and 'auto' on CPU tensors) and StageQPParts under the fused
    Riccati backends, and says so when handed another form."""
    carry, plant, cmd = _to_port(*_jax_batch(2, jnp.float64, 6),
                                 torch.float64)
    args = _port_mpc_args(carry, plant, cmd)
    cfg = _with_solver(TCFG, backend=backend)
    build, form = FORMS[backend]
    _, right = build(*args, cfg)
    wrong_build = TM.build_parts if form is TB.QPData else TM.build_dense
    _, wrong = wrong_build(*args, cfg)
    assert isinstance(right, form)
    sol = TM.solve(right, cfg)
    assert sol.u.shape == (2, 120) and torch.isfinite(sol.u).all()
    with pytest.raises(TypeError, match=form.__name__):
        TM.solve(wrong, cfg)


def test_rollout_matches_jax_period_by_period():
    n_periods = 4
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=1)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float64)
    j_roll = JRT.make_rollout(n_periods, JCFG_FS, batched=True)
    carry, plant, j_diags = j_roll(carry, plant, cmd)
    t_carry, t_plant, t_diags = TRT.make_rollout(n_periods, TCFG_FS)(
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


def test_unported_paths_raise(monkeypatch):
    """Every path of the JAX package is ported; 'qpoases' without the
    qpOASES sources raises, naming them, where JAX's plans zero forces
    (tests/test_torch_ref_check.py holds the backend itself to JAX's); the
    fused backends keep their horizon guard."""
    from hector_torch.qp import ref_check
    monkeypatch.setattr(ref_check, 'QPOASES_REF_DIR', '/nonexistent/qpOASES')
    carry, plant, cmd = _to_port(*_jax_batch(2, jnp.float64, 3),
                                 torch.float64)
    with pytest.raises(RuntimeError, match='qpOASES sources'):
        TRT.plan_step_fn(_with_solver(TCFG, backend='qpoases'))(
            carry, plant, cmd)
    cfg = dataclasses.replace(TCFG_FS, mpc=dataclasses.replace(TCFG.mpc,
                                                               horizon=8))
    with pytest.raises(ValueError, match='horizon'):
        TRT.plan_step_fn(cfg)(carry, plant, cmd)


BLOCKED = """
import sys
for name in ('jax', 'jaxlib', 'hector'):
    sys.modules[name] = None          # any import of these now fails
sys.path.insert(0, {repo!r})
import dataclasses
import torch
from hector_torch import runtime as RT
from hector_torch import srbd, convert
from hector_torch.qp import builder, chol, pdip, fused_riccati, riccati
from hector_torch import estimation, prng
from hector_torch.plant import srb, whole_body
from hector_torch.config import DEFAULT_CONFIG as CFG

plant = srb.init_plant_state(2, CFG, device='cpu')
carry = RT.init_controller_carry(plant, CFG)
cmd = RT.walking_command(2, vx=0.5, device='cpu')
carry, wrench, motor = RT.plan_step_fn(CFG)(carry, plant, cmd)
carry, wrench, motor = RT.plan_step_fn(CFG)(carry, plant, cmd)
assert torch.isfinite(wrench).all() and torch.isfinite(motor.tau).all()
for kw in (dict(backend='dense_auto'), dict(backend='xla'),
           dict(backend='riccati'), dict(backend='riccati_pallas'),
           dict(polish_rounds=2)):
    cfg = dataclasses.replace(CFG, solver=dataclasses.replace(CFG.solver,
                                                              **kw))
    _, w2, _ = RT.plan_step_fn(cfg)(carry, plant, cmd)
    assert torch.isfinite(w2).all()
    assert float((w2 - wrench).abs().max()) < 1.0
# a push and a schedule: a gait switch, passive and walking again
n = 4
sched_cmd = RT.ScenarioCommand(*[f[:, None].expand((2, n) + f.shape[1:])
                                 for f in RT.standing_command(2, device='cpu')])
modes = torch.tensor([[0, -1, 1, -1], [-1, -1, -1, -1]], dtype=torch.int32)
push = torch.zeros((2, n, 6))
push[:, 1, 1] = 40.0
roll = RT.make_rollout(n, CFG, with_disturbance=True, with_schedule=True)
c2, p2, d2 = roll(RT.init_controller_carry(plant, CFG), plant, cmd, push,
                  (sched_cmd, modes))
assert d2['mode'][0].tolist() == [0, 0, 1, 1]
assert torch.isfinite(p2.position).all() and not d2['quarantined'].any()
# the sensor-honest estimator and the articulated plant
est = estimation.est_init(plant, prng.split(prng.PRNGKey(3, 'cpu'), 2), CFG)
est, e = estimation.est_update('kf', est, plant, CFG)
wb = whole_body.init_whole_body_state(0.545, 2, device='cpu')
wb = whole_body.step(wb, motor, CFG)
assert torch.isfinite(e.position).all() and torch.isfinite(wb.q).all()
# the entry points, parallel, IO and the host oracles
from hector_torch import cli, parallel, worlds
from hector_torch.io import (checkpoint, host_pipeline, html_viz, keyboard,
                             live, metrics, profiling, scenarios, trajectory,
                             viz)
from hector_torch.qp import ref_check
rec = cli.main(['--device', 'cpu', 'batch', '--batch', '2', '--seconds',
                '0.01'])
assert rec['devices'] == 1.0 and rec['fallen_count'] == 0.0
assert host_pipeline.generate_host(1, 4).shape == (4, 11)
from hector_torch import bench
bench.BATCH, bench.CHAIN_LEN, bench.REPS = 2, 1, 1
rec = cli.main(['--device', 'cpu', 'bench'])
assert list(rec) == ['metric', 'value', 'unit', 'vs_baseline']
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
