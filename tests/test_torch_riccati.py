"""The port's stage-wise Riccati interior point and its builder against the
JAX package, and the fused solver's entry on the full stage form.

``hector_torch.qp.riccati`` is ``hector.qp.riccati`` in batched PyTorch ops
(no kernel: the JAX module runs in XLA).  Both sides get the same seeded
numpy inputs on the CPU: the three certified problems of
tests/golden/solver.npz and perturbed copies of them.  The port's default
``backend='auto'`` on CPU tensors is this solver, as the reference's is on a
CPU backend (hector/mpc.py:160-164).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector.config import (DEFAULT_CONFIG as JCFG, MPCConfig,
                           SolverConfig)
from hector.qp.builder import build_stage_qp
from hector.qp import riccati

from hector_torch import convert, graph
from hector_torch import runtime as TRT
from hector_torch.config import (DEFAULT_CONFIG as TCFG,
                                 MPCConfig as TMPCConfig,
                                 SolverConfig as TSolverConfig)
from hector_torch.qp import builder as tbuild
from hector_torch.qp import fused_riccati as FR
from hector_torch.qp import pdip as tpdip
from hector_torch.qp import riccati as TR

from .test_torch_fused_riccati import (GOLD, I_BODY, Q_DIAG, R_DIAG,
                                       _both_cases, _golden_inputs)
from .test_torch_slice import _jax_batch, _to_port, _with_solver, todict

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

CFG = MPCConfig()
# float64 module math: the same arithmetic in another order (~1e-16)
TOL_BUILD = 1e-10
# float64 solves: the same interior point on both sides, which differ only
# in rounding order (measured ~1e-12 N on ~200 N forces)
TOL_F64 = 1e-9
# float32: the JAX package's parity contract for the forces
TOL_F32 = 1e-3


def _cfgs(h):
    if h == CFG.horizon:
        return CFG, TMPCConfig()
    return (dataclasses.replace(CFG, horizon=h),
            dataclasses.replace(TMPCConfig(), horizon=h))


def _cut(inputs, h):
    """The inputs at horizon h: the first h rows of traj and gait."""
    x0, traj, r_body, r_foot, r_feet, gait = inputs
    return x0, traj[:, :h], r_body, r_foot, r_feet, gait[:, :h]


def _jax_sqp(inputs, dtype, h=10):
    jcfg = _cfgs(h)[0]
    x0, traj, r_body, r_foot, r_feet, gait = [jnp.asarray(a, dtype)
                                              for a in _cut(inputs, h)]
    return jax.vmap(lambda *a: build_stage_qp(
        *a[:5], jnp.asarray(I_BODY, dtype), a[5], jcfg))(
            x0, traj, r_body, r_foot, r_feet, gait)


def _port_sqp(inputs, dtype, h=10):
    tcfg = _cfgs(h)[1]
    t = [torch.tensor(np.asarray(a), dtype=dtype) for a in _cut(inputs, h)]
    return tbuild.build_stage_qp(*t[:5], torch.tensor(I_BODY, dtype=dtype),
                                 t[5], tcfg)


def _jax_solve(sqp, scfg):
    return jax.jit(riccati.solve_batched, static_argnums=1)(sqp, scfg)


def _tcfg(**kw):
    return dataclasses.replace(TSolverConfig(), **kw)


def _assert_solution_close(sol_t, sol_j, tol):
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=tol, rtol=0)
    for name in ('mu', 'r_dual', 'r_prim'):
        np.testing.assert_allclose(getattr(sol_t, name).numpy(),
                                   np.asarray(getattr(sol_j, name)),
                                   atol=tol, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize('h', [10, 8])
def test_build_stage_qp_matches_jax(h):
    inputs = _both_cases()
    sqp_j = _jax_sqp(inputs, jnp.float64, h)
    sqp_t = _port_sqp(inputs, torch.float64, h)
    assert isinstance(sqp_t, TR.StageQPData)
    for name, a, b in zip(TR.StageQPData._fields, sqp_j, sqp_t):
        assert b.shape == a.shape, (name, b.shape, a.shape)
        assert b.dtype == torch.float64, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL_BUILD,
                                   rtol=0, err_msg=name)
    # the compact build is the stage form's slices
    parts = tbuild.build_stage_parts(
        *[torch.tensor(np.asarray(a)) for a in _cut(inputs, h)[:5]],
        torch.tensor(I_BODY), torch.tensor(_cut(inputs, h)[5]),
        _cfgs(h)[1])
    for name, a in zip(parts._fields, FR.stage_parts(sqp_t)):
        np.testing.assert_allclose(getattr(parts, name).numpy(), a.numpy(),
                                   atol=1e-15, rtol=0, err_msg=name)


@pytest.mark.parametrize('polish_rounds', [0, 8], ids=['ip', 'polish'])
@pytest.mark.parametrize('mehrotra', [True, False],
                         ids=['mehrotra', 'fixed_sigma'])
def test_solve_batched_matches_jax_f64(mehrotra, polish_rounds):
    inputs = _both_cases()
    scfg = SolverConfig(mehrotra=mehrotra, polish_rounds=polish_rounds)
    sol_j = _jax_solve(_jax_sqp(inputs, jnp.float64), scfg)
    sol_t = TR.solve_batched(_port_sqp(inputs, torch.float64),
                             _tcfg(mehrotra=mehrotra,
                                   polish_rounds=polish_rounds))
    assert float(sol_t.u.abs().max()) > 10.0
    _assert_solution_close(sol_t, sol_j, TOL_F64)


def test_solve_batched_matches_jax_f32():
    inputs = _both_cases()
    sol_j = _jax_solve(_jax_sqp(inputs, jnp.float32), SolverConfig())
    sol_t = TR.solve_batched(_port_sqp(inputs, torch.float32), _tcfg())
    assert sol_t.u.dtype == torch.float32
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=TOL_F32, rtol=0)


def test_solve_at_horizon_8_matches_jax():
    """Another horizon is reached through build_stage_qp with a gait table
    of h rows, as tests/test_riccati.py does."""
    inputs = _both_cases()
    sol_j = _jax_solve(_jax_sqp(inputs, jnp.float64, 8), SolverConfig())
    sol_t = TR.solve_batched(_port_sqp(inputs, torch.float64, 8), _tcfg())
    assert sol_t.u.shape == (len(inputs[0]), 96)
    _assert_solution_close(sol_t, sol_j, TOL_F64)


def test_meets_the_certified_optima_and_the_dense_solver():
    """tests/test_riccati.py's bars: 1e-3 N from the certified optima,
    1e-8 N from the port's dense interior point in float64 (Mehrotra, 25
    iterations), the fixed-sigma path (30) to the optima too, and float32
    (12 iterations) within 6e-3 N of them."""
    inputs = _golden_inputs()
    sqp = _port_sqp(inputs, torch.float64)
    scfg = _tcfg(iterations=25)
    sol = TR.solve_batched(sqp, scfg)
    t = [torch.tensor(np.asarray(a)) for a in inputs]
    qp = tbuild.build_qp(*t[:5], torch.tensor(I_BODY), t[5], TMPCConfig())
    sol_d = tpdip.solve_batched(qp, dataclasses.replace(scfg, backend='xla'))
    sol_fs = TR.solve_batched(sqp, _tcfg(iterations=30, mehrotra=False))
    sol_32 = TR.solve_batched(_port_sqp(inputs, torch.float32),
                              _tcfg(iterations=12))
    for k in range(3):
        gold = GOLD[f's{k}_q_soln']
        assert np.abs(sol.u[k].numpy() - gold).max() < 1e-3
        assert np.abs(sol_fs.u[k].numpy() - gold).max() < 1e-3
        assert np.abs(sol_32.u[k].double().numpy() - gold).max() < 6e-3
    np.testing.assert_allclose(sol.u.numpy(), sol_d.u.numpy(), atol=1e-8,
                               rtol=0)
    assert float(sol.mu.max()) < 1e-10 and float(sol_fs.mu.max()) < 1e-10
    assert float(sol.r_dual.max()) < 1e-6


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_indefinite_lane_is_skipped_alone(dtype):
    """A lane whose Riccati matrix is indefinite (negative input weights)
    gets NaN factors, as jnp.linalg.cholesky gives them: the solve does not
    raise, that lane keeps its start u = 0, and every other lane is bit for
    bit what it is without it."""
    sqp = _port_sqp(_both_cases(), dtype)
    bad = 2
    r_bad = sqp.r_diag.clone()
    r_bad[bad] = -1e3
    scfg = _tcfg()
    ok = TR.solve_batched(sqp, scfg)
    sol = TR.solve_batched(sqp._replace(r_diag=r_bad), scfg)
    others = torch.arange(sqp.x0.shape[0]) != bad
    assert torch.equal(sol.u[bad], torch.zeros_like(sol.u[bad]))
    assert torch.isfinite(sol.u).all()
    for name in sol._fields:
        assert torch.equal(getattr(sol, name)[others],
                           getattr(ok, name)[others]), name


def test_single_problem_and_make_solver():
    sqp = _port_sqp(_golden_inputs(), torch.float64)
    scfg = _tcfg(iterations=20)
    batched = TR.make_solver(scfg)(sqp)
    for k in range(3):
        one = TR.solve(TR.StageQPData(*[x[k] for x in sqp]), scfg)
        assert one.u.shape == (120,) and one.mu.shape == ()
        np.testing.assert_allclose(one.u.numpy(), batched.u[k].numpy(),
                                   atol=1e-12, rtol=0)


# ------------------------------------------------ the compiled entry point

def _bit_equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize('h', [10, 8])
def test_make_solver_is_solve_batched_bit_for_bit(h):
    """riccati.make_solver on CPU tensors: the runner runs the solve
    eagerly on its buffers, bit for bit solve_batched, twice over on the
    same buffers (one capture entry for the QPs' shapes, dtype and device),
    and what it returns aliases none of them."""
    scfg = _tcfg(iterations=3)
    sqp = _port_sqp(_both_cases(), torch.float32, h)
    sqp2 = sqp._replace(xd=sqp.xd + 0.01)
    solver = TR.make_solver(scfg)
    first = solver(sqp)
    held = graph.tree_map(torch.clone, first)
    assert type(first) is type(TR.solve_batched(sqp, scfg))
    assert first.u.shape == (sqp.x0.shape[0], 12 * h)
    assert _bit_equal(first, TR.solve_batched(sqp, scfg))
    assert _bit_equal(solver(sqp2), TR.solve_batched(sqp2, scfg))
    assert len(solver.steps.captures) == 1
    assert _bit_equal(first, held)
    (cap,) = solver.steps.captures.values()
    buffers = {t.untyped_storage().data_ptr()
               for t in graph.leaves((cap.inputs, cap.outs))}
    assert not buffers & {t.untyped_storage().data_ptr()
                          for t in graph.leaves(first)}


def test_make_solver_inside_a_capture_is_solve_batched(monkeypatch):
    """While a CUDA stream records (a step that holds this solve being
    captured), the solver is solve_batched itself and touches no runner:
    captures do not nest.  Here the recording is simulated."""
    scfg = _tcfg(iterations=3)
    sqp = _port_sqp(_both_cases(), torch.float32)
    solver = TR.make_solver(scfg)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    assert _bit_equal(solver(sqp), TR.solve_batched(sqp, scfg))
    assert not solver.steps.captures


@pytest.mark.parametrize('polish_rounds', [0, 8], ids=['ip', 'polish'])
def test_solve_batched_waits_on_nothing(monkeypatch, polish_rounds):
    """The CPU's proxy for a solve that never waits on the card: with
    torch.cholesky_solve (which reads a status on the host) made to raise,
    the solve runs, with and without the polish."""
    def refuse(*args, **kw):
        raise AssertionError('torch.cholesky_solve called')

    sqp = _port_sqp(_both_cases(), torch.float64)
    scfg = _tcfg(polish_rounds=polish_rounds)
    monkeypatch.setattr(torch, 'cholesky_solve', refuse)
    sol = TR.solve_batched(sqp, scfg)
    assert float(sol.u.abs().max()) > 10.0
    assert torch.isfinite(sol.u).all()


def test_fused_solver_on_stage_data():
    """fused_riccati.solve_batched on StageQPData (CPU tensors: the plain
    version) against JAX's fixed-sigma stage solver, which the fused kernel
    mirrors; bit for bit solve_parts_plain on the stage form's slices; the
    weights read from the tensors when not given; no launch counted."""
    inputs = _both_cases()
    sqp = _port_sqp(inputs, torch.float64)
    scfg = _tcfg()
    before = (FR.launches, FR.polish_launches)
    sol = FR.solve_batched(sqp, scfg)
    assert (FR.launches, FR.polish_launches) == before
    sol_j = _jax_solve(_jax_sqp(inputs, jnp.float64),
                       SolverConfig(mehrotra=False))
    _assert_solution_close(sol, sol_j, TOL_F64)
    ref = FR.solve_parts_plain(FR.stage_parts(sqp), scfg, Q_DIAG, R_DIAG)
    given = FR.make_solver(scfg, Q_DIAG, R_DIAG)(sqp)
    for name in sol._fields:
        assert torch.equal(getattr(sol, name), getattr(ref, name)), name
        assert torch.equal(getattr(given, name), getattr(ref, name)), name
    parts = _port_parts_compact(inputs)
    np.testing.assert_allclose(
        sol.u.numpy(),
        FR.solve_parts_plain(parts, scfg, Q_DIAG, R_DIAG).u.numpy(),
        atol=TOL_F64, rtol=0)


def _port_parts_compact(inputs):
    t = [torch.tensor(np.asarray(a)) for a in inputs]
    return tbuild.build_stage_parts(*t[:5], torch.tensor(I_BODY), t[5],
                                    TMPCConfig())


@pytest.mark.parametrize('polish_rounds', [0, 8], ids=['ip', 'polish'])
def test_fused_solver_with_polish_on_stage_data(polish_rounds):
    """In float32, with and without the polish, the fused entry is the
    plain version on the slices, with the weights as the float32 tensors
    hold them (JAX concretizes them from the arrays likewise)."""
    sqp = _port_sqp(_golden_inputs(), torch.float32)
    scfg = _tcfg(polish_rounds=polish_rounds)
    sol = FR.solve_batched(sqp, scfg)
    ref = FR.solve_parts_plain(FR.stage_parts(sqp), scfg,
                               tuple(sqp.q_diag[-1].tolist()),
                               tuple(sqp.r_diag[-1].tolist()))
    for name in sol._fields:
        assert torch.equal(getattr(sol, name), getattr(ref, name)), name


def test_plan_step_default_config_matches_jax_default():
    """C.2: the port's default config on CPU tensors runs the Mehrotra stage
    solver ('auto' -> 'riccati'), as JAX's default config does on its CPU
    backend; three chained planning steps agree to 1e-9 N in float64, and
    'auto' on CPU tensors is 'riccati' bit for bit."""
    carry, plant, cmd = _jax_batch(8, jnp.float64, seed=11)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, torch.float64)
    j_step = jax.jit(jax.vmap(JRT.plan_step_fn(JCFG)))
    t_step = TRT.plan_step_fn(TCFG)
    t_riccati = TRT.plan_step_fn(_with_solver(TCFG, backend='riccati'))
    for _ in range(3):
        carry, j_wrench, _ = j_step(carry, plant, cmd)
        r_carry, r_wrench, r_motor = t_riccati(t_carry, t_plant, t_cmd)
        t_carry, t_wrench, t_motor = t_step(t_carry, t_plant, t_cmd)
        assert float(np.abs(np.asarray(j_wrench)).max()) > 10.0
        np.testing.assert_allclose(t_wrench.numpy(), np.asarray(j_wrench),
                                   atol=TOL_F64, rtol=0)
        assert torch.equal(t_wrench, r_wrench)
        assert torch.equal(t_motor.tau, r_motor.tau)
        assert torch.equal(t_carry.planner.f_ff, r_carry.planner.f_ff)
        plant = plant._replace(
            position=plant.position + 1e-3 * j_wrench[:, 0, :3])
        t_plant = t_plant._replace(
            position=t_plant.position + 1e-3 * t_wrench[:, 0, :3])
    np.testing.assert_allclose(convert.to_numpy(t_carry.planner.f_ff),
                               todict(carry)['planner']['f_ff'],
                               atol=TOL_F64, rtol=0)


def test_plan_step_at_another_horizon_raises_as_in_jax():
    """The reference's plan step fails at a horizon other than the gait
    table's 10 rows under 'riccati' (a broadcast of (10, 13) against
    (8, 13)); the port keeps that: it raises too."""
    carry, plant, cmd = _to_port(*_jax_batch(2, jnp.float64, 12),
                                 torch.float64)
    cfg = _with_solver(TCFG, backend='riccati')
    cfg = dataclasses.replace(cfg, mpc=dataclasses.replace(TCFG.mpc,
                                                           horizon=8))
    with pytest.raises(RuntimeError, match='size of tensor'):
        TRT.plan_step_fn(cfg)(carry, plant, cmd)
