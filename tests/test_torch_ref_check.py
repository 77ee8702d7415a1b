"""The port's host QP oracles (``hector_torch/qp/ref_check.py``) against
the JAX package's (``hector/qp/ref_check.py``).

Both packages compile ``native/qp_oracle.cpp`` with the same g++ flags, the
port into ``hector_torch/_build/`` and the JAX package under
``native/build/``, so the port's oracle answers bit for bit what JAX's does
on the same QP.  The qpOASES sources are absent here, so the 'qpoases'
backend's own solve cannot run: its swing-variable elimination and its
batch loop are held to JAX's with a stub in place of the library (the
stub solves the reduced QP with the oracle), and the backend must raise,
naming the missing sources, when they are absent.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector.config import SolverConfig
from hector.qp import pdip as JPD
from hector.qp import ref_check as JREF

from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.config import SolverConfig as TSolverConfig
from hector_torch.qp import builder as TB
from hector_torch.qp import pdip as TPD
from hector_torch.qp import ref_check as TREF

from .test_torch_dense import _jax_qp, _port_qp
from .test_torch_fused_riccati import GOLD, _closed_loop_inputs, _golden_inputs
from .test_torch_slice import JCFG, _jax_batch, _to_port, _with_solver

torch.set_num_threads(1)

# the certified optima of tests/golden/solver.npz, as tests/test_qp.py:138-148
# holds the JAX oracle to them
TOL_GOLD = 1e-6
# the port's float64 dense interior point against the oracle on fresh QPs
# (tests/test_qp.py:150-175)
TOL_FRESH = 1e-3
# a 'qpoases' plan step of the two packages: both round the (float64,
# ~1e-10 apart) solution through float32, which may land one float32 ulp
# apart (1.5e-5 at ~200 N)
TOL_QPOASES_STEP = 3e-5


def _lane(qp, k):
    return type(qp)(*[f[k] for f in qp])


def test_oracle_is_jax_oracle_bit_for_bit_and_certified():
    """On the golden QPs built by JAX, the port's oracle returns JAX's
    oracle's x bit for bit; on the port's own build of the same inputs it
    meets the certified optima within 1e-6."""
    inputs = _golden_inputs()
    qp_j = _jax_qp(inputs)
    qp_t = _port_qp(inputs)
    for k in range(3):
        x_j = JREF.solve_qpdata(jax.tree.map(lambda a: a[k], qp_j))
        x_t = TREF.solve_qpdata(_lane(
            TB.QPData(*[torch.tensor(np.asarray(f)) for f in qp_j]), k))
        np.testing.assert_array_equal(x_t, x_j)
        x_own = TREF.solve_qpdata(_lane(qp_t, k))
        assert np.abs(x_own - GOLD[f's{k}_q_soln']).max() < TOL_GOLD


def test_batched_oracle_solves_lane_by_lane():
    """A leading batch axis gives (B, 12h), one solve a lane, from tensors
    or numpy arrays alike."""
    qp = _port_qp(_closed_loop_inputs(n=3, seed=4))
    xs = TREF.solve_qpdata(qp)
    assert xs.shape == (3, 120)
    for k in range(3):
        lane = TB.QPData(*[f[k].numpy() for f in qp])
        np.testing.assert_array_equal(xs[k], TREF.solve_qpdata(lane))


@pytest.mark.parametrize('trial', range(3))
def test_pdip_vs_oracle_fresh_scenarios(trial):
    """tests/test_qp.py:150-175 on the port: QPs not in the golden set,
    the port's float64 dense interior point within 1e-3 N of the port's
    oracle, which equals JAX's oracle on the same QP bit for bit."""
    inputs = _closed_loop_inputs(n=3, seed=123)
    qp_j = jax.tree.map(lambda a: a[trial], _jax_qp(inputs))
    qp_t = _lane(_port_qp(inputs), trial)
    x_t = TREF.solve_qpdata(qp_t)
    sol = TPD.solve(qp_t, TSolverConfig(iterations=25))
    assert np.abs(sol.u.numpy() - x_t).max() < TOL_FRESH
    np.testing.assert_array_equal(
        TREF.solve_qpdata(TB.QPData(*[np.asarray(f) for f in qp_j])),
        JREF.solve_qpdata(qp_j))


def test_pdip_make_solver_matches_jax():
    """pdip.make_solver: the batched dense interior point as one callable,
    against JAX's vmapped make_solver (pdip.py:264-285) in float64 under
    the same backend name, at the dense path's bar (1e-9 N,
    tests/test_torch_dense.py)."""
    inputs = _closed_loop_inputs(n=4, seed=8)
    scfg = dict(iterations=25, backend='xla')
    u_j = jax.vmap(JPD.make_solver(SolverConfig(**scfg)))(_jax_qp(inputs)).u
    sol = TPD.make_solver(TSolverConfig(**scfg))(_port_qp(inputs))
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(u_j), atol=1e-9,
                               rtol=0)


def test_solve_dense_checks_shapes_and_failure():
    with pytest.raises(ValueError, match='shapes'):
        TREF.solve_dense(np.eye(3), np.zeros(3), np.zeros((2, 4)),
                         np.zeros(2), np.ones(2))
    # H not positive definite: the oracle's Cholesky fails (rc 2)
    with pytest.raises(RuntimeError, match='rc=2'):
        TREF.solve_dense(-np.eye(2), np.zeros(2), np.ones((1, 2)),
                         np.array([-1.0]), np.array([1.0]))


def _stub(solve_dense, calls):
    """A stand-in for qpoases_solve_dense: records the reduced problem's
    sizes and solves it with the oracle."""
    def qpoases_solve_dense(h, g, a, lb, ub, nwsr=500):
        calls.append((len(g), len(lb), nwsr))
        return solve_dense(h, g, a, lb, ub)
    return qpoases_solve_dense


def test_qpoases_elimination_matches_jax(monkeypatch):
    """solve_qpdata_qpoases removes every swing leg's 6 variables and 8
    rows as JAX's does (SolverMPC.cpp:589-697): the same reduced sizes
    reach the library, the same x comes back (bit for bit, with the
    oracle behind both stubs), and the swing variables are exactly 0."""
    calls_j, calls_t = [], []
    monkeypatch.setattr(JREF, 'qpoases_solve_dense',
                        _stub(JREF.solve_dense, calls_j))
    monkeypatch.setattr(TREF, 'qpoases_solve_dense',
                        _stub(TREF.solve_dense, calls_t))
    inputs = [np.concatenate([g, p]) for g, p in
              zip(_golden_inputs(), _closed_loop_inputs(n=4, seed=2))]
    qp_j = _jax_qp(inputs)
    qp_t = _port_qp(inputs)
    gait = inputs[5]
    for k in range(len(gait)):
        x_j = JREF.solve_qpdata_qpoases(jax.tree.map(lambda a: a[k], qp_j),
                                        gait[k])
        x_t = TREF.solve_qpdata_qpoases(
            TB.QPData(*[torch.tensor(np.asarray(f[k])) for f in qp_j]),
            torch.from_numpy(gait[k]))
        np.testing.assert_array_equal(x_t, x_j)
        stance = gait[k].sum()
        assert calls_t[-1] == calls_j[-1] == (6 * stance, 8 * stance, 500)
        swing = np.repeat(gait[k] == 0, 3, axis=1)       # (h, 6) F block
        x = x_t.reshape(-1, 12)
        assert np.all(x[:, :6][swing] == 0) and np.all(x[:, 6:][swing] == 0)
        # the port's own QP through the port's elimination: the same optimum
        x_own = TREF.solve_qpdata_qpoases(_lane(qp_t, k), gait[k])
        assert np.abs(x_own - x_j).max() < 1e-8


def test_qpoases_batch_rounds_and_zeroes_failed_lanes(monkeypatch):
    """The backend's batch loop: one host solve a lane, the solution
    rounded through float32 and cast to the problem's dtype, a failed lane
    planned as zeros (the JAX callback's rule), anything else raised."""
    monkeypatch.setattr(TREF, 'qpoases_available', lambda: True)
    failing = {1}
    count = []

    def stub(h, g, a, lb, ub, nwsr=500):
        count.append(1)
        if len(count) - 1 in failing:
            raise TREF.QPoasesFailure('returnValue=61')
        return TREF.solve_dense(h, g, a, lb, ub)

    monkeypatch.setattr(TREF, 'qpoases_solve_dense', stub)
    inputs = _closed_loop_inputs(n=3, seed=9)
    qp = _port_qp(inputs)
    gait = torch.from_numpy(inputs[5])
    sol = TREF.solve_batched_qpoases(TREF.GaitQPData(*qp, gait))
    assert sol.u.dtype == torch.float64 and sol.u.shape == (3, 120)
    assert torch.all(sol.u[1] == 0)
    for k in (0, 2):
        x = TREF.solve_qpdata_qpoases(_lane(qp, k), gait[k])
        np.testing.assert_array_equal(sol.u[k].numpy(),
                                      x.astype(np.float32).astype(np.float64))

    def broken(*args, **kw):
        raise RuntimeError('g++ failed')

    monkeypatch.setattr(TREF, 'qpoases_solve_dense', broken)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        TREF.solve_batched_qpoases(TREF.GaitQPData(*qp, gait))


def test_qpoases_plan_step_matches_jax(monkeypatch):
    """One planning step under backend='qpoases' in both packages, each
    with the oracle stub in place of qpOASES: the same wrench within one
    float32 rounding of the solution."""
    monkeypatch.setattr(JREF, 'qpoases_solve_dense',
                        _stub(JREF.solve_dense, []))
    monkeypatch.setattr(TREF, 'qpoases_solve_dense',
                        _stub(TREF.solve_dense, []))
    monkeypatch.setattr(TREF, 'qpoases_available', lambda: True)
    carry, plant, cmd = _jax_batch(3, jnp.float64, 11)
    jcfg = dataclasses.replace(JCFG, solver=SolverConfig(backend='qpoases'))
    _, w_j, m_j = jax.vmap(JRT.plan_step_fn(jcfg))(carry, plant, cmd)
    t_state = _to_port(carry, plant, cmd, torch.float64)
    _, w_t, m_t = TRT.plan_step_fn(_with_solver(TCFG, backend='qpoases'))(
        *t_state)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                               atol=TOL_QPOASES_STEP, rtol=0)
    np.testing.assert_allclose(m_t.tau.numpy(), np.asarray(m_j.tau),
                               atol=TOL_QPOASES_STEP, rtol=0)


@pytest.mark.parametrize('src_dir', [None, '/nonexistent/qpOASES'],
                         ids=['unset', 'missing'])
def test_qpoases_without_sources_raises_before_solving(monkeypatch,
                                                       src_dir):
    """Without the qpOASES sources (HECTOR_QPOASES_DIR unset, or naming no
    sources) the backend raises before it builds or solves anything: no
    silent zero-force plan (the JAX callback catches the build error and
    plans zeros, ROADMAP C)."""
    monkeypatch.setattr(TREF, 'QPOASES_REF_DIR', src_dir)
    assert not TREF.qpoases_available()
    carry, plant, cmd = _to_port(*_jax_batch(2, jnp.float64, 3),
                                 torch.float64)
    with pytest.raises(RuntimeError, match='qpOASES sources'):
        TRT.plan_step_fn(_with_solver(TCFG, backend='qpoases'))(
            carry, plant, cmd)
    with pytest.raises(RuntimeError, match='qpOASES sources'):
        TREF.solve_batched_qpoases(TREF.GaitQPData(
            *[torch.zeros(1)] * 6))
