"""The condensed dense path of the port against the JAX package: dynamics
and condensing, the dense QP build, the plain versions of the two Cholesky
kernels, the dense interior point, and the wrappers' contract.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
to these plain versions there).  Here the plain versions, which the wrappers
use for CPU tensors and which ``backend='pallas_interpret'`` names, are held
to the Pallas TPU kernels run in interpret mode, as the JAX package's own
tests run them on a CPU (tests/test_qp.py).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import runtime as JRT
from hector import srbd as jsrbd
from hector.config import SolverConfig
from hector.qp import pallas_chol as PC
from hector.qp import pdip as jpdip
from hector.qp.builder import build_qp as jbuild_qp

from hector_torch import _native, convert, cuda, graph
from hector_torch import runtime as TRT
from hector_torch import srbd as tsrbd
from hector_torch.qp import builder as tbuild
from hector_torch.qp import chol
from hector_torch.qp import pdip as tpdip

from .test_torch_fused_riccati import (
    CFG, GOLD, I_BODY, _closed_loop_inputs, _golden_inputs, _tcfg)
from .test_torch_slice import (
    JCFG, JIT_IK_TOL, TCFG, _jax_batch, _to_port, _with_solver,
    assert_tree_close, todict)

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

# module math in float64: both sides evaluate the same closed-form
# arithmetic; only summation order differs (measured ~4e-14 on H ~ 1e2)
TOL_MATH = 1e-10
# the dense interior point in float64: same iteration, same linear algebra
# up to rounding order (measured ~1e-11 N on ~200 N forces)
TOL_SOLVE = 1e-9
F64 = torch.float64


def tt(x, dtype=F64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _cases():
    """The three golden problems and eight perturbed closed-loop copies."""
    return [np.concatenate([g, p]) for g, p in zip(_golden_inputs(),
                                                     _closed_loop_inputs())]


def _jax_qp(inputs, dtype=jnp.float64):
    qps = [jbuild_qp(*[jnp.asarray(a[k], dtype) for a in inputs[:5]],
                     jnp.asarray(I_BODY, dtype),
                     jnp.asarray(inputs[5][k], dtype), CFG)
           for k in range(len(inputs[0]))]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qps)


def _port_qp(inputs, dtype=F64):
    t = [tt(a, dtype) for a in inputs]
    return tbuild.build_qp(*t[:5], tt(I_BODY, dtype), t[5], CFG)


# ------------------------------------------------------- dynamics and build

def test_srbd_matches_jax():
    rng = np.random.default_rng(0)
    n = 8
    i_world = rng.normal(size=(n, 3, 3)) * 0.05
    i_world = i_world @ i_world.transpose(0, 2, 1) + np.diag([0.5, 0.5, 0.07])
    r_feet = rng.normal(size=(n, 2, 3)) * 0.2
    erate = rng.normal(size=(n, 3, 3))
    a_j, b_j = jax.vmap(lambda i, r, e: jsrbd.ct_dynamics(
        i, jnp.asarray(CFG.mass), r, e))(*map(jnp.asarray,
                                              (i_world, r_feet, erate)))
    a_t, b_t = tsrbd.ct_dynamics(tt(i_world), tt(CFG.mass), tt(r_feet),
                                 tt(erate))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=TOL_MATH)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=TOL_MATH)
    aq_j, bq_j = jax.vmap(lambda a, b: jsrbd.condense(
        a, b, jnp.asarray(CFG.dt_mpc), CFG.horizon))(a_j, b_j)
    aq_t, bq_t = tsrbd.condense(a_t, b_t, tt(CFG.dt_mpc), CFG.horizon)
    assert aq_t.shape == (n, 130, 13) and bq_t.shape == (n, 130, 120)
    np.testing.assert_allclose(aq_t.numpy(), np.asarray(aq_j), atol=TOL_MATH)
    np.testing.assert_allclose(bq_t.numpy(), np.asarray(bq_j), atol=TOL_MATH)


def test_build_qp_matches_jax():
    inputs = _cases()
    qp_j, qp_t = _jax_qp(inputs), _port_qp(inputs)
    assert type(qp_t) is tbuild.QPData and qp_t._fields == qp_j._fields
    for name, j, t in zip(qp_j._fields, qp_j, qp_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL_MATH,
                                   rtol=0, err_msg=name)


def test_build_qp_matches_reference_matrices():
    """Against the golden transcription of solve_mpc's matrices, the bar of
    tests/test_qp.py::test_builder_matches_reference_matrices."""
    qp = _port_qp(_golden_inputs())
    for k in range(3):
        keep = GOLD[f's{k}_keep_v']
        ix = np.ix_(keep, keep)
        np.testing.assert_allclose(qp.h_mat[k].numpy()[ix],
                                   GOLD[f's{k}_qH'][ix], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(qp.g_vec[k].numpy()[keep],
                                   GOLD[f's{k}_qg'][keep], rtol=1e-9,
                                   atol=1e-8)


def test_qpdata_crosses_through_convert():
    qp_j = _jax_qp(_golden_inputs())
    arrays = {k: np.asarray(v) for k, v in zip(qp_j._fields, qp_j)}
    qp_t = convert.from_numpy(tbuild.QPData, arrays, F64, 'cpu')
    assert type(qp_t) is tbuild.QPData
    back = convert.to_numpy(qp_t)
    for name in qp_j._fields:
        assert qp_t._asdict()[name].dtype == F64
        np.testing.assert_array_equal(back[name], arrays[name])
    with pytest.raises(KeyError, match='g_vec'):
        convert.from_numpy(tbuild.QPData, {k: v for k, v in arrays.items()
                                           if k != 'g_vec'}, F64, 'cpu')


# ------------------------------------------- plain versions of the kernels

def _spd(n, bsz, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, n, n))
    m = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    return np.ascontiguousarray(m.transpose(1, 2, 0)), rng.normal(size=(n, bsz))


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


# float32, relative 1e-5: both sides run the same column-by-column
# algorithm; they differ in rsqrt against 1/sqrt and in that the TPU kernel
# reads the pivot row from the upper triangle (measured ~3e-7)
@pytest.mark.parametrize('n,bsz', [(24, 5), (24, 130), (40, 5), (40, 130)])
def test_plain_cholesky_matches_pallas_interpret(n, bsz):
    m, rhs = _spd(n, bsz, seed=n + bsz)
    m32, rhs32 = m.astype(np.float32), rhs.astype(np.float32)
    l_j = np.asarray(PC.cholesky_nnb(jnp.asarray(m32), interpret=True))
    x_j = np.asarray(PC.cholesky_solve_nnb(jnp.asarray(l_j),
                                           jnp.asarray(rhs32),
                                           interpret=True))
    l_t = chol.cholesky_nnb_plain(tt(m32, torch.float32))
    x_t = chol.cholesky_solve_nnb_plain(l_t, tt(rhs32, torch.float32))
    assert l_t.dtype == torch.float32 and l_t.shape == (n, n, bsz)
    low = np.tril_indices(n)
    assert _rel(l_t.numpy()[low], l_j[low]) < 1e-5
    assert _rel(x_t.numpy(), x_j) < 1e-5
    # the contract of cholesky_nnb: zeros above the diagonal
    assert not l_t.numpy()[np.triu_indices(n, 1)].any()


def test_plain_cholesky_matches_pallas_interpret_on_kkt_matrices():
    """Once at the path's n = 120: the KKT matrices H + reg I of the three
    golden problems.  These are ill-conditioned, so x is compared on one L
    (the TPU kernel's): two factors that agree to 1e-5 give solutions that
    differ by that times the condition number, which says nothing about the
    solve."""
    qp = _port_qp(_golden_inputs(), torch.float32)
    m = qp.h_mat.permute(1, 2, 0).contiguous()
    m[range(120), range(120), :] += 1e-7
    rhs = -qp.g_vec.t().contiguous()
    l_j = np.asarray(PC.cholesky_nnb(jnp.asarray(m.numpy()), interpret=True))
    x_j = np.asarray(PC.cholesky_solve_nnb(
        jnp.asarray(l_j), jnp.asarray(rhs.numpy()), interpret=True))
    l_t = chol.cholesky_nnb_plain(m)
    x_t = chol.cholesky_solve_nnb_plain(torch.tensor(l_j), rhs)
    low = np.tril_indices(120)
    assert _rel(l_t.numpy()[low], l_j[low]) < 1e-5
    assert _rel(x_t.numpy(), x_j) < 1e-5


def test_plain_cholesky_matches_numpy_f64():
    m, rhs = _spd(40, 7, seed=5)
    l_t = chol.cholesky_nnb_plain(tt(m))
    x_t = chol.cholesky_solve_nnb_plain(l_t, tt(rhs))
    mb = m.transpose(2, 0, 1)
    l_n = np.linalg.cholesky(mb)
    x_n = np.linalg.solve(mb, rhs.T[..., None])[..., 0]
    assert _rel(l_t.permute(2, 0, 1).numpy(), l_n) < 1e-12
    assert _rel(x_t.t().numpy(), x_n) < 1e-12


def test_plain_cholesky_bad_pivot_stays_in_its_lane():
    """No pivot floor: a lane that is not positive definite turns non-finite
    and leaves its neighbours bit-for-bit as they were."""
    m, _ = _spd(24, 4, seed=9)
    clean = chol.cholesky_nnb_plain(tt(m))
    m[5, 5, 2] = -1.0
    bad = chol.cholesky_nnb_plain(tt(m))
    assert not torch.isfinite(bad[..., 2]).all()
    keep = [0, 1, 3]
    assert torch.equal(bad[..., keep], clean[..., keep])


# --------------------------------------------------- the wrappers' contract

def test_wrappers_route_cpu_to_plain_without_launch():
    m, rhs = _spd(24, 5, seed=1)
    m_t, rhs_t = tt(m, torch.float32), tt(rhs, torch.float32)
    before = cuda.counts.read()
    l_nnb = chol.cholesky_nnb(m_t)
    x_nnb = chol.cholesky_solve_nnb(l_nnb, rhs_t)
    l_bnn = chol.cholesky_bnn(m_t.permute(2, 0, 1).contiguous())
    x_bnn = chol.cholesky_solve_bnn(l_bnn, rhs_t.t().contiguous())
    assert cuda.counts.read() == before
    assert torch.equal(l_nnb, chol.cholesky_nnb_plain(m_t))
    assert torch.equal(x_nnb, chol.cholesky_solve_nnb_plain(l_nnb, rhs_t))
    # the two layouts are views of one function
    assert l_bnn.shape == (5, 24, 24) and x_bnn.shape == (5, 24)
    assert torch.equal(l_bnn.permute(1, 2, 0), l_nnb)
    assert torch.equal(x_bnn.t(), x_nnb)
    with pytest.raises(ValueError, match='cuda or cpu'):
        chol.cholesky_nnb(m_t.to('meta'))
    with pytest.raises(ValueError, match='cuda or cpu'):
        chol.cholesky_solve_bnn(l_bnn.to('meta'), rhs_t.t().to('meta'))


@pytest.mark.parametrize('fault', ['float64', 'square', 'rhs', 'strided',
                                   'cpu'])
def test_kernel_input_checks(fault):
    """The launch functions guard the kernels: anything but float32, square
    matrices with a matching right-hand side, dense storage and one CUDA
    device raises before a build or a launch."""
    m = torch.zeros((3, 8, 8), dtype=torch.float32)
    rhs = torch.zeros((3, 8), dtype=torch.float32)
    if fault == 'float64':
        with pytest.raises(TypeError, match='float32'):
            chol.factor_cuda(m.double(), m.double())
        with pytest.raises(TypeError, match='float32'):
            chol.solve_cuda(m, rhs.double(), rhs)
    elif fault == 'square':
        with pytest.raises(ValueError, match='square'):
            chol.factor_cuda(m[:, :, :6], m[:, :, :6])
        with pytest.raises(ValueError, match='square'):
            chol.solve_cuda(m[:, :6], rhs, rhs)
    elif fault == 'rhs':
        with pytest.raises(ValueError, match='shape'):
            chol.solve_cuda(m, rhs[:2], rhs)
        with pytest.raises(ValueError, match='shape'):
            chol.factor_cuda(m, m[:2])
    elif fault == 'strided':
        wide = torch.zeros((3, 8, 16), dtype=torch.float32)
        with pytest.raises(ValueError, match='not contiguous'):
            chol.factor_cuda(wide[:, :, ::2], m)
        with pytest.raises(ValueError, match='not contiguous'):
            chol.solve_cuda(m, torch.zeros((3, 16))[:, ::2], rhs)
    else:
        with pytest.raises(ValueError, match='CUDA device'):
            chol.factor_cuda(m, m)
        with pytest.raises(ValueError, match='CUDA device'):
            chol.solve_cuda(m, rhs, rhs)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda.CHOL, 'handle', None)
    monkeypatch.setattr(_native, 'BUILD_ROOT', tmp_path / 'build')
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('a CUDA toolkit is installed at /usr/local/cuda')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cuda.CHOL.load()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        chol.kernel_attributes(120, 'factor_tile')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        chol.tile_max_n()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        chol.route(288)
    with pytest.raises(ValueError, match='kernel is one of'):
        chol.kernel_attributes(120, 'smem')


def test_kernel_source_and_flags():
    """sm_90a, IEEE division and sqrt (no fast math), the kernels written
    out, and the source note naming the TPU kernels they replace."""
    assert 'arch=compute_90a,code=sm_90a' in cuda.CHOL.flags
    assert not any('fast' in f or 'ftz' in f for f in cuda.CHOL.flags)
    src = cuda.CHOL.source.read_text()
    assert 'hector/qp/pallas_chol.py' in src
    assert '_chol_kernel' in src and '_solve_kernel' in src
    assert 'What bounds them on the card' in src
    # the register-tile factor and solve; above their n the cluster factor
    # and the streaming solve; the shared-triangle factor and the
    # shared-memory solve off the route; the C entry points choose by n
    assert ('__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) '
            'chol_factor_kernel(') in src
    assert ('__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) '
            'chol_factor_cluster_kernel(') in src
    assert ('__global__ void __launch_bounds__(FACTOR_THREADS) '
            'chol_factor_smem_kernel(') in src
    assert 'return n <= TILE_MAX_N ? FACTOR_TILE : FACTOR_CLUSTER;' in src
    assert ('__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) '
            'chol_solve_kernel(') in src
    assert '__global__ void chol_solve_smem_kernel' in src
    assert ('__global__ void __launch_bounds__(STREAM_THREADS, '
            'STREAM_MIN_BLOCKS)\n    chol_solve_stream_kernel(') in src
    assert 'return n <= TILE_MAX_N ? SOLVE_TILE : SOLVE_STREAM;' in src
    assert 'extern "C"' in src
    for banned in ('cusolver', 'cublas', 'rsqrtf'):
        assert banned not in src.lower()


def test_work_counts():
    # the lower triangle (7,260 entries at n = 120) is what is read; the
    # factor writes all n^2 entries (the zeros above the diagonal too)
    assert chol.factor_bytes(120) == 4 * (7260 + 14400) == 86640
    assert chol.solve_bytes(120) == 4 * (7260 + 240) == 30000
    f = chol.factor_op_count(120)
    # n^3/3 operations (n^3/6 multiply-adds) to leading order
    assert abs(f['flop'] - 120 ** 3 / 3) < 0.02 * 120 ** 3
    assert f['sqrt'] == f['div'] == 120
    s = chol.solve_op_count(120)
    assert s == dict(flop=2 * 120 * 119, div=240, sqrt=0)


# ---------------------------------------------------- dense interior point

@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret'])
def test_pdip_matches_jax_f64(backend):
    inputs = _cases()
    sol_j = jpdip.solve_batched(_jax_qp(inputs),
                                SolverConfig(iterations=25, backend=backend))
    sol_t = tpdip.solve_batched(_port_qp(inputs),
                                _tcfg(iterations=25, backend=backend))
    assert float(np.abs(np.asarray(sol_j.u)).max()) > 10.0
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=TOL_SOLVE, rtol=0)
    for name in ('mu', 'r_dual', 'r_prim'):
        np.testing.assert_allclose(getattr(sol_t, name).numpy(),
                                   np.asarray(getattr(sol_j, name)),
                                   atol=1e-12, rtol=1e-9, err_msg=name)


# the bars of tests/test_qp.py: 1e-3 N in float64 (test_pdip_matches_
# certified_solution), 0.05 N in float32 with kkt_reg=1e-7
# (test_pdip_float32_accuracy).  'auto' on CPU tensors is 'pallas' through
# the wrappers' plain versions on (B, n, n).
@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret', 'auto'])
@pytest.mark.parametrize('dtype,reg,bar', [
    (torch.float64, 1e-8, 1e-3), (torch.float32, 1e-7, 0.05)],
    ids=['f64', 'f32'])
def test_pdip_meets_certified_optima(dtype, reg, bar, backend):
    before = cuda.counts.read()
    sol = tpdip.solve_batched(
        _port_qp(_golden_inputs(), dtype),
        _tcfg(iterations=25, kkt_reg=reg, backend=backend))
    assert cuda.counts.read() == before
    assert sol.u.dtype == dtype
    for k in range(3):
        err = np.abs(sol.u[k].double().numpy() - GOLD[f's{k}_q_soln']).max()
        assert err < bar, f'scenario {k}: {err}'
        keep = GOLD[f's{k}_keep_v']
        if (~keep).any():      # swing-leg variables come out as zeros
            assert np.abs(sol.u[k].numpy()[~keep]).max() < 1e-6
    if dtype == torch.float64:
        # the certificate of tests/test_qp.py::test_pdip_kkt_certificate
        assert float(sol.mu.max()) < 1e-8
        assert float(sol.r_prim.max()) < 1e-8
        assert float(sol.r_dual.max()) < 1e-5


def test_pdip_solve_unbatched():
    qp = _port_qp(_golden_inputs())
    one = tpdip.solve(tbuild.QPData(*[x[1] for x in qp]),
                      _tcfg(iterations=25, backend='xla'))
    assert one.u.shape == (120,) and one.mu.shape == ()
    assert np.abs(one.u.numpy() - GOLD['s1_q_soln']).max() < 1e-3


@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret'])
def test_pdip_nan_lane_is_skipped_and_isolated(backend):
    """A QP with a non-finite g_vec never steps (u stays 0) and leaves its
    neighbours' solutions bit-for-bit unchanged."""
    qp = _port_qp(_closed_loop_inputs(4, seed=3))
    scfg = _tcfg(backend=backend)
    clean = tpdip.solve_batched(qp, scfg)
    g = qp.g_vec.clone()
    g[2, 7] = float('nan')
    sol = tpdip.solve_batched(qp._replace(g_vec=g), scfg)
    assert torch.equal(sol.u[2], torch.zeros(120, dtype=F64))
    keep = [0, 1, 3]
    assert torch.equal(sol.u[keep], clean.u[keep])
    assert torch.isfinite(sol.u).all()


def test_pdip_rejects_unknown_backend():
    with pytest.raises(ValueError, match='backend'):
        tpdip.solve_batched(_port_qp(_golden_inputs()),
                            _tcfg(backend='riccati'))


# ------------------------------------------------ the compiled entry points

def _bit_equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize('backend', ['auto', 'xla', 'pallas_interpret'])
def test_make_solver_is_solve_batched_bit_for_bit(backend):
    """pdip.make_solver on CPU tensors: the runner runs the solve eagerly on
    its buffers, bit for bit solve_batched, twice over on the same buffers
    (one capture entry for the QPs' shapes, dtype and device), and what it
    returns aliases none of them."""
    scfg = _tcfg(iterations=2, backend=backend)
    qp = _port_qp(_closed_loop_inputs(4, seed=3), torch.float32)
    qp2 = _port_qp(_closed_loop_inputs(4, seed=4), torch.float32)
    solver = tpdip.make_solver(scfg)
    first = solver(qp)
    held = graph.tree_map(torch.clone, first)
    assert type(first) is type(tpdip.solve_batched(qp, scfg))
    assert _bit_equal(first, tpdip.solve_batched(qp, scfg))
    assert _bit_equal(solver(qp2), tpdip.solve_batched(qp2, scfg))
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
    scfg = _tcfg(iterations=2)
    qp = _port_qp(_closed_loop_inputs(3, seed=5), torch.float32)
    solver = tpdip.make_solver(scfg)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    assert _bit_equal(solver(qp), tpdip.solve_batched(qp, scfg))
    assert not solver.steps.captures


# The port's runner against JAX's jax.jit of its lax.scan, float64, under
# the same dense backend.  Measured differences after 2 periods: the
# wrench 4e-12 (xla) and 7e-12 N (pallas_interpret), every state field
# but the joints below 3e-15; the joints carry the jitted IK's 2.5e-7 rad
# (JIT_IK_TOL) through the joint servo (qd = dq / 0.02 s): q 4.6e-9 rad,
# qd 1.4e-6 rad/s, the bars test_torch_slice.py's rollout test holds them
# to.
@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret'])
def test_dense_rollout_runner_matches_jax_jit(backend):
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=1)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, F64)
    carry, plant, j_diags = JRT.make_rollout(
        2, _with_solver(JCFG, backend=backend), batched=True)(
            carry, plant, cmd)
    roll = TRT.make_rollout(2, _with_solver(TCFG, backend=backend))
    t_carry, t_plant, t_diags = roll(t_carry, t_plant, t_cmd)
    assert len(roll.graphed.captures) == 1
    j_diags = todict(j_diags)
    t_diags = {k: v.numpy() for k, v in t_diags.items()}
    assert float(np.abs(j_diags['wrench']).max()) > 10.0
    joints = {'q': JIT_IK_TOL, 'qd': 1e-5}
    assert_tree_close(j_diags, t_diags, 1e-9)
    assert_tree_close(todict(plant), convert.to_numpy(t_plant), 1e-9,
                      overrides=joints)
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), 1e-9)
