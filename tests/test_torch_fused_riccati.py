"""The fused Riccati solver of the port: its plain PyTorch version against
the JAX stage solver, and its wrapper's contract.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it to this
plain version there at 2e-4 N).  Here the plain version, which the wrapper
uses for CPU tensors, is held to ``hector.qp.riccati.solve_batched`` with
``mehrotra=False`` (the fixed-sigma interior point the TPU kernel mirrors)
and to the certified optima of tests/golden/solver.npz.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import kinematics as JK
from hector import math as JM
from hector.config import MPCConfig, SolverConfig, JOINT_OFFSETS
from hector.qp.builder import build_stage_qp
from hector.qp import riccati

from hector_torch.config import SolverConfig as TSolverConfig
from hector_torch.qp import builder as tbuild
from hector_torch.qp import fused_riccati as FR

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

GOLD = np.load(__file__.rsplit('/', 1)[0] + '/golden/solver.npz')
CFG = MPCConfig()
I_BODY = np.diag([0.5413, 0.5200, 0.0691])
OFFS = np.array(JOINT_OFFSETS)
Q_DIAG = tuple(CFG.weights) + (0.0,)
R_DIAG = tuple(CFG.alpha)
# float64: both sides run the same fixed-sigma iteration in double
# precision; they differ only in rounding order (measured ~1e-13 N on
# ~200 N forces)
TOL_F64 = 1e-9
# float32: the bar tests/test_pallas_riccati.py holds the TPU kernel body
# to against the pure-JAX float32 solver
TOL_F32 = 2e-4


def _golden_inputs():
    """Per golden scenario k: x0, traj, r_body, r_foot, r_feet, gait (f64)."""
    out = []
    for k in range(3):
        r_body = np.asarray(JM.quat_to_rot(jnp.asarray(GOLD[f's{k}_quat'])))
        r_foot = np.asarray(JK.foot_rotation(jnp.asarray(
            GOLD[f's{k}_joint_angles'].reshape(2, 5) + OFFS)))
        out.append((GOLD[f's{k}_x0'], GOLD[f's{k}_traj'], r_body, r_foot,
                    GOLD[f's{k}_r_feet'], GOLD[f's{k}_gait']))
    return [np.stack(xs) for xs in zip(*out)]


def _closed_loop_inputs(n=8, seed=0):
    """Golden scenarios perturbed: small state, reference and pose noise on
    top of the three certified problems."""
    rng = np.random.default_rng(seed)
    base = _golden_inputs()
    idx = rng.integers(0, 3, n)
    x0, traj, r_body, r_foot, r_feet, gait = [b[idx].copy() for b in base]
    x0[:, :12] += rng.normal(0.0, 0.01, (n, 12))
    traj += rng.normal(0.0, 0.01, traj.shape)
    r_feet += rng.normal(0.0, 0.005, r_feet.shape)
    return x0, traj, r_body, r_foot, r_feet, gait


def _jax_solve(inputs, scfg, dtype):
    sqps = [build_stage_qp(*[jnp.asarray(a[k], dtype) for a in inputs[:5]],
                           jnp.asarray(I_BODY, dtype),
                           jnp.asarray(inputs[5][k], dtype), CFG)
            for k in range(len(inputs[0]))]
    sqp = jax.tree.map(lambda *xs: jnp.stack(xs), *sqps)
    return jax.jit(riccati.solve_batched, static_argnums=1)(sqp, scfg)


def _port_parts(inputs, dtype):
    t = [torch.tensor(np.asarray(a), dtype=dtype) for a in inputs]
    return tbuild.build_stage_parts(*t[:5], torch.tensor(I_BODY, dtype=dtype),
                                    t[5], CFG)


def _tcfg(**kw):
    return dataclasses.replace(TSolverConfig(), **kw)


def _both_cases():
    """The three golden problems and eight perturbed copies, one batch."""
    return [np.concatenate([g, p]) for g, p in zip(_golden_inputs(),
                                                     _closed_loop_inputs())]


def test_plain_matches_jax_fixed_sigma_f64():
    inputs = _both_cases()
    sol_j = _jax_solve(inputs, SolverConfig(mehrotra=False), jnp.float64)
    sol_t = FR.solve_parts_plain(_port_parts(inputs, torch.float64),
                                 _tcfg(), Q_DIAG, R_DIAG)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=TOL_F64, rtol=0)
    for name in ('mu', 'r_dual', 'r_prim'):
        np.testing.assert_allclose(getattr(sol_t, name).numpy(),
                                   np.asarray(getattr(sol_j, name)),
                                   atol=TOL_F64, rtol=1e-6)


def test_plain_matches_jax_fixed_sigma_f32():
    inputs = _both_cases()
    sol_j = _jax_solve(inputs, SolverConfig(mehrotra=False), jnp.float32)
    sol_t = FR.solve_parts_plain(_port_parts(inputs, torch.float32),
                                 _tcfg(), Q_DIAG, R_DIAG)
    assert sol_t.u.dtype == torch.float32
    err = np.abs(sol_t.u.numpy() - np.asarray(sol_j.u)).max()
    assert err < TOL_F32, err


@pytest.mark.parametrize('dtype,iters,bar', [
    (torch.float32, 14, 1e-2),      # the float32 accuracy floor
    (torch.float64, 30, 1e-3),      # tests/test_riccati.py fixed-sigma bar
], ids=['f32-14', 'f64-30'])
def test_plain_meets_certified_optima(dtype, iters, bar):
    sol = FR.solve_parts_plain(_port_parts(_golden_inputs(), dtype),
                               _tcfg(iterations=iters), Q_DIAG, R_DIAG)
    for k in range(3):
        err = np.abs(sol.u[k].double().numpy() - GOLD[f's{k}_q_soln']).max()
        assert err < bar, f'scenario {k}: {err}'
        assert float(sol.mu[k]) < 1e-4
        assert float(sol.r_prim[k]) < 1e-4


def test_plain_nan_lane_is_skipped_and_isolated():
    """A non-finite lane never steps (u stays 0), as in the JAX solver, and
    leaves the other lanes bit-identical."""
    inputs = _closed_loop_inputs(4, seed=3)
    parts = _port_parts(inputs, torch.float64)
    clean = FR.solve_parts_plain(parts, _tcfg(), Q_DIAG, R_DIAG)
    x0 = parts.x0.clone()
    x0[2, 4] = float('nan')
    sol = FR.solve_parts_plain(parts._replace(x0=x0), _tcfg(), Q_DIAG, R_DIAG)
    assert torch.equal(sol.u[2], torch.zeros(120, dtype=torch.float64))
    keep = [0, 1, 3]
    assert torch.equal(sol.u[keep], clean.u[keep])


def test_wrapper_routes_cpu_to_plain_without_launch():
    parts = _port_parts(_golden_inputs(), torch.float32)
    before = FR.launches
    sol = FR.solve_parts(parts, _tcfg(), Q_DIAG, R_DIAG)
    plain = FR.solve_parts_plain(parts, _tcfg(), Q_DIAG, R_DIAG)
    assert FR.launches == before
    assert torch.equal(sol.u, plain.u)


def test_wrapper_rejects_polish_and_foreign_devices():
    parts = _port_parts(_golden_inputs(), torch.float32)
    with pytest.raises(NotImplementedError, match='B item 1'):
        FR.solve_parts(parts, _tcfg(polish_rounds=2), Q_DIAG, R_DIAG)
    meta = type(parts)(*[x.to('meta') for x in parts])
    with pytest.raises(ValueError, match='cuda or cpu'):
        FR.solve_parts(meta, _tcfg(), Q_DIAG, R_DIAG)


@pytest.mark.parametrize('fault', ['float64', 'cpu', 'horizon', 'batch'])
def test_kernel_input_checks(fault):
    """check_parts guards the kernel launch: anything but float32 on one
    CUDA device at h=10, nx=13, nu=12, nc=16 raises."""
    parts = _port_parts(_golden_inputs(), torch.float32)
    if fault == 'float64':
        parts = parts._replace(lb=parts.lb.double())
        err, match = TypeError, 'float32'
    elif fault == 'horizon':
        parts = parts._replace(lb=parts.lb[:, :9], ub=parts.ub[:, :9])
        err, match = ValueError, 'shape'
    elif fault == 'batch':
        parts = parts._replace(xd=parts.xd[:2])
        err, match = ValueError, 'shape'
    else:
        err, match = ValueError, 'CUDA device'
    with pytest.raises(err, match=match):
        FR.check_parts(parts)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(FR, '_lib', None)
    monkeypatch.setattr(FR, 'BUILD_ROOT', tmp_path / 'build')
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('a CUDA toolkit is installed at /usr/local/cuda')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        FR.build()


def test_kernel_source_and_flags():
    """sm_90a, IEEE division and sqrt (no fast math), and the source note
    naming the TPU kernel it replaces."""
    assert 'arch=compute_90a,code=sm_90a' in FR.NVCC_FLAGS
    assert not any('fast' in f or 'ftz' in f for f in FR.NVCC_FLAGS)
    src = FR.SOURCE.read_text()
    assert 'hector/qp/pallas_riccati.py:_kernel' in src
    assert 'What bounds it on the card' in src
    assert 'extern "C"' in src


def test_work_counts():
    assert FR.bytes_per_scenario() == 4 * (9 + 3 + 36 + 120 + 13 + 130 + 192
                                           + 160 + 160 + 120 + 3)
    c14, c0 = FR.op_count(14), FR.op_count(0)
    assert c14['flop'] > c0['flop'] > 0
    assert c14['sqrt'] == 15 * 10 * 12


@pytest.mark.slow
def test_plain_matches_tpu_kernel_body():
    """Against the Pallas kernel body run under XLA (traces for minutes on
    a CPU, hence slow)."""
    from hector.qp import pallas_riccati as PR
    inputs = _golden_inputs()
    sqps = [build_stage_qp(*[jnp.asarray(a[k], jnp.float32)
                             for a in inputs[:5]],
                           jnp.asarray(I_BODY, jnp.float32),
                           jnp.asarray(inputs[5][k], jnp.float32), CFG)
            for k in range(3)]
    sqp = jax.tree.map(lambda *xs: jnp.stack(xs), *sqps)
    a_dt, b_dt, u_mask, x0, xd, qd, rd, c_blk, lb, ub = sqp

    def pack(x):
        return jnp.moveaxis(x.astype(jnp.float32), 0, -1)[..., None, :]

    scfg = SolverConfig(mehrotra=False)
    scfg_s = (scfg.iterations, scfg.sigma_fixed, scfg.frac_to_boundary,
              scfg.big_threshold, scfg.init_slack, scfg.init_dual,
              scfg.polish_rounds, scfg.polish_iters, scfg.polish_rho,
              scfg.polish_tol)
    f = jax.jit(functools.partial(PR._solve_tile, q2=Q_DIAG, r2=R_DIAG,
                                  reg=scfg.kkt_reg, scfg_s=scfg_s))
    u_t, _ = f(pack(a_dt[:, 0:3, 6:9]),
               pack(jnp.stack([a_dt[:, 3, 9], a_dt[:, 11, 12],
                               b_dt[:, 9, 0]], axis=1)),
               pack(b_dt[:, 6:9, :]), pack(c_blk), pack(u_mask), pack(x0),
               pack(xd), pack(lb), pack(ub))
    u_tile = np.moveaxis(np.asarray(u_t)[..., 0, :], -1, 0).reshape(3, -1)
    sol_t = FR.solve_parts_plain(_port_parts(inputs, torch.float32),
                                 _tcfg(), Q_DIAG, R_DIAG)
    assert np.abs(sol_t.u.numpy() - u_tile).max() < TOL_F32
