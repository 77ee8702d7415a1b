"""The fused Riccati solver of the port: its plain PyTorch version against
the JAX stage solver, and its wrapper's contract.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it to this
plain version there at 2e-4 N).  Here the plain version, which the wrapper
uses for CPU tensors, is held to ``hector.qp.riccati.solve_batched`` with
``mehrotra=False`` (the fixed-sigma interior point the TPU kernel mirrors),
without and with the active-set polish, and to the certified optima of
tests/golden/solver.npz.
"""

import ctypes
import dataclasses
import functools
import inspect
import os
import re

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

from hector_torch import _native, cuda
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


def test_plain_polish_matches_jax_f64():
    """The polish of the plain version (the kernel's form: float masks, one
    rolled loop) against the pure-JAX stage solver's polish block: the same
    lanes accept it, and on those the forces agree to 1e-8 N (measured
    ~1e-13).  A lane is known to have accepted when its answer differs from
    the run in which nothing can be accepted (polish_tol < 0)."""
    inputs = _both_cases()
    parts = _port_parts(inputs, torch.float64)
    kw = dict(mehrotra=False, polish_rounds=8)
    sol_j = _jax_solve(inputs, SolverConfig(**kw), jnp.float64)
    off_j = _jax_solve(inputs, SolverConfig(polish_tol=-1.0, **kw),
                       jnp.float64)
    sol_t = FR.solve_parts_plain(parts, _tcfg(polish_rounds=8), Q_DIAG,
                                 R_DIAG)
    off_t = FR.solve_parts_plain(parts, _tcfg(polish_rounds=8,
                                              polish_tol=-1.0),
                                 Q_DIAG, R_DIAG)
    acc_j = (np.asarray(sol_j.u) != np.asarray(off_j.u)).any(axis=1)
    acc_t = (sol_t.u != off_t.u).any(dim=1).numpy()
    np.testing.assert_array_equal(acc_t, acc_j)
    assert acc_t.sum() >= 3
    np.testing.assert_allclose(sol_t.u.numpy()[acc_t],
                               np.asarray(sol_j.u)[acc_j], atol=1e-8, rtol=0)
    np.testing.assert_allclose(sol_t.r_prim.numpy(), np.asarray(sol_j.r_prim),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize('dtype,iters', [
    (torch.float32, 6),     # no float32 lane reaches 10 eps in 6 iterations
    (torch.float64, 14),    # nor a float64 lane 1e-14 in 14
], ids=['f32', 'f64'])
def test_plain_rejected_polish_is_the_interior_point(dtype, iters):
    """With polish_tol < 0 no lane can accept the polish, and what is left
    is the interior point without the freeze (mu_floor = 0), the iterate the
    card's forced-rejection check compares.  Where no lane would freeze,
    that is the interior point without polish, bit for bit: u, mu and the
    residuals (the multipliers fall back to the interior point's)."""
    parts = _port_parts(_both_cases(), dtype)
    ip = FR.solve_parts_plain(parts, _tcfg(iterations=iters), Q_DIAG, R_DIAG)
    off = FR.solve_parts_plain(
        parts, _tcfg(iterations=iters, polish_rounds=8, polish_tol=-1.0),
        Q_DIAG, R_DIAG)
    floor = max(1e-14, 10.0 * torch.finfo(dtype).eps)
    assert bool((ip.mu > floor).all())          # no lane froze
    for x, y in zip(ip, off):
        assert torch.equal(x, y)
    # and the polish does move the lanes it accepts
    on = FR.solve_parts_plain(parts, _tcfg(iterations=iters, polish_rounds=8),
                              Q_DIAG, R_DIAG)
    assert bool((on.u != off.u).any(1).any())


def _bounds_off_the_one_sided_rows(inputs):
    """The problems of ``inputs`` with finite bounds on rows the interior
    point treats as one-sided the other way: a lower bound 0.5 above the
    interior point's optimum on the line-contact moment row 5 (upper side
    only) of the stages where it is well below 0, and an upper bound 1
    below it on the friction row 0 (lower side only) where that is above
    5."""
    parts = _port_parts(inputs, torch.float64)
    sol = FR.solve_parts_plain(parts, _tcfg(), Q_DIAG, R_DIAG)
    cu = sol.u.reshape(-1, 10, 12) @ parts.c_block.transpose(1, 2)
    big = TSolverConfig().big_threshold
    lb, ub = parts.lb.clone(), parts.ub.clone()
    free_lb = (lb[..., 5] <= -big) & (ub[..., 5] < big) & (cu[..., 5] < -1.0)
    lb[..., 5] = torch.where(free_lb, cu[..., 5] + 0.5, lb[..., 5])
    free_ub = (ub[..., 0] >= big) & (lb[..., 0] > -big) & (cu[..., 0] > 5.0)
    ub[..., 0] = torch.where(free_ub, cu[..., 0] - 1.0, ub[..., 0])
    assert int(free_lb.sum()) >= 10 and int(free_ub.sum()) >= 10
    return lb.numpy(), ub.numpy(), (free_lb | free_ub).any(1).numpy()


def test_plain_polish_masks_follow_bound_values_f64():
    """The polish's row masks come from the bound values on all 16 rows
    (pallas_riccati.py:95-98), not from the interior point's one-sided
    sets: a finite bound on a row the interior point treats as one-sided
    the other way is ignored by the interior point (its r_prim shows the
    violation) and held by the polish.  Against the JAX stage solver, whose
    interior point and polish both take every finite bound, the lanes that
    accept the polish agree to 1e-8 N and meet every bound."""
    inputs = _both_cases()
    lb, ub, moved = _bounds_off_the_one_sided_rows(inputs)
    parts = _port_parts(inputs, torch.float64)._replace(
        lb=torch.tensor(lb), ub=torch.tensor(ub))
    ip = FR.solve_parts_plain(parts, _tcfg(), Q_DIAG, R_DIAG)
    assert float(ip.r_prim[torch.tensor(moved)].min()) > 0.4
    kw = dict(mehrotra=False, polish_rounds=8)
    sqps = [build_stage_qp(*[jnp.asarray(a[k], jnp.float64)
                             for a in inputs[:5]],
                           jnp.asarray(I_BODY, jnp.float64),
                           jnp.asarray(inputs[5][k], jnp.float64), CFG)
            for k in range(len(inputs[0]))]
    sqp = jax.tree.map(lambda *xs: jnp.stack(xs), *sqps)
    sqp = sqp._replace(lb=jnp.asarray(lb), ub=jnp.asarray(ub))
    solve = jax.jit(riccati.solve_batched, static_argnums=1)
    sol_j = solve(sqp, SolverConfig(**kw))
    off_j = solve(sqp, SolverConfig(polish_tol=-1.0, **kw))
    sol_t = FR.solve_parts_plain(parts, _tcfg(polish_rounds=8), Q_DIAG,
                                 R_DIAG)
    off_t = FR.solve_parts_plain(parts, _tcfg(polish_rounds=8,
                                              polish_tol=-1.0),
                                 Q_DIAG, R_DIAG)
    acc_j = (np.asarray(sol_j.u) != np.asarray(off_j.u)).any(axis=1)
    acc_t = (sol_t.u != off_t.u).any(dim=1).numpy()
    both = acc_j & acc_t & moved
    assert both.sum() >= 3
    np.testing.assert_allclose(sol_t.u.numpy()[both],
                               np.asarray(sol_j.u)[both], atol=1e-8, rtol=0)
    assert float(sol_t.r_prim[torch.tensor(both)].max()) < 1e-9


def test_plain_polish_meets_qpoases_bar_f32():
    """The bar tests/test_pallas_riccati.py holds the TPU kernel body with
    polish to: within 1e-3 N of the certified optima in pure float32, with a
    polished primal residual below 1e-6."""
    sol = FR.solve_parts_plain(_port_parts(_golden_inputs(), torch.float32),
                               _tcfg(polish_rounds=8), Q_DIAG, R_DIAG)
    assert sol.u.dtype == torch.float32
    for k in range(3):
        err = np.abs(sol.u[k].double().numpy() - GOLD[f's{k}_q_soln']).max()
        assert err < 1e-3, f'scenario {k}: {err}'
        assert float(sol.r_prim[k]) < 1e-6


@pytest.mark.parametrize('dtype,short,long', [
    (torch.float32, 14, 24),
    # float64's floor is 1e-14: these lanes reach it after ~16 iterations
    (torch.float64, 24, 34),
], ids=['f32', 'f64'])
def test_plain_frozen_lane_stays_bit_identical(dtype, short, long):
    """The invariant the warp kernel's early exit rests on: a lane whose mu
    after ``short`` iterations is below mu_floor (the mu the next iteration
    tests), or whose iterate is not finite, is skipped by every later
    iteration, so ``long`` iterations give the same u and stats bit for
    bit."""
    parts = _port_parts(_both_cases(), dtype)
    x0 = parts.x0.clone()
    x0[4, 2] = float('nan')           # a lane that is never finite
    parts = parts._replace(x0=x0)
    a = FR.solve_parts_plain(parts, _tcfg(iterations=short), Q_DIAG, R_DIAG)
    b = FR.solve_parts_plain(parts, _tcfg(iterations=long), Q_DIAG, R_DIAG)
    floor = max(1e-14, 10.0 * torch.finfo(dtype).eps)
    by_mu = a.mu < floor
    not_finite = ~torch.isfinite(a.mu) | ~torch.isfinite(a.u).all(1)
    frozen = by_mu | not_finite
    assert int(by_mu.sum()) >= 1 and bool(not_finite[4])
    for x, y in ((a.u, b.u), (a.mu, b.mu), (a.r_dual, b.r_dual),
                 (a.r_prim, b.r_prim)):
        torch.testing.assert_close(x[frozen], y[frozen], rtol=0, atol=0,
                                   equal_nan=True)


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
    before = cuda.counts.launches
    sol = FR.solve_parts(parts, _tcfg(), Q_DIAG, R_DIAG)
    plain = FR.solve_parts_plain(parts, _tcfg(), Q_DIAG, R_DIAG)
    assert cuda.counts.launches == before
    assert torch.equal(sol.u, plain.u)


def test_wrapper_rejects_polish_and_foreign_devices():
    """The polish is part of the solver now: the wrapper takes it (a CPU
    tensor goes to the plain version, no launch) and rejects only a polish
    without inner iterations; tensors on a device that is neither the card
    nor the CPU are still refused."""
    parts = _port_parts(_golden_inputs(), torch.float32)
    before = cuda.counts.read()
    sol = FR.solve_parts(parts, _tcfg(polish_rounds=2), Q_DIAG, R_DIAG)
    assert cuda.counts.read() == before
    assert torch.isfinite(sol.u).all() and float(sol.r_prim.max()) < 1e-6
    with pytest.raises(ValueError, match='polish_iters'):
        FR.solve_parts(parts, _tcfg(polish_rounds=2, polish_iters=0),
                       Q_DIAG, R_DIAG)
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
    """The library is built from source at first use: without nvcc the
    build raises (no fallback), and so does a launch's lazy build."""
    monkeypatch.setattr(cuda.FUSED, 'handle', None)
    monkeypatch.setattr(_native, 'BUILD_ROOT', tmp_path / 'build')
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('a CUDA toolkit is installed at /usr/local/cuda')
    for build in (cuda.FUSED.load, FR.kernel_attributes):
        with pytest.raises(RuntimeError, match='nvcc not found'):
            build()


def test_kernel_source_and_flags():
    """sm_90a, IEEE division and sqrt (no fast math), the source note naming
    the TPU kernel it replaces, and the plain C entry points the wrapper
    loads."""
    assert 'arch=compute_90a,code=sm_90a' in cuda.FUSED.flags
    assert not any('fast' in f or 'ftz' in f for f in cuda.FUSED.flags)
    src = cuda.FUSED.source.read_text()
    assert 'hector/qp/pallas_riccati.py:_kernel' in src
    assert 'What bounds it on the card' in src
    assert 'extern "C"' in src
    for name in ('fused_riccati_warp_solve', 'fused_riccati_warp_attributes',
                 'fused_riccati_warp_error_string',
                 'fused_riccati_warp_polish_counts',
                 'fused_riccati_warp_polish_steps'):
        assert f'{name}(' in src


def test_params_mirror_the_kernel_struct():
    """cuda.FusedRiccatiParams must list the fields of the C struct in
    order, with the same types and array lengths."""
    fields_ = cuda.FusedRiccatiParams._fields_
    mine = [n.replace('polish_', 'pol_') for n, _ in fields_]
    body = cuda.FUSED.source.read_text().split('struct FusedRiccatiParams {')[1]
    body = body.split('};')[0]
    fields = [line.split(';')[0].split() for line in body.splitlines()
              if ';' in line]
    assert mine == [f[-1].split('[')[0] for f in fields]
    assert [f[0] for f in fields] == [
        'int' if t is ctypes.c_int else 'float'
        for t in (ty._type_ if issubclass(ty, ctypes.Array) else ty
                  for _, ty in fields_)]


def test_warp_kernel_source():
    """One source, one kernel template: the polish is the instantiation
    <true> of the same body, and both instantiations share one newton_dir
    call site (a second would inline the sweep twice).  The one-thread
    kernel is gone, and so is every path of the wrapper that reached it."""
    src = cuda.FUSED.source.read_text()
    assert 'template <bool POLISH>' in src
    assert 'fused_riccati_warp_kernel<POLISH>' in src
    assert 'launch<true>(' in src and 'launch<false>(' in src
    assert 'attributes<true>(' in src and 'attributes<false>(' in src
    assert src.count('newton_dir<POLISH>(s, cst, lane, ') == 1
    # the definition and the one call
    assert len(re.findall(r'\bnewton_dir[<(]', src)) == 2
    assert not (cuda.CSRC / 'fused_riccati.cu').exists()
    assert sorted(p.name for p in cuda.CSRC.glob('*.cu')) == [
        'chol.cu', 'fused_riccati_warp.cu', 'srb_plant.cu', 'wb_dynamics.cu']
    assert not [n for n in vars(FR) if 'thread' in n.lower()]
    for gone in ('SOURCE', 'SCRATCH_PER_SCENARIO', '_lib'):
        assert not hasattr(FR, gone), gone
    # the wrapper launches the one library for every polish_rounds and
    # counts the two instantiations apart
    wrapper = inspect.getsource(FR.solve_parts_cuda)
    assert wrapper.count("FUSED.launch('fused_riccati_warp_solve'") == 1
    assert ("'polish_launches' if scfg.polish_rounds > 0" in wrapper
            and "else 'launches'" in wrapper)
    assert 'warp=' not in inspect.getsource(FR)
    with pytest.raises(ValueError, match="'warp' or 'polish'"):
        FR.kernel_attributes('thread')


def test_work_counts():
    assert FR.bytes_per_scenario() == 4 * (9 + 3 + 36 + 120 + 13 + 130 + 192
                                           + 160 + 160 + 120 + 3)
    c14, c0 = FR.op_count(14), FR.op_count(0)
    assert c14['flop'] > c0['flop'] > 0
    assert c14['sqrt'] == 15 * 10 * 12
    # 32 polish steps are 32 more Riccati solves: more work than 14
    # interior-point iterations
    cp = FR.op_count(14, polish_steps=32)
    assert cp['sqrt'] == (15 + 32) * 10 * 12
    assert cp['flop'] - c14['flop'] > c14['flop'] - c0['flop']


@pytest.mark.slow
@pytest.mark.parametrize('polish_rounds', [0, 8], ids=['ip', 'polish'])
def test_plain_matches_tpu_kernel_body(polish_rounds):
    """Against the Pallas kernel body run under XLA (traces for minutes on
    a CPU, hence slow), without and with the polish."""
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

    scfg = SolverConfig(mehrotra=False, polish_rounds=polish_rounds)
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
                                 _tcfg(polish_rounds=polish_rounds), Q_DIAG,
                                 R_DIAG)
    assert np.abs(sol_t.u.numpy() - u_tile).max() < TOL_F32
