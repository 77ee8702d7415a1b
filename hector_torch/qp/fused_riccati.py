"""Fused Riccati interior point: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``hector/qp/pallas_riccati.py:_kernel``
(body ``_solve_tile``, launched at ``:668``).  Both versions here run the
fixed-sigma interior point of that kernel on the compact ``StageQPParts``
(h=10, nx=13, nu=12, nc=16) and, when ``polish_rounds > 0``, its primal-dual
active-set polish (``:542-610``):

- :func:`solve_parts` is the entry point.  A CUDA tensor goes to a kernel
  (built with nvcc at first use into ``hector_torch/_build/``), a CPU tensor
  to :func:`solve_parts_plain`.  Nothing falls back from one to the other.
  :func:`solve_batched` (and :func:`make_solver`) is the same on the full
  stage form ``riccati.StageQPData``, whose slices it hands on.
- :func:`solve_parts_plain` is the same algorithm in batched PyTorch ops on
  (B, ...) tensors, with the kernel's policies: one-sided rows, the pivot
  floor, s_floor, d_cap, the 1e8 clip, the rate form of the primal step and
  the skip rule.  It runs in float32 and float64.  Its one departure: the
  complementarity freeze ``mu_floor`` is max(1e-14, 10 eps), which is the
  kernel's 10 eps in float32 and the JAX Riccati solver's 1e-14 in float64.
  With the polish on there is no freeze, as in the kernel: the interior
  point runs to its clamp-limited stall point, where the active set shows.

One source holds the kernel, ``hector_torch/csrc/fused_riccati_warp.cu``:
one warp per scenario, a template compiled twice.
``fused_riccati_warp_kernel<false>`` is the interior point alone, which the
default configuration (``polish_rounds = 0``) launches; ``launches`` in the
registry ``cuda.counts`` counts it.  ``fused_riccati_warp_kernel<true>``
adds the polish and serves ``polish_rounds > 0``; ``polish_launches``
counts it, and
:func:`polish_counts` reads the kernel's own counts of the lanes it polished
and of those whose polish it rejected (they keep the interior point's
iterate).  Their ratio is the fallback rate.

The plain version touches no counter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import constant
from ..config import SolverConfig
from ..cuda import FUSED, FusedRiccatiParams

H = 10      # horizon / gait segments
NX = 13     # state dim  [rpy, p, omega, v, g]
NU = 12     # input dim  [F_L, F_R, M_L, M_R]
NC = 16     # constraint rows per stage
# one-sided rows: a lower bound can only be finite on the friction/Mx/Fz
# rows of each leg, an upper bound only on the Mx/line-contact/Fz rows
# (hector/constraints.py; pallas_riccati.py:102-114)
LR = (0, 1, 2, 3, 4, 7, 8, 9, 10, 11, 12, 15)
UR = (4, 5, 6, 7, 12, 13, 14, 15)


class QPSolution(NamedTuple):
    """Solver output, as hector/qp/pdip.QPSolution: u flattened (B, 12h)."""

    u: torch.Tensor       # (B, h*12)
    mu: torch.Tensor      # (B,) final complementarity
    r_dual: torch.Tensor  # (B,) max |dual residual|
    r_prim: torch.Tensor  # (B,) max primal violation


def _weights(scfg: SolverConfig, q_diag, r_diag):
    """The objective's factor 2 (H = 2(B'SB + alpha), SolverMPC.cpp:569)
    folded into the weights, in double precision as the JAX kernel does."""
    if scfg.polish_rounds > 0 and scfg.polish_iters < 1:
        raise ValueError('polish_rounds > 0 needs polish_iters >= 1, got '
                         f'{scfg.polish_iters}')
    q2 = [2.0 * float(v) for v in q_diag]
    r2 = [2.0 * float(v) for v in r_diag]
    r2reg = [v + float(scfg.kkt_reg) for v in r2]
    if len(q2) != NX or len(r2) != NU:
        raise ValueError(f'q_diag needs {NX} and r_diag {NU} entries, got '
                         f'{len(q2)} and {len(r2)}')
    return q2, r2, r2reg


def solve_parts(parts, scfg: SolverConfig, q_diag, r_diag) -> QPSolution:
    """Solve a batch of stage QPs given as ``StageQPParts`` (leading batch
    dim B on every field).  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    dev = parts.x0.device
    if dev.type == 'cuda':
        return solve_parts_cuda(parts, scfg, q_diag, r_diag)
    if dev.type == 'cpu':
        return solve_parts_plain(parts, scfg, q_diag, r_diag)
    raise ValueError(f'fused_riccati runs on cuda or cpu tensors, not {dev}')


def stage_parts(sqp):
    """The slices of a full stage form (``riccati.StageQPData``) that the
    kernel reads, as ``StageQPParts`` (pallas_riccati.py:698-702): s69 =
    a_dt[0:3, 6:9], scal = (a_dt[3, 9], a_dt[11, 12], b_dt[9, 0]), b69 =
    b_dt[6:9, :].  ``build_stage_parts`` computes the same values directly
    (b_dt[9, 0] = dt (1/m) there is dt/m, which may differ by an ulp)."""
    from .builder import StageQPParts
    a_dt, b_dt, u_mask, x0, xd, _, _, c_blk, lb, ub = sqp
    scal = torch.stack([a_dt[:, 3, 9], a_dt[:, 11, 12], b_dt[:, 9, 0]], 1)
    return StageQPParts(a_dt[:, 0:3, 6:9], scal, b_dt[:, 6:9, :], u_mask, x0,
                        xd, c_blk, lb, ub)


def solve_batched(sqp, scfg: SolverConfig = SolverConfig(), q_diag=None,
                  r_diag=None) -> QPSolution:
    """Solve a batch of stage QPs given in the full stage form
    (``riccati.StageQPData``) with the fused solver: :func:`solve_parts`
    on :func:`stage_parts`, so a CUDA tensor launches the kernel and a CPU
    tensor runs the plain version.  ``q_diag`` / ``r_diag`` parameterize
    the kernel; when not given they are read from the last row of
    ``sqp.q_diag`` / ``sqp.r_diag`` (pallas_riccati.py:687-708)."""
    if q_diag is None:
        q_diag = tuple(sqp.q_diag.reshape(-1)[-NX:].tolist())
    if r_diag is None:
        r_diag = tuple(sqp.r_diag.reshape(-1)[-NU:].tolist())
    return solve_parts(stage_parts(sqp), scfg, q_diag, r_diag)


def make_solver(scfg: SolverConfig = SolverConfig(), q_diag=None,
                r_diag=None):
    """:func:`solve_batched` as one callable ``solver(sqp)`` (the JAX
    ``make_solver`` is its vmappable form, pallas_riccati.py:782-806)."""

    def solver(sqp) -> QPSolution:
        return solve_batched(sqp, scfg, q_diag, r_diag)

    return solver


# --------------------------------------------------------------------------
# plain PyTorch version


def _dense_dynamics(s69, scal):
    """A = I + E and the stage-independent parts of B from the compact
    slices (builder.StageQPParts)."""
    bsz = s69.shape[0]
    eye = torch.eye(NX, dtype=s69.dtype, device=s69.device)
    a = eye.expand(bsz, NX, NX).clone()
    a[:, 0:3, 6:9] = s69
    for r in range(3):
        a[:, 3 + r, 9 + r] = scal[:, 0]
    a[:, 11, 12] = scal[:, 1]
    return a


def _dense_input(b69, scal):
    bsz = b69.shape[0]
    bm = torch.zeros((bsz, NX, NU), dtype=b69.dtype, device=b69.device)
    bm[:, 6:9, :] = b69
    for a in range(3):
        bm[:, 9 + a, a] = scal[:, 2]
        bm[:, 9 + a, 3 + a] = scal[:, 2]
    return bm


def _cholesky(re):
    """Lower Cholesky of (B, n, n) reading the lower triangle only, with the
    kernel's pivot floor sqrt(max(pivot, 1e-30)); returns (L, 1/diag)."""
    n = re.shape[-1]
    ell = torch.zeros_like(re)
    rinv = torch.empty(re.shape[:-1], dtype=re.dtype, device=re.device)
    for j in range(n):
        lj = ell[:, j, :j]
        ljj = torch.sqrt(torch.clamp(re[:, j, j] - (lj * lj).sum(-1),
                                     min=1e-30))
        rj = 1.0 / ljj
        ell[:, j, j] = ljj
        rinv[:, j] = rj
        if j + 1 < n:
            v = re[:, j + 1:, j] - (ell[:, j + 1:, :j] * lj[:, None, :]).sum(-1)
            ell[:, j + 1:, j] = v * rj[:, None]
    return ell, rinv


def _forward_sub(ell, rinv, x):
    """L^-1 x row by row; x (B, n, m) is overwritten."""
    for i in range(x.shape[1]):
        if i:
            x[:, i] -= (ell[:, i, :i, None] * x[:, :i]).sum(1)
        x[:, i] *= rinv[:, i, None]
    return x


def _back_sub(ell, rinv, x):
    """L^-T x row by row; x (B, n, m) is overwritten."""
    n = x.shape[1]
    for i in range(n - 1, -1, -1):
        if i + 1 < n:
            x[:, i] -= (ell[:, i + 1:, i, None] * x[:, i + 1:]).sum(1)
        x[:, i] *= rinv[:, i, None]
    return x


def solve_parts_plain(parts, scfg: SolverConfig, q_diag, r_diag
                      ) -> QPSolution:
    """The kernel's algorithm in batched PyTorch ops (float32 or float64)."""
    s69, scal, b69, umask, x0, xd, cm, lb, ub = parts
    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]

    q2_l, r2_l, r2reg_l = _weights(scfg, q_diag, r_diag)
    q2, r2, r2reg = [constant(('fused_riccati_weights', tuple(v)), v, x0)
                     for v in (q2_l, r2_l, r2reg_l)]
    q2_mat = torch.diag(q2)
    r2reg_mat = torch.diag(r2reg)
    eps = torch.finfo(dtype).eps
    polish = scfg.polish_rounds > 0
    mu_floor = 0.0 if polish else max(1e-14, 10.0 * eps)
    s_floor = 10.0 * eps
    d_cap = 0.1 / eps
    sl_cap = 1e8
    sigma, frac = scfg.sigma_fixed, scfg.frac_to_boundary
    big = scfg.big_threshold
    inf = constant('inf', float('inf'), x0)

    a = _dense_dynamics(s69, scal)
    bmat = _dense_input(b69, scal)
    at = a.transpose(1, 2)
    lr = constant('fused_riccati_LR', LR, x0, dtype=torch.int64)
    ur = constant('fused_riccati_UR', UR, x0, dtype=torch.int64)

    mask_l = lb > -big
    mask_u = ub < big
    lb_c = torch.where(mask_l, lb, 0.0)
    ub_c = torch.where(mask_u, ub, 0.0)
    mlr, mur = mask_l[..., lr], mask_u[..., ur]
    flr, fur = mlr.to(dtype), mur.to(dtype)
    lb_r, ub_r = lb_c[..., lr], ub_c[..., ur]
    n_act = torch.clamp(flr.sum((1, 2)) + fur.sum((1, 2)), min=1.0)
    cmt = cm.transpose(1, 2)

    def apply_c(u):                   # (B,H,NU) -> (B,H,NC)
        return u @ cmt

    def apply_ct(y):                  # (B,H,NC) -> (B,H,NU)
        return y @ cm

    def full_rows(x_l, x_u):
        out = torch.zeros(x_l.shape[:-1] + (NC,), dtype=dtype, device=dev)
        out[..., lr] = x_l
        out[..., ur] += x_u
        return out

    def rollout(u):
        x = x0
        xs = []
        for k in range(H):
            x = (a @ x[..., None])[..., 0] + (
                bmat @ (umask[:, k] * u[:, k])[..., None])[..., 0]
            xs.append(x)
        return torch.stack(xs, dim=1)

    def newton_dir(d_row, q_lin, r_lin):
        p_mat = q2_mat.expand(bsz, NX, NX)
        p_vec = q_lin[:, H - 1]
        ks, kffs = [None] * H, [None] * H
        for k in range(H - 1, -1, -1):
            bk = bmat * umask[:, k, None, :]                       # (B,NX,NU)
            re = (cmt * d_row[:, k, None, :]) @ cm + r2reg_mat     # C^T D C + R
            bp = bk.transpose(1, 2) @ p_mat                        # (B,NU,NX)
            re = re + bp @ bk
            ell, rinv = _cholesky(re)
            g = bp @ a
            beta = (bk.transpose(1, 2) @ p_vec[..., None]) + r_lin[:, k, :, None]
            wz = _forward_sub(ell, rinv, torch.cat([g, beta], dim=-1))
            w, z = wz[..., :NX], wz[..., NX]
            p_vec = (at @ p_vec[..., None])[..., 0] - (
                w.transpose(1, 2) @ z[..., None])[..., 0]
            if k >= 1:
                p_vec = p_vec + q_lin[:, k - 1]
            p_new = at @ p_mat @ a - w.transpose(1, 2) @ w + q2_mat
            low = torch.tril(p_new)
            p_mat = low + torch.tril(p_new, -1).transpose(1, 2)
            kk = _back_sub(ell, rinv, wz)
            ks[k], kffs[k] = kk[..., :NX], kk[..., NX]
        dx = torch.zeros_like(x0)
        dus = []
        for k in range(H):
            du = -((ks[k] @ dx[..., None])[..., 0] + kffs[k])
            dus.append(du)
            dx = (a @ dx[..., None])[..., 0] + (
                bmat @ (umask[:, k] * du)[..., None])[..., 0]
        return torch.stack(dus, dim=1)

    # ---- scale-aware start from the unconstrained solution ----
    zero_u = torch.zeros((bsz, H, NU), dtype=dtype, device=dev)
    q_lin0 = (rollout(zero_u) - xd) * q2
    u_unc = newton_dir(torch.zeros((bsz, H, NC), dtype=dtype, device=dev),
                       q_lin0, zero_u)
    cu0 = apply_c(u_unc)
    sh_l = torch.where(mlr, cu0[..., lr] - lb_r, 1.0)
    sh_u = torch.where(mur, ub_r - cu0[..., ur], 1.0)
    s_min = torch.minimum(torch.where(mlr, sh_l, inf).amin((1, 2)),
                          torch.where(mur, sh_u, inf).amin((1, 2)))
    shift = (scfg.init_slack + torch.clamp(-1.5 * s_min, min=0.0))[:, None, None]
    s_l = torch.where(mlr, sh_l + shift, 1.0)
    s_u = torch.where(mur, sh_u + shift, 1.0)
    lam_l = torch.where(mlr, scfg.init_dual / s_l, 0.0)
    lam_u = torch.where(mur, scfg.init_dual / s_u, 0.0)
    u = zero_u

    def clip(x):
        return torch.clamp(x, 0.0, sl_cap)

    for _ in range(scfg.iterations):
        cu = apply_c(u)
        cu_l, cu_u = cu[..., lr], cu[..., ur]
        q_lin = (rollout(u) - xd) * q2
        r_pl = torch.where(mlr, cu_l - lb_r - s_l, 0.0)
        r_pu = torch.where(mur, ub_r - cu_u - s_u, 0.0)
        inv_sl = 1.0 / torch.clamp(s_l, min=s_floor)
        inv_su = 1.0 / torch.clamp(s_u, min=s_floor)
        d_l = torch.where(mlr, torch.clamp(lam_l * inv_sl, max=d_cap), 0.0)
        d_u = torch.where(mur, torch.clamp(lam_u * inv_su, max=d_cap), 0.0)
        mu = ((s_l * lam_l * flr).sum((1, 2))
              + (s_u * lam_u * fur).sum((1, 2))) / n_act
        smu = (sigma * mu)[:, None, None]
        tls = torch.where(mlr, smu * inv_sl, 0.0)
        tus = torch.where(mur, smu * inv_su, 0.0)
        # C^T ((lam_u - lam_l) + v): the (lam_u - lam_l) terms cancel
        arg_l = d_l * r_pl - tls
        arg_u = tus - d_u * r_pu
        r_lin = r2 * u + apply_ct(full_rows(arg_l, arg_u))

        du = newton_dir(full_rows(d_l, d_u), q_lin, r_lin)
        cdu = apply_c(du)
        t_l = cdu[..., lr] + r_pl
        t_u = -cdu[..., ur] + r_pu
        ds_l = torch.where(mlr, t_l, 0.0)
        ds_u = torch.where(mur, t_u, 0.0)
        dl_l = torch.where(mlr, tls - lam_l - d_l * t_l, 0.0)
        dl_u = torch.where(mur, tus - lam_u - d_u * t_u, 0.0)

        # primal step through the slack reciprocals (rate form)
        rate_p = torch.maximum(
            torch.where(mlr & (ds_l < 0), -ds_l * inv_sl, 0.0).amax((1, 2)),
            torch.where(mur & (ds_u < 0), -ds_u * inv_su, 0.0).amax((1, 2)))
        a_p = (frac / torch.clamp(rate_p, min=frac))[:, None, None]
        ratio = torch.minimum(
            torch.where(mlr & (dl_l < 0),
                        lam_l / torch.clamp(-dl_l, min=1e-30), inf).amin((1, 2)),
            torch.where(mur & (dl_u < 0),
                        lam_u / torch.clamp(-dl_u, min=1e-30), inf).amin((1, 2)))
        a_d = torch.clamp(frac * ratio, max=1.0)[:, None, None]

        finite = (torch.isfinite(du).all(2).all(1)
                  & (torch.isfinite(ds_l) & torch.isfinite(dl_l)).all(2).all(1)
                  & (torch.isfinite(ds_u) & torch.isfinite(dl_u)).all(2).all(1))
        skip = ((mu < mu_floor) | ~finite)[:, None, None]
        u = torch.where(skip, u, u + a_p * du)
        s_l = torch.where(skip | ~mlr, s_l, clip(s_l + a_p * ds_l))
        s_u = torch.where(skip | ~mur, s_u, clip(s_u + a_p * ds_u))
        lam_l = torch.where(skip | ~mlr, lam_l, clip(lam_l + a_d * dl_l))
        lam_u = torch.where(skip | ~mur, lam_u, clip(lam_u + a_d * dl_u))

    # side -> full-row signed multipliers for the polish and the residuals
    lam_row = full_rows(-lam_l, lam_u)

    if polish:
        # ---- primal-dual active-set polish (pallas_riccati.py:542-610) ----
        # The interior point's d_cap/s_floor clamps stall it a few mN from
        # the optimum.  Each round estimates the active set from the sign of
        # nu + rho (Cu - b), solves the equality-constrained problem by an
        # augmented Lagrangian (polish_iters Newton solves at penalty rho,
        # the same newton_dir with d = rho * act), and re-estimates; the
        # best round by a KKT merit is kept, and a lane is accepted only at
        # a small merit, else it keeps the interior-point iterate.  Rows with
        # lb == ub (the swing legs' zero rows) stay active always.
        rho = scfg.polish_rho
        fl, fu = mask_l.to(dtype), mask_u.to(dtype)
        feq = fl * fu * (ub_c - lb_c < 1e-12).to(dtype)

        def estimate(nu_e, cu_e):
            t_u = nu_e + rho * (cu_e - ub_c)
            t_l = -nu_e + rho * (lb_c - cu_e)
            a_u = torch.maximum(fu * (t_u > 0).to(dtype), feq)
            a_l = torch.maximum(fl * (t_l > 0).to(dtype) * (1.0 - a_u), feq)
            return a_l, a_u

        a_l, a_u = estimate(lam_row, apply_c(u))
        nu = torch.maximum(a_l, a_u) * lam_row
        u_p, u_b, nu_b = u, u, nu
        bad_b = inf.expand(bsz)
        for t in range(scfg.polish_rounds * scfg.polish_iters):
            act = torch.maximum(a_l, a_u)
            # lower-active (and eq) rows target lb, upper-active rows ub
            low = torch.maximum(a_l * (1.0 - a_u), feq)
            bnd = low * lb_c + (1.0 - low) * a_u * ub_c
            q_lin = (rollout(u_p) - xd) * q2
            viol = act * (apply_c(u_p) - bnd)
            r_lin = r2 * u_p + apply_ct(nu + rho * viol)
            du = newton_dir(rho * act, q_lin, r_lin)
            fin = torch.isfinite(du).all(2).all(1)[:, None, None]
            u_p = torch.where(fin, u_p + du, u_p)
            cu_p = apply_c(u_p)
            nu = act * (nu + rho * (cu_p - bnd))
            if (t + 1) % scfg.polish_iters:
                continue
            # round end: merit = max(primal violation, wrong-sign
            # multiplier / 10), best of rounds, then the next active set
            bad_p = torch.maximum(fl * (lb_c - cu_p),
                                  fu * (cu_p - ub_c)).amax((1, 2))
            wrong = torch.maximum(
                a_u * (1.0 - feq) * torch.clamp(-nu, min=0.0),
                low * (1.0 - feq) * torch.clamp(nu, min=0.0)).amax((1, 2))
            bad_r = torch.where(torch.isfinite(u_p).all(2).all(1),
                                torch.maximum(bad_p, 0.1 * wrong), inf)
            better = (bad_r < bad_b)[:, None, None]
            u_b = torch.where(better, u_p, u_b)
            nu_b = torch.where(better, nu, nu_b)
            bad_b = torch.minimum(bad_r, bad_b)
            a_l, a_u = estimate(nu, cu_p)
        ok = ((bad_b <= 10.0 * scfg.polish_tol)
              & torch.isfinite(u_b).all(2).all(1))[:, None, None]
        u = torch.where(ok, u_b, u)
        lam_row = torch.where(ok, nu_b, lam_row)

    # ---- final residuals ----
    cu = apply_c(u)
    q_lin = (rollout(u) - xd) * q2
    ct_dl = apply_ct(lam_row)
    nu = q_lin[:, H - 1]
    r_d_max = torch.zeros(bsz, dtype=dtype, device=dev)
    for k in range(H - 1, -1, -1):
        bt_nu = (bmat.transpose(1, 2) @ nu[..., None])[..., 0] * umask[:, k]
        r_d_k = r2 * u[:, k] + bt_nu + ct_dl[:, k]
        r_d_max = torch.maximum(r_d_max, r_d_k.abs().amax(-1))
        if k >= 1:
            nu = (at @ nu[..., None])[..., 0] + q_lin[:, k - 1]
    r_pl = torch.where(mask_l, torch.clamp(lb_c - cu, min=0.0), 0.0)
    r_pu = torch.where(mask_u, torch.clamp(cu - ub_c, min=0.0), 0.0)
    mu = ((s_l * lam_l * flr).sum((1, 2))
          + (s_u * lam_u * fur).sum((1, 2))) / n_act
    r_prim = torch.maximum(r_pl.amax((1, 2)), r_pu.amax((1, 2)))
    return QPSolution(u=u.reshape(bsz, H * NU), mu=mu, r_dual=r_d_max,
                      r_prim=r_prim)


# --------------------------------------------------------------------------
# the CUDA kernels


def kernel_attributes(kernel: str = 'warp'):
    """What cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor report for a compiled
    kernel: ``'warp'`` (the interior point alone) or ``'polish'`` (with the
    polish)."""
    if kernel not in ('warp', 'polish'):
        raise ValueError(f"kernel is 'warp' or 'polish', not {kernel!r}")
    vals = [ctypes.c_int() for _ in range(6)]
    FUSED.call('fused_riccati_warp_attributes', int(kernel == 'polish'),
               *[ctypes.byref(v) for v in vals])
    regs, local, static, dynamic, threads, blocks = [v.value for v in vals]
    return dict(registers=regs, local_bytes=local, static_smem_bytes=static,
                dynamic_smem_bytes=dynamic, threads_per_block=threads,
                blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32)


_SHAPES = dict(s69=(3, 3), scal=(3,), b69=(3, NU), u_mask=(H, NU), x0=(NX,),
               xd=(H, NX), c_block=(NC, NU), lb=(H, NC), ub=(H, NC))


def check_parts(parts):
    """Raise on anything the kernel does not take: float32, one CUDA
    device, the h=10 / nx=13 / nu=12 / nc=16 shapes, one batch size."""
    bsz = parts.x0.shape[0]
    dev = parts.x0.device
    fields = list(zip(parts._fields, parts))
    for name, t in fields:
        if t.dtype != torch.float32:
            raise TypeError(f'fused_riccati: {name} must be float32, '
                            f'got {t.dtype}')
    for name, t in fields:
        if tuple(t.shape) != (bsz,) + _SHAPES[name]:
            raise ValueError(
                f'fused_riccati: {name} has shape {tuple(t.shape)}, the '
                f'kernel takes {(bsz,) + _SHAPES[name]} (h={H}, nx={NX}, '
                f'nu={NU}, nc={NC})')
    for name, t in fields:
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'fused_riccati: {name} on {t.device}, all '
                             f'parts must be on one CUDA device')


def solve_parts_cuda(parts, scfg: SolverConfig, q_diag, r_diag
                     ) -> QPSolution:
    """Check, copy to batch-minor and launch on the current stream, no
    synchronisation: ``fused_riccati_warp_kernel<true>`` when
    ``polish_rounds > 0`` (counted in ``polish_launches``), else
    ``<false>`` (``launches``)."""
    check_parts(parts)
    q2, r2, r2reg = _weights(scfg, q_diag, r_diag)
    prm = FusedRiccatiParams(
        (ctypes.c_float * NX)(*q2), (ctypes.c_float * NU)(*r2),
        (ctypes.c_float * NU)(*r2reg), scfg.sigma_fixed,
        scfg.frac_to_boundary, scfg.big_threshold, scfg.init_slack,
        scfg.init_dual, int(scfg.iterations), int(scfg.polish_rounds),
        int(scfg.polish_iters), scfg.polish_rho, scfg.polish_tol)
    bsz = parts.x0.shape[0]
    dev = parts.x0.device
    # batch-minor copies: element-major, scenario-minor
    ins = [t.reshape(bsz, -1).t().contiguous() for t in parts]
    u_t = torch.empty((H * NU, bsz), dtype=torch.float32, device=dev)
    stats_t = torch.empty((3, bsz), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in ins] + [u_t.data_ptr(), stats_t.data_ptr()]
    FUSED.launch('fused_riccati_warp_solve', dev, *ptrs, bsz,
                 ctypes.byref(prm),
                 counted=('polish_launches' if scfg.polish_rounds > 0
                          else 'launches',))
    stats = stats_t.t()
    return QPSolution(u=u_t.t().contiguous(), mu=stats[:, 0],
                      r_dual=stats[:, 1], r_prim=stats[:, 2])


def polish_counts(device=None) -> tuple[int, int]:
    """(lanes polished, lanes whose polish was rejected) by
    ``fused_riccati_warp_kernel<true>`` on ``device`` (default: the current
    card) since the library was loaded, as the kernel counts them: every
    launch, graph warm-ups and replays alike, so their ratio is the fallback
    rate.  Synchronises the card: never call it on a timed path.  (0, 0)
    while the library is not loaded."""
    if FUSED.handle is None:
        return 0, 0
    out = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        FUSED.call('fused_riccati_warp_polish_counts', out)
    return out[0], out[1]


# --------------------------------------------------------------------------
# work of one solve, counted from csrc/fused_riccati_warp.cu


def bytes_per_scenario():
    """Bytes one solve must move: every input read once, u and stats
    written once."""
    n_in = sum(int(torch.tensor(s).prod()) for s in _SHAPES.values())
    return 4 * (n_in + H * NU + 3)


def op_count(iterations: int, polish_steps: int = 0):
    """FP32 operations of one solve, per scenario, counted from the kernel
    source: 'flop' counts each multiply and each add (an FMA is 2),
    divides and square roots are counted apart.  The dual-step ratio
    divides, taken only on rows whose dual direction is negative, are left
    out, so the count is a lower bound of the kernel's work.
    ``polish_steps`` = polish_rounds * polish_iters more Riccati solves,
    each with its rollout, two C u products, the row targets (7 operations
    a row), C^T, the step and the multiplier update (4 a row); the merit
    and set estimate at the round ends are left out."""
    a_mul = 3 * 6 + 3 * 2 + 2                  # A x, sparse
    b_mul_add = NU + 3 * 2 * NU + 3 * 3        # B diag(m) u added to x
    bt_mul = 6 * 8 + 6 * 6                     # diag(m) B^T p
    rollout = H * (a_mul + b_mul_add + 2 * NX)  # with q_lin
    c_mul = NC * (2 * NU - 1)                  # C u, one stage
    ct_mul = NU * (2 * NC - 1) + 2 * NU        # r2 u + C^T y, one stage

    stage = 0
    stage += 2 * 21 * 8 * 3 + NU               # C^T D C leg blocks + R
    stage += 6 * NX * 8 + 6 * NX * 6           # bp = diag(m) B^T P
    stage += 57 * 9 + 21 * 7                   # Re += bp B diag(m)
    stage += 2 * 66                            # Cholesky pivots
    stage += sum((NU - 1 - j) * (2 * j + 1) for j in range(NU))
    stage += NU * (2 + 3 * 6 + 3 * 2)          # G = bp A
    stage += bt_mul + NU                       # beta
    sub = 2 * (NX + 1) * 66 + (NX + 1) * NU    # one triangular solve
    stage += 2 * sub                           # forward and back
    stage += a_mul + NX * 2 * NU + NX          # p update
    stage += 2 * NX * a_mul                    # A^T P A
    stage += 91 * (2 * NU - 1) + 91 + NX       # - W^T W + diag(q2)
    fwd = NU * 2 * NX + a_mul + b_mul_add      # forward rollout, one stage
    newton = H * (stage + fwd)

    rows = H * (NU + 8)                        # one-sided rows per solve
    per_iter = (rollout + H * c_mul + rows * 6 + 2 + rows * 2
                + H * ct_mul + newton + H * c_mul + rows * 8
                + H * NU * 2 + rows * 4 * 2)
    start = rollout + newton + H * c_mul + rows * 3
    final = rollout + H * (bt_mul + ct_mul + NX + c_mul + 2 * NC) + rows * 3
    per_polish = (rollout + 2 * H * c_mul + H * NC * 7 + H * ct_mul + newton
                  + H * NU + H * NC * 4)
    return dict(
        flop=start + iterations * per_iter + polish_steps * per_polish + final,
        div=((iterations + 1 + polish_steps) * H * NU + rows
             + iterations * (rows + 1) + 1),
        sqrt=(iterations + 1 + polish_steps) * H * NU)
