"""Stage-wise Riccati interior point (port of ``hector/qp/riccati.py``).

The general stage solver of the MPC problem in optimal-control form:

    min  sum_{k=1..h} (x_k - xd_k)^T S (x_k - xd_k) + sum_k u_k^T alpha u_k
    s.t. x_{k+1} = A x_k + B_k u_k,  x_0 given,
         lb_k <= C u_k <= ub_k                    (input-only constraints)

Each interior-point iteration's Newton step is a backward Riccati sweep of
12x12 Cholesky factorizations plus a forward rollout; no 120-dim object is
formed.  Swing-leg stages mask B's columns (B_k = B diag(m_k)), which is the
reference's swing-variable elimination at static shape.  With Q = 2 S and
R = 2 alpha (plus the KKT regularization on R's diagonal) the stage problem
is an exact block elimination of the condensed QP of ``qp/pdip.py``.

It serves ``backend='riccati'`` and the reference's CPU default of
``'auto'`` (``hector/mpc.py:160-164``): the Mehrotra predictor-corrector
(``mehrotra=True``) or a fixed centering ``sigma_fixed``, the scale-aware
start, the skip rule with NaN quarantine, the active-set polish with its
best-of-rounds merit (``polish_rounds > 0``) and the adjoint-sweep dual
residual, as in the JAX solver.  The JAX package computes this module in
XLA, not in a Pallas kernel, so it runs as batched PyTorch ops on any
device; the ``lax.scan`` sweeps are Python loops over the horizon.

Each stage's 12x12 linear algebra: ``jnp.linalg.cholesky`` is
``torch.linalg.cholesky_ex``; JAX's ``jax.scipy.linalg.cho_solve`` (the
gain K and the feed-forward, two triangular solves each) is here L^-1,
formed once a stage and factor by one batched
``torch.linalg.solve_triangular`` against I (:func:`_factor`), and two
batched products a solve, L^-T (L^-1 rhs) (:func:`_cho_solve`).  It
agrees with the two triangular solves to float32 rounding and ran ahead of
them on an H100 (``profile_stage_solver.py`` times both in turns).  None
of these calls waits on the card: the factor's status stays a device
tensor, and the rest is cuBLAS's batched trsm and products
(``torch.cholesky_solve`` would read a status on the host at every call).
So a planning step under ``backend='riccati'`` is captured as a CUDA graph
like the other backends' (``runtime.GRAPH_BACKENDS``), and
:func:`make_solver` is the batch solve's compiled form.  A lane whose
Riccati matrix is not positive definite gets a NaN factor, as
``jnp.linalg.cholesky`` returns it (``torch.linalg.cholesky`` would raise
on a CPU tensor and synchronise on a CUDA one); its L^-1 and its solves
are NaN, and the skip rule then keeps that lane's iterate and leaves its
neighbours alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constant, graph
from ..config import SolverConfig
from .fused_riccati import QPSolution


class StageQPData(NamedTuple):
    """A batch of MPC problems in stage form; built by
    ``qp.builder.build_stage_qp``."""

    a_dt: torch.Tensor     # (B, 13, 13) discrete dynamics Acd = I + dt A
    b_dt: torch.Tensor     # (B, 13, 12) discrete input map Bcd = dt B
    u_mask: torch.Tensor   # (B, h, 12) stance-variable mask per stage
    x0: torch.Tensor       # (B, 13) initial state
    xd: torch.Tensor       # (B, h, 13) reference states for x_1..x_h
    q_diag: torch.Tensor   # (13,) or (B, 13) state weights S (13th entry 0)
    r_diag: torch.Tensor   # (12,) or (B, 12) input weights alpha
    c_block: torch.Tensor  # (B, 16, 12) per-stage constraint rows
    lb: torch.Tensor       # (B, h, 16)
    ub: torch.Tensor       # (B, h, 16)


def _mv(m, v):
    """(B, i, j) @ (B, j) -> (B, i)."""
    return (m @ v[..., None])[..., 0]


def _mtv(m, v):
    """(B, j, i)^T @ (B, j) -> (B, i)."""
    return (m.transpose(-1, -2) @ v[..., None])[..., 0]


def _cholesky(re):
    """Lower Cholesky factor of each lane's symmetrized matrix (as
    ``jnp.linalg.cholesky``); NaN on a lane that is not positive definite."""
    ell, info = torch.linalg.cholesky_ex(0.5 * (re + re.transpose(-1, -2)))
    return torch.where((info == 0)[:, None, None], ell, float('nan'))


def _factor(re):
    """L^-1 for the lower Cholesky factor L of each lane's symmetrized
    matrix (:func:`_cholesky`): one batched triangular solve against I;
    NaN on a lane that is not positive definite."""
    ell = _cholesky(re)
    eye = torch.eye(ell.shape[-1], dtype=ell.dtype, device=ell.device)
    return torch.linalg.solve_triangular(ell, eye.expand_as(ell),
                                         upper=False)


def _cho_solve(linv, rhs):
    """(L L^T)^-1 rhs = L^-T (L^-1 rhs) from :func:`_factor`'s L^-1, as
    ``jax.scipy.linalg.cho_solve`` computes it from L: (B, 12, 12) and
    (B, 12, m)."""
    return linv.transpose(-1, -2) @ (linv @ rhs)


def solve_batched(sqp: StageQPData, scfg: SolverConfig = SolverConfig()
                  ) -> QPSolution:
    """Solve a batch of stage-form MPC QPs (leading batch dim on every field
    but the weights, which may be unbatched).  Returns the dense solver's
    ``QPSolution`` with u flattened to (B, 12h)."""
    a, b, u_mask, x0, xd, q_diag, r_diag, c_blk, lb, ub = sqp
    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]
    h = lb.shape[-2]

    big = scfg.big_threshold
    mask_l = lb > -big
    mask_u = ub < big
    fl, fu = mask_l.to(dtype), mask_u.to(dtype)
    n_act = torch.clamp(mask_l.sum((1, 2)) + mask_u.sum((1, 2)),
                        min=1).to(dtype)
    lb_c = torch.where(mask_l, lb, 0.0)
    ub_c = torch.where(mask_u, ub, 0.0)

    # build_stage_qp hands the weights as device tensors (constant), so
    # these copy nothing from the host
    q2 = (2.0 * torch.as_tensor(q_diag, dtype=dtype, device=dev)
          ).expand(bsz, 13)
    r2 = (2.0 * torch.as_tensor(r_diag, dtype=dtype, device=dev)
          ).expand(bsz, 12)
    q2_mat = torch.diag_embed(q2)                         # (B, 13, 13)
    # the regularization enters only the Riccati matrix, not the gradient
    r2_mat = torch.diag_embed(r2 + scfg.kkt_reg)          # (B, 12, 12)

    # per-stage masked input map B_k = B diag(mask_k), (B, h, 13, 12)
    b_st = b[:, None, :, :] * u_mask[:, :, None, :]
    b_k = [b_st[:, k] for k in range(h)]

    eps = torch.finfo(dtype).eps
    # with the polish the interior point runs to its clamp-limited stall
    # point, where the polish identifies the active set
    mu_floor = 1e-9 if scfg.polish_rounds > 0 else max(1e-14, 10.0 * eps)
    s_floor = 10.0 * eps
    d_cap = 0.1 / eps
    sl_cap = 1e8
    inf = constant('inf', float('inf'), x0)

    def apply_c(u):                                       # (B,h,12)->(B,h,16)
        return torch.einsum('bij,bhj->bhi', c_blk, u)

    def apply_ct(y):                                      # (B,h,16)->(B,h,12)
        return torch.einsum('bij,bhi->bhj', c_blk, y)

    def rollout(u):
        """x_1..x_h from x_0 under u: (B, h, 12) -> (B, h, 13)."""
        x, xs = x0, []
        for k in range(h):
            x = _mv(a, x) + _mv(b_k[k], u[:, k])
            xs.append(x)
        return torch.stack(xs, 1)

    def factor(d_row):
        """Backward Riccati sweep over barrier row weights d_row (B, h, 16):
        per stage (L^-1, K, G)."""
        cdc = torch.einsum('bki,bhk,bkj->bhij', c_blk, d_row, c_blk)
        rq = cdc + r2_mat[:, None]                        # (B, h, 12, 12)
        p = q2_mat
        fac = [None] * h
        for k in range(h - 1, -1, -1):
            bp = b_k[k].transpose(-1, -2) @ p              # B^T P  (12, 13)
            linv = _factor(rq[:, k] + bp @ b_k[k])
            g = bp @ a                                     # (12, 13)
            k_gain = _cho_solve(linv, g)
            fac[k] = (linv, k_gain, g)
            if k > 0:                   # the P after stage 0 is never read
                p = (q2_mat + (a.transpose(-1, -2) @ p) @ a
                     - g.transpose(-1, -2) @ k_gain)
                p = 0.5 * (p + p.transpose(-1, -2))
        return fac

    def lqr_solve(fac, q_lin, r_lin):
        """Backward linear sweep and forward rollout: the Newton du
        (B, h, 12).  q_lin (B, h, 13): state-cost gradients at x_1..x_h;
        r_lin (B, h, 12): input-side linear terms."""
        p_vec = q_lin[:, h - 1]
        kffs = [None] * h
        for k in range(h - 1, -1, -1):
            linv, _, g = fac[k]
            beta = r_lin[:, k] + _mtv(b_k[k], p_vec)
            kffs[k] = _cho_solve(linv, beta[..., None])[..., 0]
            if k > 0:
                p_vec = (_mtv(a, p_vec) - _mtv(g, kffs[k])
                         + q_lin[:, k - 1])
        dx, dus = torch.zeros_like(x0), []
        for k in range(h):
            du = -(_mv(fac[k][1], dx) + kffs[k])
            dx = _mv(a, dx) + _mv(b_k[k], du)
            dus.append(du)
        return torch.stack(dus, 1)

    def alpha_max(s, ds, mask, frac):
        ratios = torch.where(mask & (ds < 0),
                             s / torch.clamp(-ds, min=1e-30), inf)
        return torch.clamp(frac * ratios.amin((1, 2)), max=1.0)    # (B,)

    def lane(x):
        return x[:, None, None]

    # --- scale-aware start (the dense solver's policy) ---
    zeros_u = torch.zeros((bsz, h, 12), dtype=dtype, device=dev)
    fac0 = factor(torch.zeros((bsz, h, 16), dtype=dtype, device=dev))
    q_lin0 = q2[:, None, :] * (rollout(zeros_u) - xd)
    cu0 = apply_c(lqr_solve(fac0, q_lin0, zeros_u))
    sh_l = torch.where(mask_l, cu0 - lb_c, 1.0)
    sh_u = torch.where(mask_u, ub_c - cu0, 1.0)
    s_min = torch.minimum(torch.where(mask_l, sh_l, inf).amin((1, 2)),
                          torch.where(mask_u, sh_u, inf).amin((1, 2)))
    shift = lane(scfg.init_slack + torch.clamp(-1.5 * s_min, min=0.0))
    s_l = torch.where(mask_l, sh_l + shift, 1.0)
    s_u = torch.where(mask_u, sh_u + shift, 1.0)
    lam_l = torch.where(mask_l, scfg.init_dual / s_l, 0.0)
    lam_u = torch.where(mask_u, scfg.init_dual / s_u, 0.0)
    u = zeros_u

    for _ in range(scfg.iterations):
        cu = apply_c(u)
        q_lin = q2[:, None, :] * (rollout(u) - xd)
        r_pl = torch.where(mask_l, cu - lb_c - s_l, 0.0)
        r_pu = torch.where(mask_u, ub_c - cu - s_u, 0.0)
        # one reciprocal per bound side: everything downstream multiplies,
        # the primal step sizes too
        inv_sl = 1.0 / torch.clamp(s_l, min=s_floor)
        inv_su = 1.0 / torch.clamp(s_u, min=s_floor)
        d_l = torch.where(mask_l, torch.clamp(lam_l * inv_sl, max=d_cap), 0.0)
        d_u = torch.where(mask_u, torch.clamp(lam_u * inv_su, max=d_cap), 0.0)
        mu = ((s_l * lam_l * fl).sum((1, 2))
              + (s_u * lam_u * fu).sum((1, 2))) / n_act

        fac = factor(d_l + d_u)

        def newton(tau_l, tau_u):
            v = (torch.where(mask_u, tau_u * inv_su, 0.0)
                 - torch.where(mask_l, tau_l * inv_sl, 0.0)
                 - (lam_u - lam_l) - d_u * r_pu + d_l * r_pl)
            r_lin = r2[:, None, :] * u + apply_ct((lam_u - lam_l) + v)
            du = lqr_solve(fac, q_lin, r_lin)
            cdu = apply_c(du)
            ds_l = torch.where(mask_l, cdu + r_pl, 0.0)
            ds_u = torch.where(mask_u, -cdu + r_pu, 0.0)
            dl_l = torch.where(
                mask_l, tau_l * inv_sl - lam_l - d_l * (cdu + r_pl), 0.0)
            dl_u = torch.where(
                mask_u, tau_u * inv_su - lam_u - d_u * (-cdu + r_pu), 0.0)
            return du, ds_l, dl_l, ds_u, dl_u

        if scfg.mehrotra:
            zero_tau = torch.zeros_like(s_l)
            _, dsl_a, dll_a, dsu_a, dlu_a = newton(zero_tau, zero_tau)
            a_p = lane(torch.minimum(alpha_max(s_l, dsl_a, mask_l, 1.0),
                                     alpha_max(s_u, dsu_a, mask_u, 1.0)))
            a_d = lane(torch.minimum(alpha_max(lam_l, dll_a, mask_l, 1.0),
                                     alpha_max(lam_u, dlu_a, mask_u, 1.0)))
            mu_aff = (((s_l + a_p * dsl_a) * (lam_l + a_d * dll_a) * fl
                       ).sum((1, 2))
                      + ((s_u + a_p * dsu_a) * (lam_u + a_d * dlu_a) * fu
                         ).sum((1, 2))) / n_act
            # the clamp passes a NaN ratio on, which then means sigma = 1
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                                0.0, 1.0)
            smu = lane(torch.nan_to_num(sigma, nan=1.0) * mu)
            tau_l = smu - dsl_a * dll_a
            tau_u = smu - dsu_a * dlu_a
        else:
            smu = lane(scfg.sigma_fixed * mu)
            tau_l = torch.where(mask_l, smu, 0.0)
            tau_u = torch.where(mask_u, smu, 0.0)

        du, ds_l, dl_l, ds_u, dl_u = newton(tau_l, tau_u)

        frac = scfg.frac_to_boundary
        # the primal step through the slack reciprocals:
        # min(1, frac min s/(-ds)) = frac / max(max (-ds)/s, frac)
        rate_p = torch.maximum(
            torch.where(mask_l & (ds_l < 0), -ds_l * inv_sl, 0.0).amax((1, 2)),
            torch.where(mask_u & (ds_u < 0), -ds_u * inv_su, 0.0).amax((1, 2)))
        a_p = lane(frac / torch.clamp(rate_p, min=frac))
        a_d = lane(torch.minimum(alpha_max(lam_l, dl_l, mask_l, frac),
                                 alpha_max(lam_u, dl_u, mask_u, frac)))

        finite = lane(torch.isfinite(du).all(2).all(1)
                      & (torch.isfinite(ds_l) & torch.isfinite(dl_l)
                         & torch.isfinite(ds_u) & torch.isfinite(dl_u)
                         ).all(2).all(1))
        a_p = torch.where(finite, a_p, 0.0)
        a_d = torch.where(finite, a_d, 0.0)

        skip = lane(mu < mu_floor) | ~finite
        u = torch.where(skip, u, u + a_p * du)
        s_l = torch.where(skip | ~mask_l, s_l,
                          torch.clamp(s_l + a_p * ds_l, 0.0, sl_cap))
        s_u = torch.where(skip | ~mask_u, s_u,
                          torch.clamp(s_u + a_p * ds_u, 0.0, sl_cap))
        lam_l = torch.where(skip | ~mask_l, lam_l,
                            torch.clamp(lam_l + a_d * dl_l, 0.0, sl_cap))
        lam_u = torch.where(skip | ~mask_u, lam_u,
                            torch.clamp(lam_u + a_d * dl_u, 0.0, sl_cap))
    lam_eff = lam_u - lam_l

    if scfg.polish_rounds > 0:
        u, lam_eff = _polish(u, lam_l, lam_u, mask_l, mask_u, lb_c, ub_c,
                             scfg, apply_c, apply_ct, rollout, factor,
                             lqr_solve, q2, r2, xd)

    # --- final residuals: the dual residual through the adjoint sweep ---
    cu = apply_c(u)
    q_lin = q2[:, None, :] * (rollout(u) - xd)
    nu = q_lin[:, h - 1]
    bt_nu = [None] * h
    for k in range(h - 1, -1, -1):
        bt_nu[k] = _mtv(b_k[k], nu)                       # nu_{k+1} per stage
        if k > 0:
            nu = _mtv(a, nu) + q_lin[:, k - 1]
    r_d = r2[:, None, :] * u + torch.stack(bt_nu, 1) + apply_ct(lam_eff)
    r_pl = torch.where(mask_l, torch.clamp(lb_c - cu, min=0.0), 0.0)
    r_pu = torch.where(mask_u, torch.clamp(cu - ub_c, min=0.0), 0.0)
    mu = ((s_l * lam_l * fl).sum((1, 2))
          + (s_u * lam_u * fu).sum((1, 2))) / n_act
    return QPSolution(
        u=u.reshape(bsz, h * 12), mu=mu, r_dual=r_d.abs().amax((1, 2)),
        r_prim=torch.maximum(r_pl.amax((1, 2)), r_pu.amax((1, 2))))


def _polish(u, lam_l, lam_u, mask_l, mask_u, lb_c, ub_c, scfg, apply_c,
            apply_ct, rollout, factor, lqr_solve, q2, r2, xd):
    """Primal-dual active-set polish of the interior-point iterate
    (riccati.py:326-397): each round estimates the active set from the sign
    of nu + rho (C u - b), solves the equality-constrained subproblem by
    ``polish_iters`` augmented-Lagrangian Newton steps at penalty rho, and
    re-estimates.  The best round by a KKT merit (max of the primal
    violation and a tenth of the wrong-sign multipliers) is kept on a lane
    only at merit <= 10 polish_tol; elsewhere the interior-point iterate
    stays.  Returns (u, the effective multipliers)."""
    dtype = u.dtype
    rho = scfg.polish_rho
    eq = mask_l & mask_u & (ub_c - lb_c < 1e-12)
    u_p = u
    nu = lam_u - lam_l
    cu_p = apply_c(u_p)
    act_u = (mask_u & (nu + rho * (cu_p - ub_c) > 0)) | eq
    act_l = (mask_l & (-nu + rho * (lb_c - cu_p) > 0) & ~act_u) | eq

    def viol_of(cu_v):
        return torch.maximum(torch.where(mask_l, lb_c - cu_v, 0.0),
                             torch.where(mask_u, cu_v - ub_c, 0.0)
                             ).amax((1, 2))

    def lane(x):
        return x[:, None, None]

    u_best, nu_best = u_p, nu
    bad_best = torch.full(u.shape[:1], float('inf'), dtype=dtype,
                          device=u.device)
    for _ in range(scfg.polish_rounds):
        act = act_l | act_u
        bnd = torch.where(act_l & ~act_u, lb_c, torch.where(act_u, ub_c, 0.0))
        nu = torch.where(act, nu, 0.0)
        fac_p = factor(rho * act.to(dtype))
        for _ in range(scfg.polish_iters):
            q_lin_p = q2[:, None, :] * (rollout(u_p) - xd)
            viol = torch.where(act, apply_c(u_p) - bnd, 0.0)
            r_lin_p = r2[:, None, :] * u_p + apply_ct(nu + rho * viol)
            du_p = lqr_solve(fac_p, q_lin_p, r_lin_p)
            fin = lane(torch.isfinite(du_p).all(2).all(1))
            u_p = torch.where(fin, u_p + du_p, u_p)
            nu = torch.where(act, nu + rho * (apply_c(u_p) - bnd), 0.0)
        cu_p = apply_c(u_p)
        wrong = torch.maximum(
            torch.where(act_u & ~eq, torch.clamp(-nu, min=0.0), 0.0),
            torch.where(act_l & ~act_u & ~eq, torch.clamp(nu, min=0.0), 0.0)
        ).amax((1, 2))
        bad_r = torch.where(torch.isfinite(u_p).all(2).all(1),
                            torch.maximum(viol_of(cu_p), 0.1 * wrong),
                            float('inf'))
        better = lane(bad_r < bad_best)
        u_best = torch.where(better, u_p, u_best)
        nu_best = torch.where(better, nu, nu_best)
        bad_best = torch.minimum(bad_r, bad_best)
        act_u = (mask_u & (nu + rho * (cu_p - ub_c) > 0)) | eq
        act_l = (mask_l & (-nu + rho * (lb_c - cu_p) > 0) & ~act_u) | eq
    # accept the best polished lane only if finite and within tolerance
    ok = lane((bad_best <= 10.0 * scfg.polish_tol)
              & torch.isfinite(u_best).all(2).all(1))
    return (torch.where(ok, u_best, u),
            torch.where(ok, nu_best, lam_u - lam_l))


def make_solver(scfg: SolverConfig = SolverConfig()):
    """``solve_batched`` with ``scfg`` bound, compiled: ``solver(sqp) ->
    QPSolution`` on a batch-first ``StageQPData`` (JAX's ``make_solver``,
    riccati.py:425-446, is the form that runs under ``jit``).

    The solve is a graph.StepGraph of one step (``solver.steps``): on the
    card it is captured as a CUDA graph at the first call for the QP's
    shapes, dtype and device and replayed by every later call; on the CPU
    the same runner runs it eagerly on its buffers.  What it returns is a
    copy that aliases no buffer of the runner.  Inside a capture (a step
    that holds this solve being recorded) it is ``solve_batched`` itself:
    captures do not nest, and the enclosing graph holds the solve."""

    def step(state, sqp, i):
        return state, solve_batched(sqp, scfg)

    steps = graph.StepGraph(step, 1)

    def solver(sqp: StageQPData) -> QPSolution:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return solve_batched(sqp, scfg)
        _, sol = steps((), sqp)
        return QPSolution(*[x[:, 0] for x in sol])

    solver.steps = steps
    return solver


def solve(sqp: StageQPData, scfg: SolverConfig = SolverConfig()
          ) -> QPSolution:
    """Solve one problem whose fields carry no batch dim: adds the batch
    dim and removes it again."""
    sol = solve_batched(StageQPData(*[torch.as_tensor(x)[None] for x in sqp]),
                        scfg)
    return QPSolution(*[x[0] for x in sol])
