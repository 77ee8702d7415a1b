"""Batched fixed-iteration primal-dual interior point for the condensed
dense QP (port of ``hector/qp/pdip.py``).

Problem form (hector_torch/qp/builder.QPData):

    min 1/2 u^T H u + g^T u   s.t.   lb <= C u <= ub

with C block-diagonal: the same (16, 12) block per horizon step.  The KKT
normal matrix is H + C^T D C, where C^T D C is block-diagonal (12, 12) per
step, assembled with one small einsum and a static-index scatter.  A
Mehrotra predictor-corrector has a fixed iteration count and the same dense
linear algebra for every scenario: one factorization and two solves per
iteration.

Linear-algebra backends (``SolverConfig.backend``):

- ``'pallas'`` and ``'auto'``: the hand-written kernels of
  hector_torch/qp/chol.py on ``(B, n, n)``.  CUDA tensors launch them or
  raise; CPU tensors run their plain versions.
- ``'pallas_interpret'``: the plain versions on any device, in the
  batch-minor ``(n, n, B)`` layout of the TPU kernels (the counterpart of
  their interpret mode: same arithmetic, same layout).
- ``'xla'``: ``torch.linalg.cholesky_ex`` and ``solve_triangular`` on
  ``(B, n, n)``, what the JAX package computes under this name.  A caller
  must name it: nothing reaches it from the other backends.

Rows with bounds beyond ``big_threshold`` are one-sided or absent through
masks; rows the gait mask deactivates have both sides masked and are inert.

Two-sided-bound KKT derivation (per row; l/u = lower/upper side):
    s_l = Cu - lb >= 0,  s_u = ub - Cu >= 0,  duals lam_l, lam_u >= 0
    stationarity: H u + g - C^T lam_l + C^T lam_u = 0
    Newton step with target complementarity tau:
      d_lam_l = tau_l/s_l - lam_l - (lam_l/s_l) (C du + r_pl)
      d_lam_u = tau_u/s_u - lam_u - (lam_u/s_u) (-C du + r_pu)
    eliminating gives  (H + C^T D C) du = -r_d - C^T v  with
      D = lam_l/s_l + lam_u/s_u
      v = tau_u/s_u - tau_l/s_l - (lam_u - lam_l) - (lam_u/s_u) r_pu
          + (lam_l/s_l) r_pl
"""

from __future__ import annotations

import torch

from .. import constant, graph
from ..config import SolverConfig
from .builder import QPData
from .fused_riccati import QPSolution
from . import chol

BACKENDS = ('auto', 'pallas', 'pallas_interpret', 'xla')


def _block_indices(h: int, device):
    """(h, 12, 12) row and column index tensors addressing the per-step
    diagonal blocks of the (12h, 12h) KKT matrix."""
    step = torch.arange(h, device=device)[:, None, None] * 12
    r = step + torch.arange(12, device=device)[None, :, None]
    c = step + torch.arange(12, device=device)[None, None, :]
    return r.expand(h, 12, 12), c.expand(h, 12, 12)


def solve_batched(qp: QPData, scfg: SolverConfig = SolverConfig()
                  ) -> QPSolution:
    """Solve a batch of QPs; every ``QPData`` field has a leading batch dim."""
    h_mat, g_vec, c_block, lb, ub = qp
    dtype, dev = h_mat.dtype, h_mat.device
    bsz, n = g_vec.shape
    h = lb.shape[-2]
    backend = scfg.backend
    if backend not in BACKENDS:
        raise ValueError(f'pdip: backend {backend!r} is none of {BACKENDS}')
    if backend == 'auto':
        backend = 'pallas'

    big = scfg.big_threshold
    mask_l = lb > -big
    mask_u = ub < big
    fl, fu = mask_l.to(dtype), mask_u.to(dtype)
    n_act = torch.clamp(mask_l.sum((1, 2)) + mask_u.sum((1, 2)),
                        min=1).to(dtype)                   # (B,)
    lb_c = torch.where(mask_l, lb, 0.0)
    ub_c = torch.where(mask_u, ub, 0.0)

    ridx, cidx = _block_indices(h, dev)
    diag = torch.arange(n, device=dev)
    reg = scfg.kkt_reg

    eps = torch.finfo(dtype).eps
    mu_floor = max(1e-14, 10.0 * eps)
    s_floor = 10.0 * eps
    d_cap = 0.1 / eps
    sl_cap = 1e8                       # keeps s * lam finite in float32
    inf = constant('inf', float('inf'), h_mat)

    def apply_c(u):
        return torch.einsum('bij,bhj->bhi', c_block, u.reshape(bsz, h, 12))

    def apply_ct(y):
        return torch.einsum('bij,bhi->bhj', c_block, y).reshape(bsz, n)

    if backend == 'pallas_interpret':
        h_nnb = h_mat.permute(1, 2, 0).contiguous()        # (n, n, B) once

        def factor(d_row):
            blocks = torch.einsum('bki,bhk,bkj->hijb', c_block, d_row,
                                  c_block)
            m = h_nnb.clone()
            m[ridx, cidx, :] += blocks
            m[diag, diag, :] += reg
            return chol.cholesky_nnb_plain(m)

        def kkt_solve(ell, rhs):
            return chol.cholesky_solve_nnb_plain(ell, rhs.t()).t()
    else:
        def kkt_matrix(d_row):
            blocks = torch.einsum('bki,bhk,bkj->bhij', c_block, d_row,
                                  c_block)
            m = h_mat.clone()
            m[:, ridx, cidx] += blocks
            m[:, diag, diag] += reg
            return m

        if backend == 'pallas':
            def factor(d_row):
                return chol.cholesky_bnn(kkt_matrix(d_row))

            kkt_solve = chol.cholesky_solve_bnn
        else:
            def factor(d_row):
                # _ex: a lane that is not positive definite must not raise
                # for the batch; the quarantine below deals with it
                return torch.linalg.cholesky_ex(kkt_matrix(d_row)).L

            def kkt_solve(ell, rhs):
                y = torch.linalg.solve_triangular(ell, rhs[..., None],
                                                  upper=False)
                x = torch.linalg.solve_triangular(ell.transpose(-1, -2), y,
                                                  upper=True)
                return x[..., 0]

    def alpha_max(s, ds, mask, frac):
        ratios = torch.where(mask & (ds < 0),
                             s / torch.clamp(-ds, min=1e-30), inf)
        return torch.clamp(frac * ratios.amin((1, 2)), max=1.0)    # (B,)

    # scale-aware start: u0 = unconstrained minimizer, slacks shifted
    # strictly positive around it, duals perfectly centered at mu0
    l0 = factor(torch.zeros((bsz, h, 16), dtype=dtype, device=dev))
    cu0 = apply_c(kkt_solve(l0, -g_vec))
    sh_l = torch.where(mask_l, cu0 - lb_c, 1.0)
    sh_u = torch.where(mask_u, ub_c - cu0, 1.0)
    s_min = torch.minimum(torch.where(mask_l, sh_l, inf).amin((1, 2)),
                          torch.where(mask_u, sh_u, inf).amin((1, 2)))
    shift = (scfg.init_slack
             + torch.clamp(-1.5 * s_min, min=0.0))[:, None, None]
    s_l = torch.where(mask_l, sh_l + shift, 1.0)
    s_u = torch.where(mask_u, sh_u + shift, 1.0)
    lam_l = torch.where(mask_l, scfg.init_dual / s_l, 0.0)
    lam_u = torch.where(mask_u, scfg.init_dual / s_u, 0.0)
    u = torch.zeros_like(g_vec)
    frac = scfg.frac_to_boundary

    def h_times(u):
        return (h_mat @ u[..., None])[..., 0]

    def clip(x):
        return torch.clamp(x, 0.0, sl_cap)

    for _ in range(scfg.iterations):
        cu = apply_c(u)
        r_d = h_times(u) + g_vec + apply_ct(lam_u - lam_l)
        r_pl = torch.where(mask_l, cu - lb_c - s_l, 0.0)
        r_pu = torch.where(mask_u, ub_c - cu - s_u, 0.0)
        sl_safe = torch.clamp(s_l, min=s_floor)
        su_safe = torch.clamp(s_u, min=s_floor)
        d_l = torch.where(mask_l, torch.clamp(lam_l / sl_safe, max=d_cap),
                          0.0)
        d_u = torch.where(mask_u, torch.clamp(lam_u / su_safe, max=d_cap),
                          0.0)
        mu = ((s_l * lam_l * fl).sum((1, 2))
              + (s_u * lam_u * fu).sum((1, 2))) / n_act       # (B,)

        ell = factor(d_l + d_u)

        def newton(tau_l, tau_u):
            v = (torch.where(mask_u, tau_u / su_safe, 0.0)
                 - torch.where(mask_l, tau_l / sl_safe, 0.0)
                 - (lam_u - lam_l) - d_u * r_pu + d_l * r_pl)
            du = kkt_solve(ell, -(r_d + apply_ct(v)))
            cdu = apply_c(du)
            ds_l = torch.where(mask_l, cdu + r_pl, 0.0)
            ds_u = torch.where(mask_u, -cdu + r_pu, 0.0)
            dl_l = torch.where(
                mask_l, tau_l / sl_safe - lam_l - d_l * (cdu + r_pl), 0.0)
            dl_u = torch.where(
                mask_u, tau_u / su_safe - lam_u - d_u * (-cdu + r_pu), 0.0)
            return du, ds_l, dl_l, ds_u, dl_u

        zero_tau = torch.zeros_like(s_l)
        _, dsl_a, dll_a, dsu_a, dlu_a = newton(zero_tau, zero_tau)
        a_p = torch.minimum(alpha_max(s_l, dsl_a, mask_l, 1.0),
                            alpha_max(s_u, dsu_a, mask_u, 1.0))[:, None, None]
        a_d = torch.minimum(alpha_max(lam_l, dll_a, mask_l, 1.0),
                            alpha_max(lam_u, dlu_a, mask_u, 1.0))[:, None,
                                                                  None]
        mu_aff = (((s_l + a_p * dsl_a) * (lam_l + a_d * dll_a)
                   * fl).sum((1, 2))
                  + ((s_u + a_p * dsu_a) * (lam_u + a_d * dlu_a)
                     * fu).sum((1, 2))) / n_act
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)
        sigma = torch.where(torch.isnan(sigma), 1.0, sigma)

        smu = (sigma * mu)[:, None, None]
        du, ds_l, dl_l, ds_u, dl_u = newton(smu - dsl_a * dll_a,
                                            smu - dsu_a * dlu_a)

        a_p = torch.minimum(alpha_max(s_l, ds_l, mask_l, frac),
                            alpha_max(s_u, ds_u, mask_u, frac))[:, None, None]
        a_d = torch.minimum(alpha_max(lam_l, dl_l, mask_l, frac),
                            alpha_max(lam_u, dl_u, mask_u, frac))[:, None,
                                                                  None]

        # NaN quarantine: a lane whose Newton direction went non-finite
        # (degenerate or near-infeasible QP in float32) takes no step and
        # keeps its last good iterate instead of poisoning the batch
        finite = (torch.isfinite(du).all(1)
                  & (torch.isfinite(ds_l) & torch.isfinite(dl_l)
                     & torch.isfinite(ds_u) & torch.isfinite(dl_u)
                     ).all(2).all(1))
        skip = ((mu < mu_floor) | ~finite)[:, None, None]
        u = torch.where(skip[..., 0], u, u + a_p[..., 0] * du)
        s_l = torch.where(skip | ~mask_l, s_l, clip(s_l + a_p * ds_l))
        s_u = torch.where(skip | ~mask_u, s_u, clip(s_u + a_p * ds_u))
        lam_l = torch.where(skip | ~mask_l, lam_l, clip(lam_l + a_d * dl_l))
        lam_u = torch.where(skip | ~mask_u, lam_u, clip(lam_u + a_d * dl_u))

    cu = apply_c(u)
    r_d = h_times(u) + g_vec + apply_ct(lam_u - lam_l)
    r_pl = torch.where(mask_l, torch.clamp(lb_c - cu, min=0.0), 0.0)
    r_pu = torch.where(mask_u, torch.clamp(cu - ub_c, min=0.0), 0.0)
    mu = ((s_l * lam_l * fl).sum((1, 2))
          + (s_u * lam_u * fu).sum((1, 2))) / n_act
    return QPSolution(
        u=u, mu=mu, r_dual=r_d.abs().amax(1),
        r_prim=torch.maximum(r_pl.amax((1, 2)), r_pu.amax((1, 2))))


def make_solver(scfg: SolverConfig = SolverConfig()):
    """``solve_batched`` with ``scfg`` bound, compiled: ``solver(qp) ->
    QPSolution`` on a batch-first ``QPData`` (JAX's ``make_solver``,
    pdip.py:264-285, is the form that runs under ``jit``).

    The solve is a graph.StepGraph of one step (``solver.steps``): on the
    card it is captured as a CUDA graph at the first call for the QP's
    shapes, dtype and device and replayed by every later call; on the CPU
    the same runner runs it eagerly on its buffers.  What it returns is a
    copy that aliases no buffer of the runner.  Inside a capture (a step
    that holds this solve being recorded) it is ``solve_batched`` itself:
    captures do not nest, and the enclosing graph holds the solve."""

    def step(state, qp, i):
        return state, solve_batched(qp, scfg)

    steps = graph.StepGraph(step, 1)

    def solver(qp: QPData) -> QPSolution:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return solve_batched(qp, scfg)
        _, sol = steps((), qp)
        return QPSolution(*[x[:, 0] for x in sol])

    solver.steps = steps
    return solver


def solve(qp: QPData, scfg: SolverConfig = SolverConfig()) -> QPSolution:
    """Solve one QP whose fields carry no batch dim (tests, single
    scenarios): adds the batch dim and removes it again."""
    sol = solve_batched(QPData(*[x[None] for x in qp]), scfg)
    return QPSolution(*[x[0] for x in sol])
