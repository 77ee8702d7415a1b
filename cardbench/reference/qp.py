"""The reference's QP solver: a log-barrier method with Newton steps,
then an exact solve on the active set it finds, accepted lane by lane
only with a KKT certificate.

    min 1/2 u'Hu + g'u   s.t.   G u <= h   (the rows in ``mask``)

1. Barrier (Boyd and Vandenberghe, Convex Optimization, 11.3): from a
   strictly feasible start, minimise t f(u) - sum log(h - G u) by damped
   Newton steps with a backtracking line search, for t growing tenfold
   until the duality gap m/t is below 1e-8.
2. Crossover: the rows whose slack lies below t^-1/2 (their barrier
   multiplier 1/(t s) is larger than the slack) are taken as active; the
   equality-constrained QP on them is solved exactly through the Schur
   complement G H^-1 G'; rows that come out violated join the set and rows
   whose multiplier comes out negative leave it, for a few rounds.
3. Certificate: a lane's answer stands when every row holds to 1e-9 and
   every active multiplier is non-negative to 1e-9 of the largest;
   stationarity holds by construction.  H is positive definite, so the
   optimum is unique and a certified answer is it, to rounding.  A lane
   that is not certified keeps the barrier's answer and is counted.

Float64 throughout; nothing here is shared with the program's solvers
(a Mehrotra interior point and a Riccati interior point).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 1024        # lanes solved at once
GAP = 1e-8          # the barrier's last duality gap
TOL = 1e-9          # the certificate's tolerance


class Solution(NamedTuple):
    u: torch.Tensor           # (B, n)
    certified: torch.Tensor   # (B,) bool
    active: torch.Tensor      # (B,) rows active at the answer


def _phi(t, hm, g, gm, h, mask, u):
    """t f(u) - sum log s, +inf where a row's slack is not positive."""
    s = h - (gm @ u[..., None])[..., 0]
    f = 0.5 * (u * (hm @ u[..., None])[..., 0]).sum(-1) + (g * u).sum(-1)
    bad = (mask & (s <= 0)).any(-1)
    logs = torch.where(mask, torch.log(torch.where(mask & (s > 0), s, 1.0)),
                       0.0)
    return torch.where(bad, torch.inf, t * f - logs.sum(-1)), s


def _barrier(hm, g, gm, h, mask, u):
    m = mask.sum(-1).clamp(min=1).to(u.dtype)
    t = 1.0
    while True:
        stuck = torch.zeros_like(m, dtype=torch.bool)
        for _ in range(60):
            phi, s = _phi(t, hm, g, gm, h, mask, u)
            inv = torch.where(mask, 1.0 / s, 0.0)
            grad = t * ((hm @ u[..., None])[..., 0] + g) \
                + (gm.transpose(-1, -2) @ inv[..., None])[..., 0]
            hess = t * hm + gm.transpose(-1, -2) @ (gm * (inv * inv)[..., None])
            chol, info = torch.linalg.cholesky_ex(hess)
            d = -torch.cholesky_solve(grad[..., None], chol)[..., 0]
            d = torch.where((info == 0)[:, None], d, 0.0)
            dec = -(grad * d).sum(-1)
            # below this the decrement is lost in the rounding of phi
            moving = (dec > 1e-12 * (1.0 + phi.abs())) & ~stuck
            if not bool(moving.any()):
                break
            gd = (gm @ d[..., None])[..., 0]
            ratio = torch.where(mask & (gd > 0), s / gd, torch.inf)
            step = torch.clamp(0.99 * ratio.amin(-1), max=1.0)
            step = torch.where(moving, step, 0.0)
            for _ in range(30):
                trial, _ = _phi(t, hm, g, gm, h, mask, u + step[:, None] * d)
                ok = trial <= phi - 0.01 * step * dec
                if bool(ok.all()):
                    break
                step = torch.where(ok, step, 0.5 * step)
            stuck = stuck | ~ok
            step = torch.where(ok, step, 0.0)
            u = u + step[:, None] * d
        if bool((m / t).amax() < GAP):
            return u, t
        t *= 10.0


def _crossover(hm, g, gm, h, mask, u, t):
    """(u, certified, active rows) from the barrier's answer."""
    s = h - (gm @ u[..., None])[..., 0]
    active = mask & (s < t ** -0.5)
    # the barrier's multipliers, 1/(t s) >= 0: where the active rows are
    # dependent, the solve below takes its multipliers nearest to these
    lam_b = torch.where(active, 1.0 / (t * s), 0.0)
    chol = torch.linalg.cholesky(hm)
    y = torch.cholesky_solve(gm.transpose(-1, -2), chol)      # H^-1 G'
    w = torch.cholesky_solve(g[..., None], chol)[..., 0]      # H^-1 g
    schur = gm @ y
    rhs = -(gm @ w[..., None])[..., 0] - h
    jitter = 1e-13 * (1.0 + schur.diagonal(dim1=-2, dim2=-1).amax(-1))
    best, done = u, torch.zeros_like(mask[:, 0])
    n_active = torch.zeros_like(mask[:, 0], dtype=torch.long)
    for _ in range(12):
        a = active.to(u.dtype)
        mat = schur * a[:, :, None] * a[:, None, :] + torch.diag_embed(
            (1.0 - a) + jitter[:, None] * a)
        chol_a, info = torch.linalg.cholesky_ex(mat)
        lam = torch.cholesky_solve(((rhs + jitter[:, None] * lam_b) * a
                                    )[..., None], chol_a)[..., 0] * a
        x = -(w + (y @ lam[..., None])[..., 0])
        slack = h - (gm @ x[..., None])[..., 0]
        viol = torch.where(mask, -slack, -torch.inf).amax(-1)
        scale = 1.0 + lam.abs().amax(-1)
        worst = torch.where(active, lam, torch.inf).amin(-1)
        ok = (viol <= TOL) & (worst >= -TOL * scale) & (info == 0) & ~done
        best = torch.where(ok[:, None], x, best)
        n_active = torch.where(ok, active.sum(-1), n_active)
        done = done | ok
        if bool(done.all()):
            break
        active = (active & (lam >= -TOL * scale[:, None])) \
            | (mask & ~active & (slack < -TOL))
    return best, done, n_active


def solve(hm, g, gm, h, mask, keep_v, u0):
    """Solve the QPs of a batch; variables off ``keep_v`` are held at zero
    (their rows and columns of H become the identity's), rows off ``mask``
    are absent.  ``u0`` has to lie strictly inside every row."""
    outs = []
    for k in range(0, g.shape[0], BLOCK):
        sl = slice(k, k + BLOCK)
        kv = keep_v[sl]
        both = kv[:, :, None] & kv[:, None, :]
        eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
        hk = torch.where(both, hm[sl], eye)
        gk = torch.where(kv, g[sl], 0.0)
        gmk = torch.where(kv[:, None, :], gm[sl], 0.0)
        uk = torch.where(kv, u0[sl], 0.0)
        # a lane whose start is not strictly inside starts unconstrained;
        # the crossover's rounds and the certificate still hold it
        inside = ~(mask[sl] & (h[sl] - (gmk @ uk[..., None])[..., 0] <= 0)
                   ).any(-1)
        u, t = _barrier(hk, gk, gmk, h[sl], mask[sl] & inside[:, None], uk)
        outs.append(_crossover(hk, gk, gmk, h[sl], mask[sl], u, t))
    u, ok, n_active = (torch.cat(x) for x in zip(*outs))
    return Solution(u, ok, n_active)
