"""The MPC problem of the reference: the condensed QP that the published
controller hands to qpOASES, built as SolverMPC.cpp builds it.

Transcribed from Hector_Simulation's ConvexMPC/SolverMPC.cpp (float64
throughout, a lane at a time in the batch dimension): the euler-rate map
``Rb.inverse()`` (:66-89), the continuous single-rigid-body dynamics with
foot moments ``ct_ss_mats`` (:311-331, the mass 9.0 of the call at :423),
Euler discretisation and condensing ``c2qp`` (:133-186, each power of A
by its own chain of products), the bounds (:460-482), the 16-row
constraint block (:485-550, with the right heel row's missing minus sign
at :544), the cost (:569-570) and the elimination of the variables and
rows of a leg in swing (:589-637).  The reduced problem keeps its full
size here: an eliminated variable is fixed at zero by the solver
(qp.solve) and an eliminated row is dropped, which is the reduced QP
with its answer scattered back (:700-733).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NX = 13


class Problem(NamedTuple):
    """min 1/2 u'Hu + g'u  s.t.  lb <= A u <= ub on the kept rows, with the
    variables not kept fixed at zero."""

    h: torch.Tensor        # (B, n, n)
    g: torch.Tensor        # (B, n)
    a: torch.Tensor        # (B, m, n)
    lb: torch.Tensor       # (B, m)
    ub: torch.Tensor       # (B, m)
    keep_v: torch.Tensor   # (B, n) bool
    keep_c: torch.Tensor   # (B, m) bool


def _skew(r):
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1)], -2)


def euler_rate_map(rpy):
    """``Rb.inverse()`` of SolverMPC.cpp:66-89 (it reads pitch and yaw)."""
    p, y = rpy[..., 1], rpy[..., 2]
    cy, sy, cp, sp = torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p)
    z, o = torch.zeros_like(p), torch.ones_like(p)
    rb = torch.stack([torch.stack([cy * cp, -sy, z], -1),
                      torch.stack([sy * cp, cy, z], -1),
                      torch.stack([-sp, z, o], -1)], -2)
    return torch.linalg.inv(rb)


def dynamics(i_world, mass, r_feet, r_yaw):
    """``ct_ss_mats``: continuous A (B, 13, 13), B (B, 13, 12) of the state
    [rpy, p, omega, v, g] and the input [f0, f1, m0, m1]."""
    bsz, dtype, dev = i_world.shape[0], i_world.dtype, i_world.device
    a = torch.zeros((bsz, NX, NX), dtype=dtype, device=dev)
    a[:, 0:3, 6:9] = r_yaw
    a[:, 3:6, 9:12] = torch.eye(3, dtype=dtype, device=dev)
    a[:, 11, 12] = -1.0
    b = torch.zeros((bsz, NX, 12), dtype=dtype, device=dev)
    i_inv = torch.linalg.inv(i_world)
    for leg in range(2):
        b[:, 6:9, 3 * leg:3 * leg + 3] = i_inv @ _skew(r_feet[:, leg])
        b[:, 9:12, 3 * leg:3 * leg + 3] = torch.eye(
            3, dtype=dtype, device=dev) / mass
    b[:, 6:9, 6:9] = i_inv
    b[:, 6:9, 9:12] = i_inv
    return a, b


def condense(a_ct, b_ct, dt, horizon):
    """``c2qp``: (A_qp (B, 13h, 13), B_qp (B, 13h, 12h)) of the Euler
    discretisation, each power of Acd its own product chain."""
    eye = torch.eye(NX, dtype=a_ct.dtype, device=a_ct.device).expand_as(a_ct)
    acd = eye + dt * a_ct
    bcd = dt * b_ct
    powers = [eye]
    for i in range(horizon):
        p = eye
        for _ in range(i + 1):
            p = p @ acd
        powers.append(p)
    bsz = a_ct.shape[0]
    a_qp = torch.cat(powers[1:], 1)
    b_qp = a_ct.new_zeros((bsz, NX * horizon, 12 * horizon))
    for i in range(horizon):
        for j in range(i + 1):
            b_qp[:, NX * i:NX * i + NX, 12 * j:12 * j + 12] = \
                powers[i - j] @ bcd
    return a_qp, b_qp


def constraint_block(r_foot, r_body, mpc):
    """The (B, 16, 12) block of SolverMPC.cpp:485-550; ``r_foot`` (B, 2,
    3, 3), ``r_body`` the body's rotation to the world (B, 3, 3)."""
    mu, lt, lh = mpc.mu_constraint, mpc.lt, mpc.lh
    bsz = r_body.shape[0]
    f = r_body.new_zeros((bsz, 16, 12))
    for leg in range(2):
        # R_foot^T R^T: a world vector into the foot's frame
        rl = r_foot[:, leg].transpose(-1, -2) @ r_body.transpose(-1, -2)
        r0, fc, mc = 8 * leg, 3 * leg, 6 + 3 * leg
        f[:, r0 + 0, fc:fc + 3] = f.new_tensor([-mu, 0.0, 1.0])
        f[:, r0 + 1, fc:fc + 3] = f.new_tensor([mu, 0.0, 1.0])
        f[:, r0 + 2, fc:fc + 3] = f.new_tensor([0.0, -mu, 1.0])
        f[:, r0 + 3, fc:fc + 3] = f.new_tensor([0.0, mu, 1.0])
        f[:, r0 + 4, mc:mc + 3] = rl[:, 0]
        f[:, r0 + 5, fc:fc + 3] = -lt * rl[:, 2]
        f[:, r0 + 5, mc:mc + 3] = rl[:, 1]
        f[:, r0 + 6, fc:fc + 3] = -lh * rl[:, 2]
        # the right leg's heel row keeps the reference's +M_vec
        f[:, r0 + 6, mc:mc + 3] = -rl[:, 1] if leg == 0 else rl[:, 1]
        f[:, r0 + 7, fc:fc + 3] = f.new_tensor([0.0, 0.0, 2.0])
    return f


def bounds(gait, mpc):
    """(lb, ub) (B, 16h) of SolverMPC.cpp:460-482; ``gait`` (B, h, 2)."""
    big = mpc.big_number
    lo = [0.0, 0.0, 0.0, 0.0, 0.0, -big, -big, 0.0]
    hi = [big, big, big, big, mpc.mx_bound, 0.0, 0.0, None]
    lbs, ubs = [], []
    for i in range(gait.shape[1]):
        for leg in range(2):
            for j in range(8):
                lbs.append(torch.full_like(gait[:, i, leg], lo[j]))
                ubs.append(mpc.f_max * gait[:, i, leg] if hi[j] is None
                           else torch.full_like(gait[:, i, leg], hi[j]))
    return torch.stack(lbs, -1), torch.stack(ubs, -1)


def _near_zero(x):
    return (x > -1e-4) & (x < 1e-4)


def eliminate(a, lb, ub):
    """SolverMPC.cpp:589-637 as written: a row whose two bounds are near
    zero and whose coefficient at column j is near 2 eliminates the
    variables j-2, j-1, j, j+4, j+5, j+6 and the 8 rows ending at cs, with
    cs = (j+4)/6*8-1 for even j and (j+1)/6*8+7 for odd j (integer
    division).  Returns (keep_v (B, n), keep_c (B, m))."""
    bsz, m, n = a.shape
    keep_v = torch.ones((bsz, n), dtype=torch.bool, device=a.device)
    keep_c = torch.ones((bsz, m), dtype=torch.bool, device=a.device)
    row = _near_zero(lb) & _near_zero(ub)
    hit = row[:, :, None] & _near_zero(a - 2.0)
    for i, j in hit.any(0).nonzero().tolist():
        lanes = hit[:, i, j]
        cs = (j + 4) // 6 * 8 - 1 if j % 2 == 0 else (j + 1) // 6 * 8 + 7
        for v in (j + 6, j + 5, j + 4, j - 2, j - 1, j):
            keep_v[:, v] &= ~lanes
        keep_c[:, cs - 7:cs + 1] &= ~lanes[:, None]
    return keep_v, keep_c


def build(x0, traj, r_body, r_foot, r_feet, gait, i_body, mpc):
    """The QP of one solve.  x0 (B, 13) [rpy, p, omega, v, g]; traj (B, h,
    12) the reference trajectory; r_body (B, 3, 3) the body's rotation to
    the world; r_foot (B, 2, 3, 3); r_feet (B, 2, 3) the feet from the
    CoM in the world; gait (B, h, 2); i_body (3, 3)."""
    h = mpc.horizon
    i_world = r_body @ i_body @ r_body.transpose(-1, -2)
    a_ct, b_ct = dynamics(i_world, mpc.mass, r_feet, euler_rate_map(x0[:, :3]))
    a_qp, b_qp = condense(a_ct, b_ct, mpc.dt_mpc, h)
    s = x0.new_tensor(list(mpc.weights) + [0.0]).repeat(h)
    alpha = torch.diag(x0.new_tensor(mpc.alpha).repeat(h))
    x_d = torch.cat([traj, torch.zeros_like(traj[..., :1])], -1).reshape(
        x0.shape[0], NX * h)
    bs = b_qp.transpose(-1, -2) * s
    hm = 2.0 * (bs @ b_qp + alpha)
    g = 2.0 * (bs @ ((a_qp @ x0[..., None])[..., 0] - x_d)[..., None])[..., 0]
    block = constraint_block(r_foot, r_body, mpc)
    a = torch.block_diag(*[torch.ones(16, 12, dtype=torch.bool)] * h).to(
        x0.device)
    a = torch.where(a, block.repeat(1, h, h), 0.0)
    lb, ub = bounds(gait, mpc)
    keep_v, keep_c = eliminate(a, lb, ub)
    return Problem(hm, g, a, lb, ub, keep_v, keep_c)
