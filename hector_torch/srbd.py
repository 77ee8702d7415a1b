"""Single-rigid-body-with-moments dynamics and horizon condensing (port of
``hector/srbd.py``, after ``ConvexMPC/SolverMPC.cpp``).

- state x (13) = [rpy(3), p(3), omega_world(3), v(3), g] (SolverMPC.cpp:420)
- input u (12) = [F_L(3), F_R(3), M_L(3), M_R(3)]
- continuous A/B: ``ct_ss_mats`` (SolverMPC.cpp:312-331)
- Euler discretization and condensing into A_qp/B_qp: ``c2qp``
  (SolverMPC.cpp:133-193).

Every argument carries a leading batch dim B.  The powers of Acd are one
chain of h batched 13x13 products; the block-Toeplitz B_qp is assembled from
the h precomputed blocks.  These products lie outside any kernel and are
plain ``torch.matmul``.

Quirk kept: the MPC model mass is 9.0 (config.MPCConfig.mass), not the
robot's 13.856 (SolverMPC.cpp:423).
"""

from __future__ import annotations

import torch

from . import constant
from .math import skew, inv3


def _a_base():
    """The constant entries of A: dp/dt = v and the gravity column."""
    a = [[0.0] * 13 for _ in range(13)]
    for k in range(3):
        a[3 + k][9 + k] = 1.0
    a[11][12] = -1.0
    return a


def ct_dynamics(i_world, mass, r_feet, euler_rate):
    """Continuous-time (A (B, 13, 13), B (B, 13, 12)).

    i_world: (B, 3, 3); r_feet: (B, 2, 3) foot positions relative to the CoM
    (world frame); euler_rate: (B, 3, 3) omega_world -> rpy-rate map.  As
    ``ct_ss_mats``: both feet's moments go through I_world^-1 directly
    (columns 6:9 and 9:12), and gravity enters through A[11, 12] = -1 acting
    on the constant state x[12] = g.
    """
    bsz = i_world.shape[0]
    dtype, dev = i_world.dtype, i_world.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    a = constant('ct_dynamics_a', _a_base, i_world).expand(
        bsz, 13, 13).clone()
    a[:, 0:3, 6:9] = euler_rate

    i_inv = inv3(i_world)
    b = torch.zeros((bsz, 13, 12), dtype=dtype, device=dev)
    # angular acceleration from contact forces: I^-1 [r_i]x F_i
    b[:, 6:9, 0:3] = i_inv @ skew(r_feet[:, 0, :])
    b[:, 6:9, 3:6] = i_inv @ skew(r_feet[:, 1, :])
    # ... and from contact moments directly
    b[:, 6:9, 6:9] = i_inv
    b[:, 6:9, 9:12] = i_inv
    # linear acceleration
    eye_m = eye / mass
    b[:, 9:12, 0:3] = eye_m
    b[:, 9:12, 3:6] = eye_m
    return a, b


def condense(a_ct, b_ct, dt, horizon: int):
    """(A_qp (B, 13h, 13), B_qp (B, 13h, 12h)) from the Euler-discretized
    dynamics: Acd = I + dt A, Bcd = dt B (SolverMPC.cpp:145-146); A_qp block
    i = Acd^(i+1); B_qp block (i, j) = Acd^(i-j) Bcd for j <= i."""
    eye = torch.eye(13, dtype=a_ct.dtype, device=a_ct.device)
    acd = eye + dt * a_ct
    bcd = dt * b_ct

    # powers[k] = Acd^k, k = 0..horizon
    powers = [eye.expand_as(a_ct)]
    for _ in range(horizon):
        powers.append(powers[-1] @ acd)
    a_qp = torch.cat(powers[1:], dim=-2)

    # pb[k] = Acd^k Bcd
    pb = [bcd] + [powers[k] @ bcd for k in range(1, horizon)]
    zero = torch.zeros_like(bcd)
    rows = [torch.cat([pb[i - j] if j <= i else zero
                       for j in range(horizon)], dim=-1)
            for i in range(horizon)]
    b_qp = torch.cat(rows, dim=-2)
    return a_qp, b_qp
