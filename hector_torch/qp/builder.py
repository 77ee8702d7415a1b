"""Batched assembly of the MPC QP (port of ``hector/qp/builder.py``), in
its two forms.

The production path (``StageQPParts``, ``build_stage_parts``) builds only
the slices of the discrete dynamics that the fused Riccati solver reads
(hector_torch/qp/fused_riccati.py):

  s69  = a_dt[0:3, 6:9]          = dt * euler_rate
  scal = [a_dt[3,9], a_dt[11,12], b_dt[9,0]] = [dt, -dt, dt/mass]
  b69  = b_dt[6:9, :] = dt * [I^-1 [r0]x | I^-1 [r1]x | I^-1 | I^-1]

The condensed path (``QPData``, ``build_qp``) rebuilds ``solve_mpc``'s matrix
pipeline (SolverMPC.cpp:371-586) for the dense interior point
(hector_torch/qp/pdip.py):

  H = 2 (B~^T S B~ + Alpha_rep)        (SolverMPC.cpp:569)
  g = 2 B~^T S (A_qp x0 - X_d)         (SolverMPC.cpp:570)

where B~ is B_qp with the swing-leg columns zeroed, the static-shape
equivalent of the reference's variable elimination (SolverMPC.cpp:589-697).

The full stage form (``StageQPData``, ``build_stage_qp``) serves the
general stage solver (hector_torch/qp/riccati.py): the one-step discrete
dynamics Acd = I + dt A, Bcd = dt B (SolverMPC.cpp:145-146), with no
condensing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constant
from ..config import MPCConfig
from ..math import euler_rate_matrix, skew, inv3
from ..srbd import ct_dynamics, condense
from ..constraints import constraint_block, constraint_bounds, input_mask


def _dt(cfg: MPCConfig, like):
    return constant(('dt_mpc', cfg.dt_mpc), cfg.dt_mpc, like)


def _mass(cfg: MPCConfig, like):
    return constant(('mpc.mass', cfg.mass), cfg.mass, like)


def _weights13(cfg: MPCConfig, like):
    """The state weights with the gravity state's 0 appended, (13,)."""
    return constant(('mpc.weights13', cfg.weights),
                    tuple(cfg.weights) + (0.0,), like)


def _alpha(cfg: MPCConfig, like):
    return constant(('mpc.alpha', cfg.alpha), cfg.alpha, like)


class QPData(NamedTuple):
    """A batch of condensed MPC QPs:

    min 1/2 u^T H u + g^T u  s.t.  lb <= C_step u_step <= ub per step,

    with C_step shared across the horizon (fmat is block-diagonal with one
    repeated block, SolverMPC.cpp:552-555)."""

    h_mat: torch.Tensor    # (B, 12h, 12h)
    g_vec: torch.Tensor    # (B, 12h)
    c_block: torch.Tensor  # (B, 16, 12)
    lb: torch.Tensor       # (B, h, 16)
    ub: torch.Tensor       # (B, h, 16)


def build_qp(x0, traj, r_body, r_foot, r_feet, i_body, gait_table,
             cfg: MPCConfig) -> QPData:
    """Assemble the condensed QP for a batch of scenarios.  Inputs as in
    :func:`build_stage_parts`."""
    h = cfg.horizon
    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]

    i_world = r_body @ i_body @ r_body.transpose(-1, -2)
    erate = euler_rate_matrix(x0[:, 0:3])
    a_ct, b_ct = ct_dynamics(i_world, _mass(cfg, x0), r_feet, erate)
    a_qp, b_qp = condense(a_ct, b_ct, _dt(cfg, x0), h)

    # swing-leg variable masking == the reference's elimination
    u_mask = input_mask(gait_table).reshape(bsz, 12 * h).to(dtype)
    b_masked = b_qp * u_mask[:, None, :]

    s_diag = _weights13(cfg, x0).repeat(h)              # (13h,)
    alpha_rep = _alpha(cfg, x0).repeat(h)

    bs = b_masked * s_diag[:, None]                     # S B~
    h_mat = 2.0 * (b_masked.transpose(-1, -2) @ bs + torch.diag(alpha_rep))

    x_d = torch.cat([traj, torch.zeros(traj.shape[:-1] + (1,), dtype=dtype,
                                       device=dev)], dim=-1)
    x_d = x_d.reshape(bsz, 13 * h)
    resid = (a_qp @ x0[..., None])[..., 0] - x_d
    g_vec = 2.0 * (bs.transpose(-1, -2) @ resid[..., None])[..., 0]

    c_block = constraint_block(r_body, r_foot, cfg).to(dtype)
    lb, ub = constraint_bounds(gait_table.to(dtype), cfg)
    return QPData(h_mat, g_vec, c_block, lb, ub)


class StageQPParts(NamedTuple):
    """The tensor set the fused solver reads; every field has a leading
    batch dim B."""

    s69: torch.Tensor      # (B, 3, 3)
    scal: torch.Tensor     # (B, 3)
    b69: torch.Tensor      # (B, 3, 12)
    u_mask: torch.Tensor   # (B, h, 12)
    x0: torch.Tensor       # (B, 13)
    xd: torch.Tensor       # (B, h, 13)
    c_block: torch.Tensor  # (B, 16, 12)
    lb: torch.Tensor       # (B, h, 16)
    ub: torch.Tensor       # (B, h, 16)


def build_stage_parts(x0, traj, r_body, r_foot, r_feet, i_body, gait_table,
                      cfg: MPCConfig) -> StageQPParts:
    """Assemble what the fused solver consumes for a batch of scenarios.

    x0: (B, 13) [rpy, p, omega_world, v, g]; traj: (B, h, 12) reference
    states; r_body: (B, 3, 3) body->world; r_foot: (B, 2, 3, 3); r_feet:
    (B, 2, 3) foot-minus-CoM vectors; i_body: (3, 3) or (B, 3, 3) body
    inertia; gait_table: (B, h, 2) contact flags.
    """
    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]
    dt = _dt(cfg, x0)
    mass = _mass(cfg, x0)

    s69 = dt * euler_rate_matrix(x0[:, 0:3])
    scal = torch.stack([dt, -dt, dt / mass]).expand(bsz, 3).contiguous()

    i_world = r_body @ i_body @ r_body.transpose(-1, -2)
    i_inv = inv3(i_world)
    b69 = dt * torch.cat([
        i_inv @ skew(r_feet[:, 0, :]), i_inv @ skew(r_feet[:, 1, :]),
        i_inv, i_inv], dim=-1)

    u_mask = input_mask(gait_table).to(dtype)
    xd = torch.cat([traj, torch.zeros(traj.shape[:-1] + (1,), dtype=dtype,
                                      device=dev)], dim=-1)
    c_block = constraint_block(r_body, r_foot, cfg).to(dtype)
    lb, ub = constraint_bounds(gait_table.to(dtype), cfg)
    return StageQPParts(s69, scal, b69, u_mask, x0, xd, c_block, lb, ub)


def build_stage_qp(x0, traj, r_body, r_foot, r_feet, i_body, gait_table,
                   cfg: MPCConfig):
    """Assemble the same MPC problems in stage form for the Riccati solver
    (hector_torch/qp/riccati.py).  Inputs as in :func:`build_stage_parts`;
    the horizon is the gait table's and the reference's row count."""
    from .riccati import StageQPData

    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]
    i_world = r_body @ i_body @ r_body.transpose(-1, -2)
    a_ct, b_ct = ct_dynamics(i_world, _mass(cfg, x0), r_feet,
                             euler_rate_matrix(x0[:, 0:3]))
    dt = _dt(cfg, x0)
    a_dt = torch.eye(13, dtype=dtype, device=dev) + dt * a_ct  # Acd
    b_dt = dt * b_ct                                           # Bcd

    u_mask = input_mask(gait_table).to(dtype)                  # (B, h, 12)
    xd = torch.cat([traj, torch.zeros(traj.shape[:-1] + (1,), dtype=dtype,
                                      device=dev)], dim=-1)    # (B, h, 13)
    q_diag = _weights13(cfg, x0).expand(bsz, 13).contiguous()
    r_diag = _alpha(cfg, x0).expand(bsz, 12).contiguous()
    c_block = constraint_block(r_body, r_foot, cfg).to(dtype)
    lb, ub = constraint_bounds(gait_table.to(dtype), cfg)
    return StageQPData(a_dt, b_dt, u_mask, x0, xd, q_diag, r_diag, c_block,
                       lb, ub)
