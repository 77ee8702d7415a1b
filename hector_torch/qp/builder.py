"""Compact assembly of the stage-form MPC QP (port of
``hector/qp/builder.py``: ``StageQPParts`` and ``build_stage_parts``).

The production path builds only the slices of the discrete dynamics that the
fused Riccati solver reads (hector_torch/qp/fused_riccati.py):

  s69  = a_dt[0:3, 6:9]          = dt * euler_rate
  scal = [a_dt[3,9], a_dt[11,12], b_dt[9,0]] = [dt, -dt, dt/mass]
  b69  = b_dt[6:9, :] = dt * [I^-1 [r0]x | I^-1 [r1]x | I^-1 | I^-1]

The condensed ``build_qp`` and the full ``build_stage_qp`` serve oracle paths
that are not ported yet (ROADMAP.md queue A item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MPCConfig
from ..math import euler_rate_matrix, skew, inv3
from ..constraints import constraint_block, constraint_bounds, input_mask


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
    dt = torch.tensor(cfg.dt_mpc, dtype=dtype, device=dev)
    mass = torch.tensor(cfg.mass, dtype=dtype, device=dev)

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
