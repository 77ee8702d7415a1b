"""Friction-pyramid + moment + line-contact constraint builder (port of
``hector/constraints.py``, after ``SolverMPC.cpp:463-555``).

Per leg, rows (SolverMPC.cpp:511-548), with G = (R @ R_foot)^T:
  0: -mu Fx + Fz in [0, inf)
  1:  mu Fx + Fz in [0, inf)
  2: -mu Fy + Fz in [0, inf)
  3:  mu Fy + Fz in [0, inf)
  4: foot-frame Mx in [0, 0.01]
  5: -lt (G F)_z + (G M)_y in (-inf, 0]   (toe line contact)
  6: leg 0: -lh (G F)_z - (G M)_y in (-inf, 0]  (heel)
     leg 1: -lh (G F)_z + (G M)_y in (-inf, 0]  -- the reference's leg-2
     heel row reuses +M_vec (SolverMPC.cpp:545-546); kept on purpose.
  7: 2 Fz in [0, f_max * gait]

Swing legs keep static shapes: their rows are switched off by bounds of
+-2 * big_number (5e10), past the solver's 1e9 threshold.
"""

from __future__ import annotations

import torch

from .config import MPCConfig


def constraint_block(r_body, r_foot, cfg: MPCConfig):
    """Per-step constraint matrix F (..., 16, 12), shared by every stage.

    r_body: (..., 3, 3) body->world rotation; r_foot: (..., 2, 3, 3).
    """
    mu, lt, lh = cfg.mu_constraint, cfg.lt, cfg.lh
    g0 = (r_body @ r_foot[..., 0, :, :]).transpose(-1, -2)
    g1 = (r_body @ r_foot[..., 1, :, :]).transpose(-1, -2)
    f = torch.zeros(r_body.shape[:-2] + (16, 12), dtype=r_body.dtype,
                    device=r_body.device)
    for row0, col0 in ((0, 0), (8, 3)):
        f[..., row0 + 0, col0 + 0] = -mu
        f[..., row0 + 0, col0 + 2] = 1.0
        f[..., row0 + 1, col0 + 0] = mu
        f[..., row0 + 1, col0 + 2] = 1.0
        f[..., row0 + 2, col0 + 1] = -mu
        f[..., row0 + 2, col0 + 2] = 1.0
        f[..., row0 + 3, col0 + 1] = mu
        f[..., row0 + 3, col0 + 2] = 1.0

    # Mx selection row: e_x^T G on the moment columns
    f[..., 4, 6:9] = g0[..., 0, :]
    f[..., 12, 9:12] = g1[..., 0, :]
    # line-contact rows
    f[..., 5, 0:3] = -lt * g0[..., 2, :]
    f[..., 5, 6:9] = g0[..., 1, :]
    f[..., 6, 0:3] = -lh * g0[..., 2, :]
    f[..., 6, 6:9] = -g0[..., 1, :]
    f[..., 13, 3:6] = -lt * g1[..., 2, :]
    f[..., 13, 9:12] = g1[..., 1, :]
    f[..., 14, 3:6] = -lh * g1[..., 2, :]
    # reference quirk: +M_vec on the right leg's heel row (SolverMPC.cpp:546)
    f[..., 14, 9:12] = g1[..., 1, :]
    # Fz budget rows
    f[..., 7, 2] = 2.0
    f[..., 15, 5] = 2.0
    return f


def constraint_bounds(gait_table, cfg: MPCConfig):
    """Per-step bounds (lb, ub), each (..., h, 16), gait-masked.

    gait_table: (..., h, 2) contact flags (SolverMPC.cpp:466-482); a swing
    leg's 8 rows get -2 big / +2 big so the solver's row masks drop them.
    """
    dtype, dev = gait_table.dtype, gait_table.device
    big = torch.tensor(cfg.big_number, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    lb_leg = torch.stack([zero, zero, zero, zero, zero, -big, -big, zero])
    ub_base = torch.stack([big, big, big, big,
                           torch.tensor(cfg.mx_bound, dtype=dtype, device=dev),
                           zero, zero, one])
    lbs, ubs = [], []
    for leg in range(2):
        contact = gait_table[..., leg:leg + 1]           # (..., h, 1)
        ub_leg = ub_base.expand(gait_table.shape[:-1] + (8,)).clone()
        ub_leg[..., 7] = ub_leg[..., 7] * cfg.f_max
        ub_leg[..., 7] = ub_leg[..., 7] * gait_table[..., leg]
        lbs.append(torch.where(contact > 0, lb_leg, -2 * big))
        ubs.append(torch.where(contact > 0, ub_leg, 2 * big))
    return torch.cat(lbs, dim=-1), torch.cat(ubs, dim=-1)


def input_mask(gait_table):
    """(..., h, 12) variable mask: 1 for stance-leg force/moment vars
    (the reference's swing-variable elimination, SolverMPC.cpp:589-733)."""
    g0 = gait_table[..., 0:1]
    g1 = gait_table[..., 1:2]
    return torch.cat([g0.expand(g0.shape[:-1] + (3,)),
                      g1.expand(g1.shape[:-1] + (3,)),
                      g0.expand(g0.shape[:-1] + (3,)),
                      g1.expand(g1.shape[:-1] + (3,))], dim=-1)
