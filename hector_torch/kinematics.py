"""Leg forward kinematics, Jacobians, foot rotation and analytic IK (port of
``hector/kinematics.py``).

Each leg is the chain Rz(q0) Rx(q1) Ry(q2) Ry(q3) Ry(q4) with translations;
the constants come from ``config.py`` (LegFKModel / LegJacobianModel /
LegIKModel).  The reference's quirks are kept: the FK and Jacobian chains use
different constants, and the IK has its own side convention.

The JAX package takes the force Jacobian as ``jax.jacfwd`` of the Jacobian
chain; here it is the same derivative written in closed form.

All functions take the two legs stacked on axis -2: q has shape (..., 2, 5);
leg 0 is left.
"""

from __future__ import annotations

import math

import torch

from .config import HectorConfig, DEFAULT_CONFIG, JOINT_OFFSETS

# side sign per leg for the FK / Jacobian models (LegController.cpp:122-126)
FK_SIDE = (1.0, -1.0)
# side sign per leg in the IK's own convention (SwingLegController.cpp:160)
IK_SIDE = (-1.0, 1.0)


def hip_yaw_locations(cfg: HectorConfig, like):
    """(2, 3) hip-yaw joint locations in the body frame (Biped.h), with the
    dtype and device of ``like``."""
    return torch.tensor(
        [cfg.robot.hip_yaw_location(0), cfg.robot.hip_yaw_location(1)],
        dtype=like.dtype, device=like.device)


def _offsets(like):
    return torch.tensor(JOINT_OFFSETS, dtype=like.dtype, device=like.device)


def apply_joint_offsets(q):
    """Raw motor angles -> effective chain angles (+0.3pi, -0.6pi, +0.3pi on
    the knee chain; LegController.cpp:111-113)."""
    return q + _offsets(q)


def _chain_terms(q5, b_y, l1, l2, l3):
    """Shared trigonometry of the chain for one leg; q5 (..., 5)."""
    q0, q1, q2, q3, q4 = (q5[..., i] for i in range(5))
    s23 = q2 + q3
    s234 = s23 + q4
    t = dict(
        c0=torch.cos(q0), s0=torch.sin(q0), c1=torch.cos(q1),
        s1=torch.sin(q1), c2=torch.cos(q2), s2=torch.sin(q2),
        c23=torch.cos(s23), s23=torch.sin(s23), c234=torch.cos(s234),
        s234=torch.sin(s234))
    # planar reach in the pitch plane
    t['sx'] = l1 * t['s2'] + l2 * t['s23'] + l3 * t['s234']
    t['kz'] = l1 * t['c2'] + l2 * t['c23'] + l3 * t['c234']
    # u = b + (-sx, 0, -kz); v = Rx(q1) u
    u_z = -t['kz']
    t['v_x'] = -t['sx']
    t['v_y'] = t['c1'] * b_y - t['s1'] * u_z
    t['v_z'] = t['s1'] * b_y + t['c1'] * u_z
    return t


def _chain_position(q5, a_x, a_y, a_z, b_y, l1, l2, l3):
    """p = Rz(q0) (a + Rx(q1) (b + Ry(q2)(0,0,-l1) + Ry(q2+q3)(0,0,-l2)
    + Ry(q2+q3+q4)(0,0,-l3)))."""
    t = _chain_terms(q5, b_y, l1, l2, l3)
    w_x, w_y = a_x + t['v_x'], a_y + t['v_y']
    return torch.stack([t['c0'] * w_x - t['s0'] * w_y,
                        t['s0'] * w_x + t['c0'] * w_y,
                        a_z + t['v_z']], dim=-1)


def _chain_jacobian(q5, a_x, a_y, b_y, l1, l2, l3):
    """d p / d q of _chain_position, (..., 3, 5), in closed form."""
    t = _chain_terms(q5, b_y, l1, l2, l3)
    c0, s0, c1, s1 = t['c0'], t['s0'], t['c1'], t['s1']
    w_x, w_y = a_x + t['v_x'], a_y + t['v_y']
    zero = torch.zeros_like(c0)
    cols = [torch.stack([-s0 * w_x - c0 * w_y, c0 * w_x - s0 * w_y, zero], -1)]
    # q1: only v_y, v_z move
    dvy = -s1 * b_y + c1 * t['kz']
    dvz = c1 * b_y + s1 * t['kz']
    cols.append(torch.stack([-s0 * dvy, c0 * dvy, dvz], -1))
    # q2, q3, q4: d sx and d kz of the planar reach
    dsx = (l1 * t['c2'] + l2 * t['c23'] + l3 * t['c234'],
           l2 * t['c23'] + l3 * t['c234'],
           l3 * t['c234'])
    dkz = (-(l1 * t['s2'] + l2 * t['s23'] + l3 * t['s234']),
           -(l2 * t['s23'] + l3 * t['s234']),
           -l3 * t['s234'])
    for j in range(3):
        dvx = -dsx[j]
        dvy = s1 * dkz[j]
        dvz = -c1 * dkz[j]
        cols.append(torch.stack([c0 * dvx - s0 * dvy, s0 * dvx + c0 * dvy,
                                 dvz], -1))
    return torch.stack(cols, dim=-1)


def foot_position(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """Foot position in the hip-yaw frame for both legs.

    q_raw: (..., 2, 5) raw motor angles.  Returns (..., 2, 3).
    Parity target: LegController.cpp:190-194.
    """
    q = apply_joint_offsets(q_raw)
    fk = cfg.fk
    legs = [_chain_position(q[..., leg, :], fk.a_x, fk.a_y_side * s, fk.a_z,
                            fk.b_y_side * s, fk.l_thigh, fk.l_calf, fk.l_toe)
            for leg, s in enumerate(FK_SIDE)]
    return torch.stack(legs, dim=-2)


def leg_jacobians(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """(J_force_moment (..., 2, 6, 5), J_force (..., 2, 3, 5)).

    J_force is d p_J / d q of the Jacobian-model chain (the reference's
    symbolic matrix, LegController.cpp:131-186); the angular rows 3:6 are
    the world-frame joint axes (z, Rz x, Rz Rx y).
    """
    q = apply_joint_offsets(q_raw)
    jm = cfg.jac
    jms, jfs = [], []
    for leg, s in enumerate(FK_SIDE):
        q5 = q[..., leg, :]
        jf = _chain_jacobian(q5, jm.a_x, jm.a_y_side * s,
                             jm.b_y_side * s + jm.b_y_const,
                             jm.l_thigh, jm.l_calf, jm.l_toe)
        c0, s0 = torch.cos(q5[..., 0]), torch.sin(q5[..., 0])
        c1, s1 = torch.cos(q5[..., 1]), torch.sin(q5[..., 1])
        z = torch.zeros_like(c0)
        one = torch.ones_like(c0)
        ax_yaw = torch.stack([z, z, one], -1)
        ax_roll = torch.stack([c0, s0, z], -1)
        ax_pitch = torch.stack([-c1 * s0, c0 * c1, s1], -1)
        jang = torch.stack([ax_yaw, ax_roll, ax_pitch, ax_pitch, ax_pitch],
                           dim=-1)                        # (..., 3, 5)
        jms.append(torch.cat([jf, jang], dim=-2))
        jfs.append(jf)
    return torch.stack(jms, dim=-3), torch.stack(jfs, dim=-3)


def foot_rotation(q_eff):
    """R_foot = Rz(q0) Rx(q1) Ry(q2+q3+q4) for both legs.

    q_eff: (..., 2, 5) effective angles; the caller decides how many offset
    corrections are applied (mpc.py applies the reference's triple
    correction).  Parity target: SolverMPC.cpp:428-433.
    """
    q0, q1 = q_eff[..., 0], q_eff[..., 1]
    s234 = q_eff[..., 2] + q_eff[..., 3] + q_eff[..., 4]
    c0, s0 = torch.cos(q0), torch.sin(q0)
    c1, s1 = torch.cos(q1), torch.sin(q1)
    cs, ss = torch.cos(s234), torch.sin(s234)
    r = torch.stack([
        c0 * cs - s0 * s1 * ss, -s0 * c1, c0 * ss + s0 * s1 * cs,
        s0 * cs + c0 * s1 * ss, c0 * c1, s0 * ss - c0 * s1 * cs,
        -c1 * ss, s1, c1 * cs,
    ], dim=-1)
    return r.reshape(q_eff.shape[:-1] + (3, 3))


def leg_ik(p_foot_b, q_data, cfg: HectorConfig = DEFAULT_CONFIG):
    """Geometric 5-DoF IK; returns raw-motor-frame joint targets.

    p_foot_b: (..., 2, 3) desired foot position in body frame; q_data:
    (..., 2, 5) current offset-corrected angles (the toe joint follows
    theta4 = -q3 - q2, SwingLegController.cpp:181).
    Parity target: SwingLegController.cpp:157-187.
    """
    ik = cfg.ik
    dtype, dev = p_foot_b.dtype, p_foot_b.device
    side = torch.tensor(IK_SIDE, dtype=dtype, device=dev)
    hip = torch.tensor([ik.hip_x, 0.0, ik.hip_z], dtype=dtype, device=dev)
    d = p_foot_b - hip
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    dist3 = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    dist_yoz = torch.sqrt(d1 * d1 + d2 * d2)
    dh = ik.distance_horizontal
    dist_vert = torch.sqrt(torch.clamp(dist_yoz ** 2 - dh ** 2,
                                       min=ik.eps_vertical))
    # the reference takes pow(dist3^2 - dh^2, 0.5) unguarded
    # (SwingLegController.cpp:168); the same epsilon clamp keeps every lane
    # finite (identical output for reachable targets)
    dist_xoz = torch.sqrt(torch.clamp(dist3 ** 2 - dh ** 2,
                                      min=ik.eps_vertical))

    def clamp1(x):
        return torch.clamp(x, -1.0, 1.0)

    acos_arg1 = clamp1(dist_xoz / (2.0 * ik.l_link))
    acos_arg2 = clamp1(dist_vert / dist_xoz)
    divisor = torch.where(torch.abs(d0) == 0.0,
                          torch.full_like(d0, 1e-6), torch.abs(d0))

    th0 = torch.zeros_like(d0)
    th1 = (torch.asin(clamp1(d1 / dist_yoz))
           + torch.asin(clamp1(dh * side / dist_yoz)))
    th2 = torch.acos(acos_arg1) - torch.acos(acos_arg2) * d0 / divisor
    th3 = 2.0 * torch.asin(clamp1(dist_xoz / (2.0 * ik.l_link))) - math.pi
    th4 = -q_data[..., 3] - q_data[..., 2]

    q_des = torch.stack([th0, th1, th2, th3, th4], dim=-1)
    return q_des - _offsets(q_des)
