"""The legs of the reference: foot position, force and moment Jacobians,
foot rotation and the swing leg's inverse kinematics, written out from the
published controller's closed-form expressions.

Transcribed, a leg at a time, from the symbolic expressions of the
Hector controller (Hector_Simulation, hector_control):
src/common/LegController.cpp:108-195 (the Jacobians and the foot
position, whose constants differ: toe 0.04 against 9/250),
ConvexMPC/SolverMPC.cpp:426-433 (the foot rotation) and
src/common/SwingLegController.cpp:157-187 (the inverse kinematics, whose
side sign is the opposite of the Jacobian's).  The knee-chain offsets are
the configuration's (config.JOINT_OFFSETS, 0.3 pi with pi = 3.14159265359,
the value the controller's MPC uses).

Every function takes the two legs on axis -2 (leg 0 left) and works in
the dtype of its input.
"""

from __future__ import annotations

import math

import torch

from .config import JOINT_OFFSETS


def _sides(leg):
    """(the Jacobian's and position's side, the IK's side) of a leg."""
    return (1.0, -1.0) if leg == 0 else (-1.0, 1.0)


def _offset(q5):
    return q5 + q5.new_tensor(JOINT_OFFSETS)


def foot_and_jacobian(q_raw):
    """(foot position in the hip-yaw frame (..., 2, 3), force-moment
    Jacobian (..., 2, 6, 5)) at raw motor angles ``q_raw`` (..., 2, 5)."""
    positions, jacobians = [], []
    for leg in range(2):
        side, _ = _sides(leg)
        q = _offset(q_raw[..., leg, :])
        q0, q1, q2, q3, q4 = q.unbind(-1)
        s0, c0 = torch.sin(q0), torch.cos(q0)
        s1, c1 = torch.sin(q1), torch.cos(q1)
        s2, c2 = torch.sin(q2), torch.cos(q2)
        s3, c3 = torch.sin(q3), torch.cos(q3)
        s4, c4 = torch.sin(q4), torch.cos(q4)
        s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
        s234, c234 = torch.sin(q2 + q3 + q4), torch.cos(q2 + q3 + q4)

        # the Jacobian (LegController.cpp:131-186)
        se = 0.04 * s234 + 0.22 * s23 + 0.22 * s2
        ce = 0.04 * c234 + 0.22 * c23 + 0.22 * c2
        hy = 0.018 * side + 0.0025
        zero, one = torch.zeros_like(q0), torch.ones_like(q0)
        col0 = [s0 * (se + 0.0135) + c0 * (0.015 * side + c1 * hy - s1 * ce),
                s0 * (0.015 * side + c1 * hy - s1 * ce) - c0 * (se + 0.0135),
                zero, zero, zero, one]
        col1 = [-s0 * (s1 * hy + c1 * ce), c0 * (s1 * hy + c1 * ce),
                s1 * ce - c1 * hy, c0, s0, zero]
        cols = [col0, col1]
        for sx, cx in ((se, ce),
                       (0.04 * s234 + 0.22 * s23, 0.04 * c234 + 0.22 * c23),
                       (0.04 * s234, 0.04 * c234)):
            cols.append([s0 * s1 * sx - c0 * cx, -s0 * cx - c0 * s1 * sx,
                         c1 * sx, -c1 * s0, c0 * c1, s1])
        jacobians.append(torch.stack([torch.stack(c, -1) for c in cols], -1))

        # the foot position (LegController.cpp:190-194)
        a = c0 * s2 + c2 * s0 * s1
        b = c0 * c2 - s0 * s1 * s2
        cc = c2 * s0 + c0 * s1 * s2
        d = s0 * s2 - c0 * c2 * s1
        px = (-(3 * c0) / 200 - (9 * s4 * (c3 * b - s3 * a)) / 250
              - (11 * c0 * s2) / 50 - (side * s0) / 50 - (11 * c3 * a) / 50
              - (11 * s3 * b) / 50 - (9 * c4 * (c3 * a + s3 * b)) / 250
              - (23 * c1 * side * s0) / 1000 - (11 * c2 * s0 * s1) / 50)
        py = ((c0 * side) / 50 - (9 * s4 * (c3 * cc - s3 * d)) / 250
              - (3 * s0) / 200 - (11 * s0 * s2) / 50 - (11 * c3 * d) / 50
              - (11 * s3 * cc) / 50 - (9 * c4 * (c3 * d + s3 * cc)) / 250
              + (23 * c0 * c1 * side) / 1000 + (11 * c0 * c2 * s1) / 50)
        pz = ((23 * side * s1) / 1000 - (11 * c1 * c2) / 50
              - (9 * c4 * (c1 * c2 * c3 - c1 * s2 * s3)) / 250
              + (9 * s4 * (c1 * c2 * s3 + c1 * c3 * s2)) / 250
              - (11 * c1 * c2 * c3) / 50 + (11 * c1 * s2 * s3) / 50
              - 3.0 / 50.0)
        positions.append(torch.stack([px, py, pz], -1))
    return torch.stack(positions, -2), torch.stack(jacobians, -3)


def foot_rotation(q):
    """The feet's rotation matrices (..., 2, 3, 3) at the angles ``q``
    (..., 2, 5) as given (SolverMPC.cpp:426-433)."""
    out = []
    for leg in range(2):
        q0, q1, q2, q3, q4 = q[..., leg, :].unbind(-1)
        s0, c0 = torch.sin(q0), torch.cos(q0)
        s1, c1 = torch.sin(q1), torch.cos(q1)
        s2, c2 = torch.sin(q2), torch.cos(q2)
        s3, c3 = torch.sin(q3), torch.cos(q3)
        s4, c4 = torch.sin(q4), torch.cos(q4)
        s234, c234 = torch.sin(q2 + q3 + q4), torch.cos(q2 + q3 + q4)
        a = c0 * s2 + c2 * s0 * s1
        b = c0 * c2 - s0 * s1 * s2
        cc = c2 * s0 + c0 * s1 * s2
        d = s0 * s2 - c0 * c2 * s1
        rows = [[-s4 * (c3 * a + s3 * b) - c4 * (s3 * a - c3 * b), -c1 * s0,
                 c4 * (c3 * a + s3 * b) - s4 * (s3 * a - c3 * b)],
                [c4 * (c3 * cc - s3 * d) - s4 * (s3 * cc + c3 * d), c0 * c1,
                 c4 * (s3 * cc + c3 * d) + s4 * (c3 * cc - s3 * d)],
                [-s234 * c1, s1, c234 * c1]]
        out.append(torch.stack([torch.stack(r, -1) for r in rows], -2))
    return torch.stack(out, -3)


def inverse_kinematics(target, q_data):
    """Raw motor angles (..., 2, 5) that put each foot at ``target``
    (..., 2, 3), in the body frame; the toe follows -q3 - q2 of
    ``q_data``, the offset angles (SwingLegController.cpp:157-187).  The
    two square roots the reference takes unguarded are floored at its own
    epsilon, 1e-5, so that no lane goes non-finite."""
    hip = target.new_tensor([0.0465 - 0.06, 0.0, -0.126 + 2 * (-0.0705)])
    dh, link = 0.0205, 0.22
    out = []
    for leg in range(2):
        _, side = _sides(leg)
        f = target[..., leg, :] - hip
        fx, fy, fz = f.unbind(-1)
        d3 = torch.sqrt(fx * fx + fy * fy + fz * fz)
        d_yoz = torch.sqrt(fy * fy + fz * fz)
        dv = torch.sqrt(torch.clamp(d_yoz * d_yoz - dh * dh, min=1e-5))
        d_xoz = torch.sqrt(torch.clamp(d3 * d3 - dh * dh, min=1e-5))
        divisor = torch.where(fx == 0, torch.full_like(fx, 1e-6), fx.abs())
        qd = q_data[..., leg, :]
        j1 = (torch.asin(torch.clamp(fy / d_yoz, -1.0, 1.0))
              + torch.asin(torch.clamp(dh * side / d_yoz, -1.0, 1.0)))
        j2 = (torch.acos(torch.clamp(d_xoz / (2 * link), -1.0, 1.0))
              - torch.acos(torch.clamp(dv / d_xoz, -1.0, 1.0)) * fx / divisor)
        j3 = 2.0 * torch.asin(torch.clamp(d_xoz / 2.0 / link, -1.0, 1.0)) \
            - math.pi
        j4 = -qd[..., 3] - qd[..., 2]
        ja = torch.stack([torch.zeros_like(j1), j1, j2, j3, j4], -1)
        out.append(ja - ja.new_tensor(JOINT_OFFSETS))
    return torch.stack(out, -2)
