"""Rotation / quaternion / interpolation math (port of ``hector/math.py``).

Conventions of ``hector_control/include/common/Math/orientation_tools.h``
and ``ConvexMPC/SolverMPC.cpp:65-107,333-342``.  All functions work on
trailing axes, so any leading batch shape passes through.

Quaternion layout everywhere: (w, x, y, z) (``RobotState.cpp:18-21``).
"""

from __future__ import annotations

import torch


def quat_to_rot(q):
    """Body->world rotation matrix from a unit quaternion
    (Eigen's ``q.toRotationMatrix()``, ``RobotState.cpp:33``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_to_rpy(q):
    """ZYX Euler angles as (roll, pitch, yaw) (``SolverMPC.cpp:333-342``);
    the asin argument is clamped on both sides so no lane produces NaN."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(2.0 * (w * y - x * z), -0.99999, 0.99999)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(as_)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_rate_matrix(rpy):
    """omega_world -> rpy-rate map, the closed form of ``Rb.inverse()`` at
    ``SolverMPC.cpp:65-89``:
    [[cy/cp, sy/cp, 0], [-sy, cy, 0], [cy*tp, sy*tp, 1]]."""
    p, y = rpy[..., 1], rpy[..., 2]
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    inv_cp = 1.0 / cp
    tp = sp * inv_cp
    o, i = torch.zeros_like(p), torch.ones_like(p)
    r = torch.stack([
        cy * inv_cp, sy * inv_cp, o,
        -sy, cy, o,
        cy * tp, sy * tp, i,
    ], dim=-1)
    return r.reshape(rpy.shape[:-1] + (3, 3))


def skew(v):
    """3-vector -> skew-symmetric matrix ([r]x, ``SolverMPC.cpp:302-309``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def cross(a, b):
    """Cross product on the trailing axis (broadcasting leading axes)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def inv3(m):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = torch.stack([
        co_a, -(b * i - c * h), b * f - c * e,
        co_b, a * i - c * g, -(a * f - c * d),
        co_c, -(a * h - b * g), a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj * inv_det[..., None, None]


def cubic_bezier(y0, yf, x):
    """``Interpolate::cubicBezier`` (``Math/Interpolation.h:53-60``)."""
    bezier = x * x * x + 3.0 * (x * x * (1.0 - x))
    return y0 + bezier * (yf - y0)


def quat_integrate(q, omega_world, dt):
    """Integrate a unit quaternion under world angular velocity (plant side)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ox, oy, oz = omega_world[..., 0], omega_world[..., 1], omega_world[..., 2]
    # qdot = 0.5 * omega_quat * q  (world-frame omega => left multiply)
    dw = -0.5 * (ox * x + oy * y + oz * z)
    dx = 0.5 * (ox * w + oy * z - oz * y)
    dy = 0.5 * (oy * w + oz * x - ox * z)
    dz = 0.5 * (oz * w + ox * y - oy * x)
    qn = torch.stack([w + dt * dw, x + dt * dx, y + dt * dy, z + dt * dz],
                     dim=-1)
    return qn / torch.sqrt(torch.sum(qn * qn, dim=-1, keepdim=True))


def matvec(m, v):
    """m @ v on trailing axes: (..., n, k) x (..., k) -> (..., n)."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def rmatvec(m, v):
    """m^T @ v on trailing axes: (..., k, n) x (..., k) -> (..., n)."""
    return torch.matmul(v.unsqueeze(-2), m).squeeze(-2)
