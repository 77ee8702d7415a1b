"""The reference's tier-2 plant: the articulated HECTOR (a floating trunk
and two five-joint legs, 11 bodies, 16 degrees of freedom) on penalty
ground contact, one 1 ms control tick in four implicit substeps; and one
MPC period of the tier-2 loop (five ticks of reference/tick.py, twenty
substeps, the NaN quarantine).

The model is the robot Gazebo simulates for the published controller
(Hector_Simulation, hector_description/xacro/{const,leg,robot}.xacro):
the joint tree and the link inertials below are the repository's
transcription of that URDF (hector_torch/plant/model.py at commit
d60b22b: the values, the lumping of each fixed "*_trans" motor mass into
its parent link by the parallel-axis rule), copied as numbers.  The
dynamics are written from Featherstone's Rigid Body Dynamics Algorithms
(2008) in spatial vectors about one fixed point of the world, the trunk's
origin at the start of the substep:

- the mass matrix by the composite-rigid-body algorithm (RBDA section
  6.2): the composite spatial inertia of each joint's subtree, and
  M_ij = S_i' Ic_j S_j for i an ancestor of j;
- the bias forces C(q, nu) nu + G(q) by the recursive Newton-Euler pass
  (RBDA section 5.3) at zero acceleration, gravity as an upward
  acceleration of the base;
- each contact point's Jacobian by the chain: a point p on a body moves
  by e_k along the trunk's velocity, by e_k x (p - c) about its angular
  velocity, and by a_j x (p - o_j) about each joint j above the body.

Generalised coordinates: nu = [v (3), omega (3), qd (10)], the velocity
of the trunk's origin (its centre of mass) and its angular velocity in
the world frame, then the joints leg by leg (hip yaw, hip roll, thigh,
calf, toe); a generalised force is [force, moment about the trunk origin,
joint torques].

The ground (the deployment's ``plant`` group, the port's ContactConfig):
at each toe-box corner (4 a leg), trunk-box corner (8) and knee (2) a
unilateral spring on the penetration, saturated at ``pen_cap``, and a
normal damper; a tangential spring toward a stiction anchor set where the
point touched down, held to the friction cone of the normal force's
estimate, the anchor dragged to the cone's edge where the point slides.
The dampers and the servo's velocity terms are integrated implicitly:
with D the dampers' gains and A = kd + damping + dt kp a joint,

    (M + dt diag(0, A) + dt J' D J + 1e-6 I) nu_dot
        = [push, tau0 - A qd] + J' (f0 - D J nu) - bias,

tau0 = kp (q* - q) + kd qd* + tau_ff clamped to the torque limit
(joint_controller.cpp:139-224, whose damping term kd (qd* - qd) is the
implicit one here), solved by a Cholesky factorisation.  Then the base
velocities are capped (v_cap, w_cap), the joint rates clamped to their
limit, the angles to the URDF's joint limits (a pinned joint loses its
outward rate), the trunk moved and its quaternion stepped to first order
and normalised.  Each departure from Gazebo is listed under ``assumed``
in configs/hector-h10-wb.json.

The controller observes the plant as the deployment's contact sensors
give it: a leg is in contact when any of its toe-box corners sticks, and
its foot is the mean of those corners.

Float64 for the check; every function works in the dtype of its inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import plant as P
from . import tick as R
from .config import DEFAULT_CONFIG

N_SUBSTEPS = 4


class ContactConfig(NamedTuple):
    """The ground of the deployment: gazebo.xacro's kp 1e5 and toe mu1 1,
    the implicit dampers, the stiction spring, the energy backstops, and
    the toe box's width scale and outboard shift (1 and 0: the URDF's 2 cm
    box, centred under the toe frame)."""

    k_normal: float = 1.0e5
    d_normal: float = 2.0e3
    mu: float = 1.0
    k_anchor: float = 2.0e4
    k_tangent: float = 2.0e3
    pen_cap: float = 0.02
    v_cap: float = 10.0
    w_cap: float = 30.0
    toe_halfwidth_scale: float = 1.0
    toe_y_offset: float = 0.0


CONTACT = ContactConfig()


class State(NamedTuple):
    """The articulated plant, in the program's field names and order."""

    position: torch.Tensor     # (B, 3) trunk origin (its com), world
    quat: torch.Tensor         # (B, 4) wxyz, trunk to world
    v_world: torch.Tensor      # (B, 3)
    omega_world: torch.Tensor  # (B, 3)
    q: torch.Tensor            # (B, 2, 5) joint angles, URDF zero pose
    qd: torch.Tensor           # (B, 2, 5)
    anchor: torch.Tensor       # (B, 18, 2) stiction anchors a point
    sticking: torch.Tensor     # (B, 18) bool


# -- the model: the URDF as hector_torch/plant/model.py transcribes it ----

TRUNK_MASS = 4.87
TRUNK_INERTIA = (0.052, 0.0441, 0.0184)          # diagonal, trunk frame
# the trunk's collision box (robot.xacro:49-54, 0.125 x 0.19 x 0.248)
TRUNK_HALF = (0.0625, 0.095, 0.124)
# the toe collision box's sole corners in the left toe frame (leg.xacro:
# 0.15 x 0.02 x 0.04 box, 4 cm below the frame; centred in y, as the
# controller's own foot model has it)
TOE_CORNERS = ((0.085, 0.01, -0.04), (0.085, -0.01, -0.04),
               (-0.065, 0.01, -0.04), (-0.065, -0.01, -0.04))
N_TOE = 2 * len(TOE_CORNERS)
N_POINTS = N_TOE + 8 + 2
_MOTOR = (0.605, (0.00048, 0.00071, 0.00048))    # a "*_trans" motor link


def _lump(parts):
    """(mass, com, inertia about the com) of rigid parts [(mass, com,
    inertia about its com as a 3x3 nested list)] in one frame."""
    m = sum(p[0] for p in parts)
    com = [sum(p[0] * p[1][i] for p in parts) / m for i in range(3)]
    inertia = [[0.0] * 3 for _ in range(3)]
    for mass, c, i_c in parts:
        d = [c[i] - com[i] for i in range(3)]
        dd = sum(x * x for x in d)
        for i in range(3):
            for j in range(3):
                inertia[i][j] += i_c[i][j] + mass * (
                    (dd if i == j else 0.0) - d[i] * d[j])
    return m, com, inertia


def _diag(v):
    return [[v[0], 0.0, 0.0], [0.0, v[1], 0.0], [0.0, 0.0, v[2]]]


def _ry(a):
    c, s = math.cos(a), math.sin(a)
    return [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]


def leg_joints(m):
    """The five joints of a leg (m = 1 left, -1 right): (offset in the
    parent frame, fixed rotation before the joint, axis, mass, com,
    inertia about the com), the last three in the link's frame."""
    motor = (_MOTOR[0], _diag(_MOTOR[1]))
    hip = _lump([(0.173, (0.0268, -0.00315, -0.0272),
                  _diag((0.00022, 0.00024, 0.00016))),
                 (motor[0], (0.079, 0.015 * m, -0.0705), motor[1])])
    hip2 = _lump([(0.0722, (-0.033217, -0.010231, 0.0),
                   _diag((0.00004, 0.000101, 0.00007))),
                  (motor[0], (-0.06, -0.015 * m, 0.0), motor[1])])
    thigh = _lump([(0.397, (-0.000147, 0.01991 * m, -0.081117),
                    _diag((0.0019, 0.00218, 0.00033))),
                   (motor[0], (0.0, 0.0625 * m, 0.0), motor[1]),
                   (motor[0], (0.0, -0.0225 * m, -0.097), motor[1])])
    calf = (0.163, (0.0, 0.020417 * m, -0.1141),
            _diag((0.00071, 0.00071, 0.000068352)))
    toe = (0.184, (0.010569, 0.017949 * m, -0.017118),
           _diag((0.00005, 0.00021, 0.0002)))
    eye = _diag((1.0, 1.0, 1.0))
    pi = math.pi
    return [((0.0, 0.047 * m, -0.1265), eye, (0.0, 0.0, 1.0)) + hip,
            ((0.0465, 0.015 * m, -0.0705), eye, (1.0, 0.0, 0.0)) + hip2,
            ((-0.06, 0.018 * m, 0.0), _ry(0.25 * pi), (0.0, 1.0, 0.0))
            + thigh,
            ((0.0, 0.0, -0.22), _ry(-0.5 * pi), (0.0, 1.0, 0.0)) + calf,
            ((0.0, 0.0, -0.22), _ry(0.25 * pi), (0.0, 1.0, 0.0)) + toe]


def total_mass():
    return TRUNK_MASS + sum(j[3] for m in (1.0, -1.0) for j in leg_joints(m))


_TABLES = {}


def _tables(like):
    """The model's constants as tensors (leg, joint, ...) in the dtype and
    on the device of ``like``."""
    key = (like.dtype, like.device)
    if key not in _TABLES:
        legs = [leg_joints(1.0), leg_joints(-1.0)]

        def t(k):
            return torch.tensor([[j[k] for j in leg] for leg in legs],
                                dtype=like.dtype, device=like.device)
        _TABLES[key] = dict(
            offset=t(0), pre=t(1), axis=t(2), mass=t(3), com=t(4),
            inertia=t(5),
            trunk_inertia=torch.diag(torch.tensor(
                TRUNK_INERTIA, dtype=like.dtype, device=like.device)),
            trunk_corners=torch.tensor(
                [[sx * TRUNK_HALF[0], sy * TRUNK_HALF[1], sz * TRUNK_HALF[2]]
                 for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                dtype=like.dtype, device=like.device),
            toe=torch.tensor(TOE_CORNERS, dtype=like.dtype,
                             device=like.device))
    return _TABLES[key]


# -- spatial algebra, world coordinates about a fixed point ---------------

def _skew(v):
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _rot_about(axis, angle):
    """Rotation by ``angle`` (...) about the unit ``axis`` (..., 3)."""
    k = _skew(axis)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None,
                                                                None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def spatial_inertia(mass, r, i_com):
    """The 6x6 spatial inertia about the reference point of a body whose
    com lies at ``r`` from it, acting on [omega; v]: [[I - m rx rx, m rx],
    [-m rx, m 1]]."""
    rx = _skew(r)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    top = torch.cat([i_com - m * (rx @ rx), m * rx], -1)
    bottom = torch.cat([-m * rx, m * eye.expand_as(rx)], -1)
    return torch.cat([top, bottom], -2)


def cross_motion(v, m):
    """v x m for spatial motion vectors [w; u]."""
    w, u = v[..., :3], v[..., 3:]
    mw, mu = m[..., :3], m[..., 3:]
    return torch.cat([torch.linalg.cross(w, mw, dim=-1),
                      torch.linalg.cross(w, mu, dim=-1)
                      + torch.linalg.cross(u, mw, dim=-1)], -1)


def cross_force(v, f):
    """v x* f for a spatial force [n; f] under motion v = [w; u]."""
    w, u = v[..., :3], v[..., 3:]
    fn, ff = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, fn, dim=-1)
                      + torch.linalg.cross(u, ff, dim=-1),
                      torch.linalg.cross(w, ff, dim=-1)], -1)


class Links(NamedTuple):
    """The legs' links in the world, (B, 2, 5, ...), positions relative to
    the trunk's origin."""

    rot: torch.Tensor       # link rotations
    origin: torch.Tensor    # joint origins
    axis: torch.Tensor      # joint axes
    inertia: torch.Tensor   # 6x6 spatial inertias about the trunk origin
    motion: torch.Tensor    # joint motion subspaces [a; o x a]


def links(rot0, q):
    """Forward kinematics of both legs at joint angles q (B, 2, 5) under
    the trunk rotation rot0 (B, 3, 3)."""
    t = _tables(q)
    bsz = q.shape[0]
    rot = rot0[:, None].expand(bsz, 2, 3, 3)
    org = torch.zeros((bsz, 2, 3), dtype=q.dtype, device=q.device)
    rots, orgs, axes, inertias, motions = [], [], [], [], []
    for j in range(5):
        org = org + (rot @ t['offset'][:, j, :, None])[..., 0]
        pre = rot @ t['pre'][:, j]
        axis = (pre @ t['axis'][:, j, :, None])[..., 0]
        rot = pre @ _rot_about(t['axis'][:, j], q[..., j])
        com = org + (rot @ t['com'][:, j, :, None])[..., 0]
        i_world = rot @ t['inertia'][:, j] @ rot.transpose(-1, -2)
        rots.append(rot)
        orgs.append(org)
        axes.append(axis)
        inertias.append(spatial_inertia(t['mass'][:, j].expand(bsz, 2),
                                        com, i_world))
        motions.append(torch.cat(
            [axis, torch.linalg.cross(org, axis, dim=-1)], -1))

    def stack(x):
        return torch.stack(x, 2)
    return Links(stack(rots), stack(orgs), stack(axes), stack(inertias),
                 stack(motions))


def trunk_inertia(rot0, like):
    t = _tables(like)
    i_world = rot0 @ t['trunk_inertia'] @ rot0.transpose(-1, -2)
    mass = torch.full(rot0.shape[:1], TRUNK_MASS, dtype=rot0.dtype,
                      device=rot0.device)
    return spatial_inertia(mass, torch.zeros_like(rot0[..., 0]), i_world)


def _base_motion(like):
    """S_base (6, 6): spatial motion [w; u] of the generalised base
    velocities [v (3), omega (3)]."""
    s = torch.zeros((6, 6), dtype=like.dtype, device=like.device)
    s[3:, 0:3] = torch.eye(3, dtype=like.dtype, device=like.device)
    s[:3, 3:6] = torch.eye(3, dtype=like.dtype, device=like.device)
    return s


def mass_matrix(rot0, q):
    """(B, 16, 16) by the composite-rigid-body algorithm."""
    lk = links(rot0, q)
    bsz = q.shape[0]
    sb = _base_motion(q)
    # composite inertias of each joint's subtree, toe to hip
    comp = torch.flip(torch.cumsum(torch.flip(lk.inertia, [2]), 2), [2])
    total = trunk_inertia(rot0, q) + comp[:, :, 0].sum(1)
    m = q.new_zeros((bsz, 16, 16))
    m[:, :6, :6] = sb.T @ total @ sb
    for leg in range(2):
        for j in range(5):
            r = 6 + 5 * leg + j
            force = comp[:, leg, j] @ lk.motion[:, leg, j, :, None]  # Ic S_j
            m[:, :6, r] = (sb.T @ force)[..., 0]
            m[:, r, :6] = m[:, :6, r]
            for i in range(j + 1):
                c = 6 + 5 * leg + i
                v = (lk.motion[:, leg, i, None, :] @ force)[..., 0, 0]
                m[:, c, r] = v
                m[:, r, c] = v
    return m


def bias_forces(rot0, q, nu, gravity):
    """C(q, nu) nu + G(q), (B, 16), by the recursive Newton-Euler pass at
    zero acceleration.  The base's spatial acceleration holds the
    convective -omega x v (nu's linear part is the trunk origin's material
    velocity) and the upward g that stands for gravity."""
    lk = links(rot0, q)
    sb = _base_motion(q)
    v0 = (sb @ nu[:, :6, None])[..., 0]
    up = torch.zeros_like(v0)
    up[:, 5] = gravity
    a0 = torch.cat([torch.zeros_like(v0[:, :3]),
                    -torch.linalg.cross(nu[:, 3:6], nu[:, 0:3], dim=-1)],
                   -1) + up
    i0 = trunk_inertia(rot0, q)
    f_base = ((i0 @ a0[..., None])[..., 0]
              + cross_force(v0, (i0 @ v0[..., None])[..., 0]))
    taus = q.new_zeros(q.shape)
    qd = nu[:, 6:].reshape(-1, 2, 5)
    for leg in range(2):
        v, a = v0, a0
        forces = []
        for j in range(5):
            s = lk.motion[:, leg, j]
            v = v + s * qd[:, leg, j, None]
            a = a + cross_motion(v, s * qd[:, leg, j, None])
            inert = lk.inertia[:, leg, j]
            forces.append((inert @ a[..., None])[..., 0]
                          + cross_force(v, (inert @ v[..., None])[..., 0]))
        acc = torch.zeros_like(v0)
        for j in range(4, -1, -1):
            acc = acc + forces[j]
            taus[:, leg, j] = (lk.motion[:, leg, j] * acc).sum(-1)
        f_base = f_base + acc
    return torch.cat([(sb.T @ f_base[..., None])[..., 0],
                      taus.reshape(-1, 10)], -1)


def toe_corners(ccfg=CONTACT, like=None):
    """The toe-box corners in the left toe frame, the width scaled and the
    box shifted by the contact configuration."""
    t = _tables(like)['toe']
    return torch.stack([t[:, 0], ccfg.toe_y_offset
                        + ccfg.toe_halfwidth_scale * t[:, 1], t[:, 2]], -1)


def contact_points_and_jac(position, rot0, q, nu, cps=None):
    """World contact points (B, 18, 3): both legs' toe-box corners, the
    trunk box's corners, the knees (the calf joints' origins); their
    velocities (B, 18, 3) and Jacobian (B, 18, 3, 16), column by column
    down the chain."""
    if cps is None:
        cps = toe_corners(like=q)
    lk = links(rot0, q)
    bsz = q.shape[0]
    mirror = q.new_tensor([1.0, -1.0, 1.0])
    rel = []
    for leg in range(2):
        local = cps * mirror if leg else cps
        rel.append(lk.origin[:, leg, 4, None]
                   + (lk.rot[:, leg, 4, None] @ local[..., None])[..., 0])
    corners = (rot0[:, None] @ _tables(q)['trunk_corners'][..., None])[..., 0]
    pts = torch.cat(rel + [corners, lk.origin[:, :, 3]], 1)   # (B, 18, 3)
    jac = q.new_zeros((bsz, N_POINTS, 3, 16))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    jac[..., 0:3] = eye
    for k in range(3):
        jac[..., 3 + k] = torch.linalg.cross(eye[k].expand_as(pts), pts,
                                             dim=-1)
    n_leg = len(TOE_CORNERS)
    for leg in range(2):
        toes = slice(leg * n_leg, (leg + 1) * n_leg)
        knee = N_TOE + 8 + leg
        for j in range(5):
            col = 6 + 5 * leg + j
            a, o = lk.axis[:, leg, j, None], lk.origin[:, leg, j, None]
            jac[:, toes, :, col] = torch.linalg.cross(
                a.expand_as(pts[:, toes]), pts[:, toes] - o, dim=-1)
            if j < 3:
                jac[:, knee, :, col] = torch.linalg.cross(
                    a[:, 0], pts[:, knee] - o[:, 0], dim=-1)
    vels = (jac @ nu[:, None, :, None])[..., 0]
    return pts + position[:, None], vels, jac


def contact_forces(points, vels, anchor, sticking, terrain, ccfg=CONTACT):
    """(spring forces f0 (B, P, 3), damper gains D (B, P, 3), anchors,
    sticking): the penalty law and its stiction anchors."""
    height, length = terrain
    ground = height[:, None] * torch.floor(
        points[..., 0] / torch.clamp(length[:, None], min=1e-3))
    phi = points[..., 2] - ground
    touching = phi < 0
    on = touching.to(points.dtype)
    pen = torch.clamp(-phi, min=0.0, max=ccfg.pen_cap)
    fn = ccfg.k_normal * pen * on
    fn_est = torch.clamp(fn - ccfg.d_normal * vels[..., 2] * on, min=0.0)
    xy = points[..., :2]
    anchor = torch.where((touching & ~sticking)[..., None], xy, anchor)
    ft = -ccfg.k_anchor * (xy - anchor) * on[..., None]
    size = torch.linalg.vector_norm(ft, dim=-1)
    keep = torch.clamp(ccfg.mu * fn_est / torch.clamp(size, min=1e-9),
                       max=1.0)
    ft = ft * keep[..., None]
    slides = (keep < 1.0) & touching
    anchor = torch.where(slides[..., None], xy + ft / ccfg.k_anchor, anchor)
    gains = torch.stack([ccfg.k_tangent * on, ccfg.k_tangent * on,
                         ccfg.d_normal * on], -1)
    return torch.cat([ft, fn[..., None]], -1), gains, anchor, touching


def step(st: State, motor, push, terrain, cfg=DEFAULT_CONFIG,
         ccfg=CONTACT, n_substeps=N_SUBSTEPS) -> State:
    """One control tick: ``n_substeps`` implicit substeps under the servo
    law of ``motor`` (reference/tick.py's MotorCommand), the trunk wrench
    ``push`` (B, 6) and the stairs ``terrain`` (height, length)."""
    pc = cfg.plant
    dt = pc.dt / n_substeps
    bsz = st.q.shape[0]
    lim = st.q.new_tensor(pc.joint_limit)
    a_imp = (motor.kd + pc.joint_damping + dt * motor.kp).reshape(bsz, 10)
    cps = toe_corners(ccfg, st.q)
    for _ in range(n_substeps):
        rot0 = P.rotation(st.quat)
        qd = st.qd.reshape(bsz, 10)
        nu = torch.cat([st.v_world, st.omega_world, qd], -1)
        m = mass_matrix(rot0, st.q)
        bias = bias_forces(rot0, st.q, nu, pc.gravity)
        pts, vels, jac = contact_points_and_jac(st.position, rot0, st.q, nu,
                                                cps)
        f0, gains, anchor, sticking = contact_forces(
            pts, vels, st.anchor, st.sticking, terrain, ccfg)
        tau0 = torch.clamp(motor.kp * (motor.q_des - st.q)
                           + motor.kd * motor.qd_des + motor.tau,
                           -pc.torque_limit, pc.torque_limit)
        jt = jac.reshape(bsz, -1, 16).transpose(-1, -2)        # (B, 16, 3P)
        rhs = (jt @ (f0 - gains * vels).reshape(bsz, -1, 1))[..., 0]
        rhs = rhs + torch.cat([push, tau0.reshape(bsz, 10) - a_imp * qd], -1)
        lhs = m + dt * (jt @ (gains.reshape(bsz, -1, 1)
                              * jac.reshape(bsz, -1, 16)))
        lhs = lhs + torch.diag_embed(torch.cat(
            [torch.zeros_like(nu[:, :6]), dt * a_imp], -1))
        lhs = lhs + 1e-6 * torch.eye(16, dtype=lhs.dtype, device=lhs.device)
        chol, _ = torch.linalg.cholesky_ex(lhs)
        nu_dot = torch.cholesky_solve((rhs - bias)[..., None], chol)[..., 0]

        def capped(x, cap):
            size = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            return x * torch.clamp(cap / torch.clamp(size, min=1e-9),
                                   max=1.0)
        v = capped(st.v_world + dt * nu_dot[:, 0:3], ccfg.v_cap)
        w = capped(st.omega_world + dt * nu_dot[:, 3:6], ccfg.w_cap)
        rate = torch.clamp(st.qd + dt * nu_dot[:, 6:].reshape(bsz, 2, 5),
                           -pc.joint_vel_limit, pc.joint_vel_limit)
        raw = st.q + dt * rate
        rate = torch.where(((raw > lim) & (rate > 0))
                           | ((raw < -lim) & (rate < 0)), 0.0, rate)
        qw, qx, qy, qz = st.quat.unbind(-1)
        ox, oy, oz = w.unbind(-1)
        quat = torch.stack([qw - 0.5 * dt * (ox * qx + oy * qy + oz * qz),
                            qx + 0.5 * dt * (ox * qw + oy * qz - oz * qy),
                            qy + 0.5 * dt * (oy * qw + oz * qx - ox * qz),
                            qz + 0.5 * dt * (oz * qw + ox * qy - oy * qx)],
                           -1)
        st = State(st.position + dt * v,
                   quat / torch.linalg.vector_norm(quat, dim=-1,
                                                   keepdim=True),
                   v, w, torch.clamp(raw, -lim, lim), rate, anchor,
                   sticking)
    return st


def observe(st: State) -> P.PlantState:
    """What the controller sees: the trunk, the joints, each leg's contact
    (any toe-box corner sticking) and foot (the mean of its corners)."""
    rot0 = P.rotation(st.quat)
    pts, _, _ = contact_points_and_jac(st.position, rot0, st.q,
                                       torch.zeros_like(st.q[:, 0, :1])
                                       .expand(-1, 16))
    bsz = st.q.shape[0]
    feet = pts[:, :N_TOE].reshape(bsz, 2, -1, 3).mean(2)
    contact = st.sticking[:, :N_TOE].reshape(bsz, 2, -1).any(-1)
    return P.PlantState(st.position, st.quat, st.v_world, st.omega_world,
                        st.q, st.qd, feet, contact)


def standing(batch, height, dtype, device):
    """Lanes at rest at ``height``, level, in the URDF's zero pose, no
    anchor set."""
    z = torch.zeros((batch, 3), dtype=dtype, device=device)
    position = z.clone()
    position[:, 2] = height
    quat = torch.zeros((batch, 4), dtype=dtype, device=device)
    quat[:, 0] = 1.0
    q = torch.zeros((batch, 2, 5), dtype=dtype, device=device)
    return State(position, quat, z.clone(), z.clone(), q, q.clone(),
                 torch.zeros((batch, N_POINTS, 2), dtype=dtype,
                             device=device),
                 torch.zeros((batch, N_POINTS), dtype=torch.bool,
                             device=device))


def period(carry: R.Carry, st: State, cmd: R.Command, push,
           cfg=DEFAULT_CONFIG, ccfg=CONTACT, n_substeps=N_SUBSTEPS):
    """One MPC period on the articulated plant: (carry', plant', the first
    tick).  A lane whose plant went non-finite keeps its state, turns
    passive and counts the ticks."""
    terrain = (cmd.terrain_step_height, cmd.terrain_step_length)
    c, p, first = carry, st, None
    for k in range(cfg.mpc.mpc_cadence):
        t = R.controller_tick(c, observe(p), cmd, k == 0, cfg)
        first = t if k == 0 else first
        p = step(p, t.motor, push, terrain, cfg, ccfg, n_substeps)
        c = t.carry

    def finite(x):
        return torch.isfinite(x.reshape(x.shape[0], -1)).all(1)
    ok = finite(p.position) & finite(p.v_world) & finite(p.quat) \
        & finite(p.q)
    mode = torch.where(ok, c.mode, torch.full_like(c.mode, R.PASSIVE))
    carry_out = R._keep_where(ok, c, carry)._replace(mode=mode, tick=c.tick)
    return carry_out, R._keep_where(ok, p, st), first
