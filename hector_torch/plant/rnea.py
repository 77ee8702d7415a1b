"""World-frame recursive Newton-Euler dynamics for the articulated Hector
(port of ``hector/plant/rnea.py``).

Forward dynamics by the unit-acceleration (inverse-dynamics) method:

    tau_req(q, nu, nu_dot) = M(q) nu_dot + C(q, nu) nu + G(q)
    => M columns = rnea(q, nu=0, nu_dot=e_k, g=0)   (16 motions)
       bias      = rnea(q, nu, nu_dot=0, g)
       nu_dot    = M^-1 (Q_applied - bias)

Generalized coordinates (16): [v_world (3) of the trunk origin (= the trunk
com), omega_world (3), qd (10)], all in the world frame with point
kinematics (rotations, cross products, the lumped inertials of
``model.py``).

Where the JAX package vmaps a pass over unit vectors, the port stacks the
motions on one batch dimension K: tensors are (B, K, ...), legs on a
dimension of their own and the five joints of a leg in a Python loop, so a
pass costs the same number of launches for one motion or 33.  The
geometry (link rotations, origins, axes, coms) depends on q alone and is
computed once.  ``dynamics`` runs the mass matrix, the bias forces and the
contact Jacobian of one state as a single pass of 33 motions: the plant's
step makes one call, not three.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constant
from . import model as mdl

_LEGS = mdl.stacked_leg_models()
N_DOF = 16


def _skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


# Rodrigues about each (unit, constant) joint axis: I + s K + (1 - c) K K
_AXIS_K = np.array([[_skew(a) for a in leg] for leg in _LEGS['axis']])
_AXIS_KK = _AXIS_K @ _AXIS_K


def _const(name, values, like):
    return constant(('rnea', name), values, like)


def _leg(name, like):
    return _const(name, _LEGS[name], like)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(m, v):
    """m @ v on the trailing axes, broadcasting the leading ones."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


class Geometry(NamedTuple):
    """Per link (B, 2 legs, 5 joints, ...), world frame."""

    rot: torch.Tensor          # (..., 3, 3) link rotation
    org: torch.Tensor          # (..., 3) joint origin
    d: torch.Tensor            # (..., 3) parent rotation @ joint offset
    ax_w: torch.Tensor         # (..., 3) joint axis
    rc: torch.Tensor           # (..., 3) link com


def _geometry(base_pos, base_rot, q) -> Geometry:
    offs, pre = _leg('offset', q), _leg('pre', q)
    axis, coms = _leg('axis', q), _leg('com', q)
    c, s = torch.cos(q), torch.sin(q)                       # (B, 2, 5)
    r_axis = ((_const('eye3', np.eye(3), q)
               + s[..., None, None] * _const('axis_k', _AXIS_K, q))
              + (1 - c)[..., None, None] * _const('axis_kk', _AXIS_KK, q))
    bsz = q.shape[0]
    rot_p = base_rot[:, None].expand(bsz, 2, 3, 3)
    org_p = base_pos[:, None].expand(bsz, 2, 3)
    out = []
    for j in range(5):
        d = _mv(rot_p, offs[:, j])
        org = org_p + d
        rp_pre = rot_p @ pre[:, j]
        rot = rp_pre @ r_axis[:, :, j]
        out.append((rot, org, d, _mv(rp_pre, axis[:, j]),
                    org + _mv(rot, coms[:, j])))
        rot_p, org_p = rot, org
    return Geometry(*[torch.stack(x, dim=2) for x in zip(*out)])


def fk_chain(base_pos, base_rot, q):
    """World pose of every link: (rot (B,2,5,3,3), origin (B,2,5,3),
    com (B,2,5,3)).  q: (B, 2, 5) joint angles."""
    geo = _geometry(base_pos, base_rot, q)
    return geo.rot, geo.org, geo.rc


def _motion(geo: Geometry, nu, nu_dot):
    """Per link angular velocity, angular acceleration and com acceleration
    for K motions: nu, nu_dot (B, K, 16) -> three (B, K, 2, 5, 3)."""
    bsz, k = nu.shape[:2]
    w_p, wd_p = nu[:, :, None, 3:6], nu_dot[:, :, None, 3:6]
    ao_p = nu_dot[:, :, None, 0:3]
    qd = nu[..., 6:].reshape(bsz, k, 2, 5, 1)
    qdd = nu_dot[..., 6:].reshape(bsz, k, 2, 5, 1)
    ws, wds, a_coms = [], [], []
    for j in range(5):
        d, ax = geo.d[:, None, :, j], geo.ax_w[:, None, :, j]
        # acceleration of the joint origin (a point on the parent body)
        ao = ao_p + _cross(wd_p, d) + _cross(w_p, _cross(w_p, d))
        w = w_p + ax * qd[:, :, :, j]
        wd = (wd_p + ax * qdd[:, :, :, j]
              + _cross(w_p, ax) * qd[:, :, :, j])
        r = geo.rc[:, None, :, j] - geo.org[:, None, :, j]
        a_coms.append(ao + _cross(wd, r) + _cross(w, _cross(w, r)))
        ws.append(w)
        wds.append(wd)
        w_p, wd_p, ao_p = w, wd, ao
    return (torch.stack(ws, dim=3), torch.stack(wds, dim=3),
            torch.stack(a_coms, dim=3))


def _kinematics(base_pos, base_rot, q, nu, nu_dot):
    """Forward pass: per link (rot, org, com, omega, omega_dot, a_com,
    axis_w); nu, nu_dot (B, K, 16), the motion quantities (B, K, 2, 5, 3),
    the geometry (B, 2, 5, ...)."""
    geo = _geometry(base_pos, base_rot, q)
    w, wd, a_com = _motion(geo, nu, nu_dot)
    return geo.rot, geo.org, geo.rc, w, wd, a_com, geo.ax_w


def _gravity_vectors(gravity, like):
    """(B, K, 3) world gravity vectors [0, 0, -g] for a scalar g or one g
    per motion (K,)."""
    g_vec = torch.zeros_like(like[..., 0:3])
    g_vec[..., 2] = -gravity
    return g_vec


def _rnea(geo: Geometry, base_pos, base_rot, nu, nu_dot, w, wd, a_com,
          gravity):
    """The backward pass: required generalized forces (B, K, 16)."""
    mass, inert = _leg('mass', nu), _leg('inertia', nu)
    g_vec = _gravity_vectors(gravity, nu)                    # (B, K, 3)

    # trunk body
    w0, wd0, a0 = nu[..., 3:6], nu_dot[..., 3:6], nu_dot[..., 0:3]
    i0 = (base_rot @ _const('trunk_inertia', mdl.TRUNK_INERTIA, nu)
          @ base_rot.transpose(-1, -2))[:, None]
    f_trunk = mdl.TRUNK_MASS * (a0 - g_vec)
    t_trunk = _mv(i0, wd0) + _cross(w0, _mv(i0, w0))

    # per-link Newton-Euler about each com
    i_w = (geo.rot @ inert @ geo.rot.transpose(-1, -2))[:, None]
    f = mass[..., None] * (a_com - g_vec[:, :, None, None, :])
    t = _mv(i_w, wd) + _cross(w, _mv(i_w, w))

    # backward pass: the subtree wrench about each joint origin
    org, rc = geo.org[:, None], geo.rc[:, None]
    f_sub = torch.zeros_like(f[:, :, :, 0])                  # (B, K, 2, 3)
    t_sub = torch.zeros_like(f_sub)
    p_ref = org[:, :, :, 4]
    taus = [None] * 5
    for j in range(4, -1, -1):
        o = org[:, :, :, j]
        t_sub = t_sub + _cross(p_ref - o, f_sub)
        f_sub = f_sub + f[:, :, :, j]
        t_sub = (t_sub + t[:, :, :, j]
                 + _cross(rc[:, :, :, j] - o, f[:, :, :, j]))
        taus[j] = torch.sum(geo.ax_w[:, None, :, j] * t_sub, dim=-1)
        p_ref = o

    # base wrench: trunk + both legs' subtree wrenches about the base origin
    f_base = f_trunk + (f_sub[:, :, 0] + f_sub[:, :, 1])
    t_base = t_trunk
    for leg in range(2):
        t_base = (t_base + t_sub[:, :, leg]
                  + _cross(p_ref[:, :, leg] - base_pos[:, None],
                           f_sub[:, :, leg]))
    bsz, k = nu.shape[:2]
    return torch.cat([f_base, t_base,
                      torch.stack(taus, dim=-1).reshape(bsz, k, 10)], dim=-1)


def rnea(base_pos, base_rot, q, nu, nu_dot, gravity):
    """Required generalized forces for the given motion: nu, nu_dot (B, 16)
    -> (B, 16), or (B, K, 16) -> (B, K, 16).  gravity: the magnitude (0 for
    mass-matrix columns)."""
    single = nu.dim() == 2
    if single:
        nu, nu_dot = nu[:, None], nu_dot[:, None]
    geo = _geometry(base_pos, base_rot, q)
    tau = _rnea(geo, base_pos, base_rot, nu, nu_dot,
                *_motion(geo, nu, nu_dot), gravity)
    return tau[:, 0] if single else tau


def _unit_motions(like):
    """(B, 16, 16): the 16 unit vectors on every lane."""
    eye = _const('eye16', np.eye(N_DOF), like)
    return eye.expand(like.shape[0], N_DOF, N_DOF)


def mass_matrix(base_pos, base_rot, q):
    """(B, 16, 16) generalized mass matrix via unit accelerations."""
    eye = _unit_motions(base_pos)
    cols = rnea(base_pos, base_rot, q, torch.zeros_like(eye), eye, 0.0)
    return cols.transpose(-1, -2)


def bias_forces(base_pos, base_rot, q, nu, gravity):
    """C(q, nu) nu + G(q): (B, 16)."""
    return rnea(base_pos, base_rot, q, nu, torch.zeros_like(nu), gravity)


# Trunk collision-box corners in the trunk frame (robot.xacro:49-54,
# const.xacro 0.125 x 0.19 x 0.248): a falling tier-2 body lands on them.
TRUNK_CORNERS = np.array(
    [[sx * 0.0625, sy * 0.095, sz * 0.124]
     for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)])
N_BODY_POINTS = len(TRUNK_CORNERS) + 2   # + one knee point per leg


def _toe_offsets(geo: Geometry, cps):
    """Both legs' toe-frame contact offsets in the world frame (B, 2, P/2,
    3); cps (P/2, 3) in the LEFT toe frame, mirrored in y for the right."""
    mirror = _const('mirror_y', [1.0, -1.0, 1.0], cps)
    cps2 = torch.stack([cps, cps * mirror])
    return _mv(geo.rot[:, :, 4, None], cps2)


def _contact_points(geo: Geometry, base_pos, base_rot, rel, include_body):
    bsz = base_pos.shape[0]
    pts = (geo.org[:, :, 4, None] + rel).reshape(bsz, -1, 3)
    if not include_body:
        return pts, None
    rc_trunk = _mv(base_rot[:, None], _const('trunk_corners', TRUNK_CORNERS,
                                             base_pos))
    return torch.cat([pts, base_pos[:, None] + rc_trunk, geo.org[:, :, 3]],
                     dim=1), rc_trunk


def _point_velocities(geo: Geometry, base_pos, nu, w, rel, rc_trunk):
    """World velocities (B, K, P, 3) of the contact points under K motions
    nu (B, K, 16) whose link angular velocities are w (B, K, 2, 5, 3)."""
    bsz, k = nu.shape[:2]
    v0, w0 = nu[..., 0:3], nu[..., 3:6]
    v_p, w_p = v0[:, :, None], w0[:, :, None]
    org_p = base_pos[:, None, None]
    v_orgs = []
    # the velocity of each joint origin, propagated down the chain
    for j in range(5):
        o = geo.org[:, None, :, j]
        v_p = v_p + _cross(w_p, o - org_p)
        v_orgs.append(v_p)
        w_p, org_p = w[:, :, :, j], o
    vp = (v_orgs[4][:, :, :, None]
          + _cross(w[:, :, :, 4, None], rel[:, None])).reshape(bsz, k, -1, 3)
    if rc_trunk is None:
        return vp
    vp_trunk = v0[:, :, None] + _cross(w0[:, :, None], rc_trunk[:, None])
    return torch.cat([vp, vp_trunk, v_orgs[3]], dim=2)


def default_contact_points(like):
    """The toe-box corners (model.CONTACT_POINTS_TOE) on like's device."""
    return _const('contact_points_toe', mdl.CONTACT_POINTS_TOE, like)


def contact_points_and_jac(base_pos, base_rot, q, nu, cps=None,
                           include_body: bool = False):
    """World contact points (B, P, 3), their velocities (B, P, 3) and the
    contact Jacobian (B, P, 3, 16) from unit generalized velocities
    (P = 2 legs x len(cps) [+ N_BODY_POINTS]).

    cps: optional (P/2, 3) toe-frame contact offsets overriding the URDF
    box corners; include_body: append the trunk-box corners and the knee
    (calf-origin) points after the toe points."""
    if cps is None:
        cps = default_contact_points(base_pos)
    geo = _geometry(base_pos, base_rot, q)
    rel = _toe_offsets(geo, cps)
    pts, rc_trunk = _contact_points(geo, base_pos, base_rot, rel,
                                    include_body)
    motions = torch.cat([nu[:, None], _unit_motions(nu)], dim=1)
    w, _, _ = _motion(geo, motions, torch.zeros_like(motions))
    vels = _point_velocities(geo, base_pos, motions, w, rel, rc_trunk)
    return pts, vels[:, 0], vels[:, 1:].permute(0, 2, 3, 1)


def contact_points(base_pos, base_rot, q, cps=None):
    """The toe-box contact points (B, 2 x len(cps), 3) alone: the points of
    contact_points_and_jac, without the velocity passes."""
    if cps is None:
        cps = default_contact_points(base_pos)
    geo = _geometry(base_pos, base_rot, q)
    return _contact_points(geo, base_pos, base_rot, _toe_offsets(geo, cps),
                           False)[0]


def dynamics(base_pos, base_rot, q, nu, gravity, cps=None,
             include_body: bool = False):
    """What one substep of the plant needs, in one pass of 33 motions: the
    mass matrix (B, 16, 16), the bias forces (B, 16), and the contact
    points, their velocities and Jacobian (contact_points_and_jac).

    Motions: 16 unit accelerations at rest (the mass matrix's columns,
    no gravity), the state's own velocity at zero acceleration (the bias
    forces under gravity, and the points' velocities), 16 unit velocities
    (the Jacobian's columns).  Each quantity is what mass_matrix,
    bias_forces and contact_points_and_jac compute."""
    if cps is None:
        cps = default_contact_points(base_pos)
    eye = _unit_motions(nu)
    zero = torch.zeros_like(eye)
    motions = torch.cat([zero, nu[:, None], eye], dim=1)           # (B, 33, 16)
    accels = torch.cat([eye, torch.zeros_like(nu[:, None]), zero], dim=1)
    geo = _geometry(base_pos, base_rot, q)
    w, wd, a_com = _motion(geo, motions, accels)
    g = _const(('gravity_by_motion', gravity), [0.0] * N_DOF + [gravity], nu)
    tau = _rnea(geo, base_pos, base_rot, motions[:, :17], accels[:, :17],
                w[:, :17], wd[:, :17], a_com[:, :17], g)
    rel = _toe_offsets(geo, cps)
    pts, rc_trunk = _contact_points(geo, base_pos, base_rot, rel,
                                    include_body)
    vels = _point_velocities(geo, base_pos, motions[:, 16:], w[:, 16:], rel,
                             rc_trunk)
    return (tau[:, :16].transpose(-1, -2), tau[:, 16], pts, vels[:, 0],
            vels[:, 1:].permute(0, 2, 3, 1))
