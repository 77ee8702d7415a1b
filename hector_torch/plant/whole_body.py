"""Tier-2 plant: full articulated dynamics (11 lumped bodies, 16 DoF) with
penalty ground contact (port of ``hector/plant/whole_body.py``).

Joint servos produce torques, RNEA-based forward dynamics produce
accelerations, and ground reactions come from a spring-damper contact
model at the toe-box corners (plus the trunk-box corners and knees, so a
fall ends on the ground).  The stiff terms (the joint servos' kd and kp
dt, the contact dampers) are integrated implicitly, folded into the
mass-matrix solve, which keeps Gazebo-level gains stable at dt = 0.25 ms.

Every tensor carries the lane batch as its leading dimension B.  ``step``
synchronises with no card: its constants are cached on the device, and
the 16x16 solve is ``torch.linalg.solve_ex``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constant, resolve_device
from ..config import HectorConfig, DEFAULT_CONFIG
from .. import math as hm
from . import rnea
from .model import CONTACT_POINTS_TOE
from .srb import terrain_height

N_TOE = 2 * len(CONTACT_POINTS_TOE)       # both legs' toe-box corners
# + the trunk-box corners and knee points; the toe points come first, so
# per-leg slices of [:N_TOE] are those of the toe box alone
N_CONTACT = N_TOE + rnea.N_BODY_POINTS

# Height of the reference FK foot point (LegController.cpp:190-194,
# kinematics.foot_position) above the ground plane when the toe box rests
# flat: the FK chain ends mid-toe (l_toe = 0.036) while the toe collision
# box's sole sits 0.04 below the toe frame.  The contact-aided KF's
# foot-height measurement on this plant (ground_z).
FK_FOOT_CLEARANCE = 0.0682


class WholeBodyState(NamedTuple):
    position: torch.Tensor     # (B, 3) trunk origin (== trunk com), world
    quat: torch.Tensor         # (B, 4) wxyz
    v_world: torch.Tensor      # (B, 3)
    omega_world: torch.Tensor  # (B, 3)
    q: torch.Tensor            # (B, 2, 5) joint angles (URDF zero config)
    qd: torch.Tensor           # (B, 2, 5)
    anchor: torch.Tensor       # (B, P, 2) xy stiction anchors per point
    sticking: torch.Tensor     # (B, P) bool: anchor valid


class ContactConfig(NamedTuple):
    """Contact gains at the reference's Gazebo levels (gazebo.xacro: kp =
    1e5, kd = 1e3+, toe mu1 = 1); the dampers are integrated implicitly."""

    k_normal: float = 1.0e5    # N/m ground stiffness (gazebo kp)
    d_normal: float = 2.0e3    # N s/m (implicit)
    mu: float = 1.0            # toe friction (gazebo mu1)
    k_anchor: float = 2.0e4    # N/m stiction spring toward the anchor
    k_tangent: float = 2.0e3   # N s/m tangential damping (implicit)
    # energy backstops for violent impacts (ODE's contact_max_correcting_vel
    # and contact_surface_layer): the spring saturates at pen_cap, base
    # velocities are clamped far outside the walking envelope
    pen_cap: float = 0.02      # m, spring saturation depth (2000 N/point)
    v_cap: float = 10.0        # m/s
    w_cap: float = 30.0        # rad/s
    # contact-geometry sensitivity axes: the toe-box corner y spacing scale
    # (1 = the URDF's 2 cm) and an outboard shift of the box per leg (the
    # URDF's toe_y = TOE_BOX_Y_CENTER, modeled as 0 in production)
    toe_halfwidth_scale: float = 1.0
    toe_y_offset: float = 0.0


def init_whole_body_state(height: float = 0.55, batch: int = 1,
                          dtype=torch.float32,
                          device='cuda') -> WholeBodyState:
    """``batch`` lanes at rest at ``height``, level, in the URDF zero
    configuration."""
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros((batch,) + shape, dtype=dt, device=dev)

    position = zeros(3)
    position[:, 2] = height
    quat = zeros(4)
    quat[:, 0] = 1.0
    return WholeBodyState(
        position=position, quat=quat, v_world=zeros(3),
        omega_world=zeros(3), q=zeros(2, 5), qd=zeros(2, 5),
        anchor=zeros(N_CONTACT, 2), sticking=zeros(N_CONTACT, dt=torch.bool))


def contact_forces(points, vels, anchor, sticking, terrain,
                   ccfg: ContactConfig):
    """(spring forces f0 (B, P, 3), implicit damping gains d (B, P, 3),
    new anchor, new sticking).

    Normal: an explicit spring and a damper returned as a gain (the caller
    folds it into the mass-matrix solve).  Tangential: an anchored stiction
    spring, clipped to the friction cone of the normal-force estimate; on
    saturation the anchor slides to the cone boundary (stick/slip)."""
    if terrain is not None:
        ground = terrain_height(points[..., 0], terrain[0][:, None],
                                terrain[1][:, None])
    else:
        ground = torch.zeros_like(points[..., 0])
    phi = points[..., 2] - ground
    pen = torch.clamp(torch.clamp(-phi, min=0.0), max=ccfg.pen_cap)
    in_contact = phi < 0
    in_c = in_contact.to(points.dtype)
    fn_spring = ccfg.k_normal * pen * in_c
    # conservative normal-force estimate for the friction cone
    fn_est = torch.clamp(fn_spring - ccfg.d_normal * vels[..., 2] * in_c,
                         min=0.0)

    anchor = torch.where((in_contact & ~sticking)[..., None],
                         points[..., :2], anchor)
    ft = -ccfg.k_anchor * (points[..., :2] - anchor) * in_c[..., None]
    ft_norm = torch.sqrt(torch.sum(ft * ft, dim=-1, keepdim=True))
    ft_max = ccfg.mu * fn_est[..., None]
    scale = torch.clamp(ft_max / torch.clamp(ft_norm, min=1e-9), max=1.0)
    ft = ft * scale
    # slipping: drag the anchor so that the spring sits on the cone boundary
    slipped = (scale[..., 0] < 1.0) & in_contact
    anchor = torch.where(slipped[..., None],
                         points[..., :2] + ft / ccfg.k_anchor, anchor)

    f0 = torch.cat([ft, fn_spring[..., None]], dim=-1)
    gains = torch.stack([ccfg.k_tangent * in_c, ccfg.k_tangent * in_c,
                         ccfg.d_normal * in_c], dim=-1)
    return f0, gains, anchor, in_contact


def _contact_offsets(ccfg: ContactConfig, like):
    """The toe-box corners in the LEFT toe frame, their y spread scaled by
    toe_halfwidth_scale and shifted by toe_y_offset."""
    cps0 = rnea.default_contact_points(like)
    return torch.stack([cps0[:, 0],
                        ccfg.toe_y_offset + ccfg.toe_halfwidth_scale
                        * cps0[:, 1], cps0[:, 2]], dim=-1)


def step(state: WholeBodyState, cmd, cfg: HectorConfig = DEFAULT_CONFIG,
         terrain=None, disturbance=None,
         ccfg: ContactConfig = ContactConfig(),
         n_substeps: int = 4) -> WholeBodyState:
    """One 1 ms control tick = ``n_substeps`` dynamics substeps.

    cmd: MotorCommand, (B, 2, 5) fields; the servo law and the +-33.5 N m
    clamp of the Gazebo joint plugin (joint_controller.cpp:139-224).
    terrain: optional (step_height, step_length), (B,) each; disturbance:
    optional (B, 6) world wrench on the trunk.
    """
    pcfg = cfg.plant
    dt = pcfg.dt / n_substeps
    cps = _contact_offsets(ccfg, state.position)
    q_lim = constant(('joint_limit', pcfg.joint_limit), pcfg.joint_limit,
                     state.position)
    bsz = state.position.shape[0]
    # the servo law split for the implicit step:
    #   tau = tau0 - A qd+  with  tau0 = kp (q* - q) + kd dq* + tau_ff,
    #                             A    = kd + damping + dt kp,
    # the qd+ term folded into the mass matrix's diagonal (the toe joint's
    # ~2e-4 kg m^2 makes an explicit PD at kp ~ 300 diverge)
    a_imp = (cmd.kd + pcfg.joint_damping + dt * cmd.kp).reshape(bsz, 10)
    eye16 = constant(('eye', 16), lambda: np.eye(16), state.position)
    s = state
    for _ in range(n_substeps):
        rot = hm.quat_to_rot(s.quat)
        tau0 = cmd.kp * (cmd.q_des - s.q) + cmd.kd * cmd.qd_des + cmd.tau
        tau0 = torch.clamp(tau0, -pcfg.torque_limit, pcfg.torque_limit)
        qd = s.qd.reshape(bsz, 10)
        nu = torch.cat([s.v_world, s.omega_world, qd], dim=-1)
        m, bias, pts, vels, jac = rnea.dynamics(
            s.position, rot, s.q, nu, pcfg.gravity, cps=cps,
            include_body=True)
        f0, d_gain, anchor, sticking = contact_forces(
            pts, vels, s.anchor, s.sticking, terrain, ccfg)
        # implicit contact damping: f_c = f0 - D (v + dt J nu_dot)
        jac = jac.reshape(bsz, -1, 16)
        q_contact = hm.rmatvec(jac, (f0 - d_gain * vels).reshape(bsz, -1))
        q_applied = torch.cat([torch.zeros_like(nu[:, 0:6]),
                               tau0.reshape(bsz, 10) - a_imp * qd],
                              dim=-1) + q_contact
        if disturbance is not None:
            q_applied = torch.cat([q_applied[:, 0:6] + disturbance,
                                   q_applied[:, 6:]], dim=-1)
        m = m + torch.diag_embed(torch.cat(
            [torch.zeros_like(nu[:, 0:6]), dt * a_imp], dim=-1))
        # dt J^T D J on the left-hand side (unconditionally stable damping)
        m = m + dt * (jac.transpose(-1, -2)
                      @ (d_gain.reshape(bsz, -1, 1) * jac))
        nu_dot = torch.linalg.solve_ex(m + 1e-6 * eye16,
                                       q_applied - bias)[0]

        v_new = s.v_world + dt * nu_dot[:, 0:3]
        w_new = s.omega_world + dt * nu_dot[:, 3:6]
        # the base-velocity energy backstop (ContactConfig.v_cap, w_cap)
        v_new = v_new * torch.clamp(ccfg.v_cap / torch.clamp(
            torch.linalg.vector_norm(v_new, dim=-1, keepdim=True), min=1e-9),
            max=1.0)
        w_new = w_new * torch.clamp(ccfg.w_cap / torch.clamp(
            torch.linalg.vector_norm(w_new, dim=-1, keepdim=True), min=1e-9),
            max=1.0)
        qd_new = torch.clamp(s.qd + dt * nu_dot[:, 6:].reshape(bsz, 2, 5),
                             -pcfg.joint_vel_limit, pcfg.joint_vel_limit)
        # the URDF joint limits; a pinned joint also sheds its outward
        # velocity (an inelastic stop), or a phantom qd would feed RNEA
        q_raw = s.q + dt * qd_new
        q_new = torch.clamp(q_raw, -q_lim, q_lim)
        qd_new = torch.where(((q_raw > q_lim) & (qd_new > 0))
                             | ((q_raw < -q_lim) & (qd_new < 0)),
                             torch.zeros_like(qd_new), qd_new)
        s = WholeBodyState(
            position=s.position + dt * v_new,
            quat=hm.quat_integrate(s.quat, w_new, dt),
            v_world=v_new, omega_world=w_new, q=q_new, qd=qd_new,
            anchor=anchor, sticking=sticking)
    return s


def foot_positions(state: WholeBodyState):
    """World toe-box corner contact points (B, 2 legs, P/2 points, 3)."""
    pts = rnea.contact_points(state.position, hm.quat_to_rot(state.quat),
                              state.q)
    return pts.reshape(pts.shape[0], 2, -1, 3)
