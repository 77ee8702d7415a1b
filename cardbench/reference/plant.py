"""The reference's tier-1 plant: one rigid body on two legs, a 1 ms step.

The model the configuration runs (hector_torch's plant.srb, described in
docs/DESIGN.md section 4), written out again from its equations: the
lumped body takes the commanded stance wrench, scaled down where a leg's
torques would pass the joint limit, plus a unilateral spring-damper on
each stance foot's penetration and on a trunk sphere, with each foot's
shear capped by the ground's friction; moments about the stance anchors;
semi-implicit Euler for the body and an explicit quaternion step; the
legs follow their targets (the stance foot's anchor through the inverse
kinematics, the swing foot's joint set-point) as first-order servos,
limp joints decay through their damping; a foot that touches down is
anchored where it lands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import legs
from .config import JOINT_OFFSETS


class PlantState(NamedTuple):
    position: torch.Tensor     # (B, 3) world CoM
    quat: torch.Tensor         # (B, 4) wxyz, body to world
    v_world: torch.Tensor      # (B, 3)
    omega_world: torch.Tensor  # (B, 3)
    q: torch.Tensor            # (B, 2, 5) raw motor angles
    qd: torch.Tensor           # (B, 2, 5)
    foot_anchor: torch.Tensor  # (B, 2, 3) world stance anchors
    contact: torch.Tensor      # (B, 2) bool, the last step's contact


def rotation(quat):
    """Body-to-world rotation of unit quaternions (..., 4) wxyz."""
    w, x, y, z = quat.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def hip_yaw(cfg, like):
    """(2, 3) hip-yaw joints in the body frame (Biped.h)."""
    r = cfg.robot
    return like.new_tensor([[r.hip_yaw_x, r.hip_yaw_y, r.hip_yaw_z],
                            [r.hip_yaw_x, -r.hip_yaw_y, r.hip_yaw_z]])


def hip_width(cfg, like):
    """(2, 3) hip-width shift of a foot target (SwingLegController.cpp:146)."""
    x, y = cfg.swing.hip_width_offset_x, cfg.swing.hip_width_offset_y
    return like.new_tensor([[x, -y, 0.0], [x, y, 0.0]])


def feet_world(position, rot, q, cfg):
    """The feet (B, 2, 3) in the world by the foot-position expression."""
    p_leg, _ = legs.foot_and_jacobian(q)
    local = hip_yaw(cfg, position) + p_leg
    return position[:, None, :] + torch.einsum('bij,blj->bli', rot, local)


def standing(batch, cfg, dtype, device):
    """Lanes standing still at zero raw motor angles, feet on the ground."""
    q = torch.zeros((batch, 2, 5), dtype=dtype, device=device)
    p_leg, _ = legs.foot_and_jacobian(q)
    height = -(cfg.robot.hip_yaw_z + p_leg[:, 0, 2])
    zero = torch.zeros_like(height)
    position = torch.stack([zero, zero, height], -1)
    anchor = position[:, None, :] + hip_yaw(cfg, q) + p_leg
    anchor = torch.cat([anchor[..., :2], torch.zeros_like(anchor[..., 2:])],
                       -1)
    quat = torch.zeros((batch, 4), dtype=dtype, device=device)
    quat[:, 0] = 1.0
    return PlantState(position, quat, torch.zeros_like(position),
                      torch.zeros_like(position), q, torch.zeros_like(q),
                      anchor, torch.ones((batch, 2), dtype=torch.bool,
                                         device=device))


def _ground(x, terrain):
    height, length = terrain
    return height * torch.floor(x / torch.clamp(length, min=1e-3))


def step(st, motor, wrench, stance, push, terrain, cfg):
    """One step.  motor: the tick's MotorCommand; wrench (B, 2, 6) world
    [force, moment] a stance leg is asked for; stance (B, 2) bool; push
    (B, 6) a world [force, torque] on the body; terrain (height (B,),
    length (B,)) of the stairs h(x) = height floor(x / length)."""
    pc = cfg.plant
    dt = pc.dt
    on = stance.to(wrench.dtype)
    rot = rotation(st.quat)
    vz = st.v_world[:, 2]

    # the wrench as far as the joints can give it
    _, jac = legs.foot_and_jacobian(st.q)
    body = -torch.einsum('bji,blkj->blki', rot,
                         wrench.reshape(-1, 2, 2, 3)).reshape(-1, 2, 6)
    tau = torch.einsum('blkj,blk->blj', jac, body)
    peak = tau.abs().amax(-1)
    scale = torch.clamp(pc.torque_limit / torch.clamp(peak, min=1e-6),
                        max=1.0)
    w = wrench * (scale * on)[..., None]

    # ground: each stance foot, and the trunk as a backstop
    foot = feet_world(st.position, rot, st.q, cfg)
    depth = _ground(foot[..., 0], (terrain[0][:, None], terrain[1][:, None])) \
        - foot[..., 2]
    normal = torch.clamp(pc.contact_kp * depth - pc.contact_kd * vz[:, None],
                         min=0.0) * on * (depth > 0)
    depth_t = _ground(st.position[:, 0], terrain) + pc.trunk_radius \
        - st.position[:, 2]
    normal_t = torch.clamp(pc.contact_kp * depth_t - pc.contact_kd * vz,
                           min=0.0) * (depth_t > 0)

    # the shear a foot can hold
    fz = w[..., 2] + normal
    shear = torch.sqrt(w[..., 0] ** 2 + w[..., 1] ** 2)
    keep = torch.clamp(pc.ground_mu * torch.clamp(fz, min=0.0)
                       / torch.clamp(shear, min=1e-9), max=1.0)
    grf = torch.stack([w[..., 0] * keep, w[..., 1] * keep, fz], -1)
    grm = w[..., 3:6]

    force = grf.sum(1) + push[:, :3]
    force = force + torch.stack([torch.zeros_like(normal_t),
                                 torch.zeros_like(normal_t), normal_t], -1)
    arm = st.foot_anchor - st.position[:, None, :]
    torque = (torch.linalg.cross(arm, grf) + grm).sum(1) + push[:, 3:6]

    inertia = rot @ torch.diag(wrench.new_tensor(pc.inertia_body)) \
        @ rot.transpose(-1, -2)
    om = st.omega_world
    gyro = torch.linalg.cross(om, (inertia @ om[..., None])[..., 0])
    om_dot = torch.linalg.solve(inertia, torque - gyro)

    gravity = wrench.new_tensor([0.0, 0.0, -pc.gravity])
    v = st.v_world + dt * (force / pc.mass + gravity)
    p = st.position + dt * v
    om = om + dt * om_dot
    qw, qx, qy, qz = st.quat.unbind(-1)
    ox, oy, oz = om.unbind(-1)
    quat = torch.stack([qw - 0.5 * dt * (ox * qx + oy * qy + oz * qz),
                        qx + 0.5 * dt * (ox * qw + oy * qz - oz * qy),
                        qy + 0.5 * dt * (oy * qw + oz * qx - ox * qz),
                        qz + 0.5 * dt * (oz * qw + ox * qy - oy * qx)], -1)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    rot_new = rotation(quat)

    # the legs
    anchor_body = torch.einsum('bji,blj->bli', rot_new,
                               st.foot_anchor - p[:, None, :]) \
        + hip_width(cfg, p)
    q_stance = legs.inverse_kinematics(anchor_body,
                                       st.q + st.q.new_tensor(JOINT_OFFSETS))
    target = torch.where(stance[..., None], q_stance, motor.q_des)
    servo = torch.clamp((target - st.q) / pc.joint_tracking_tau,
                        -pc.joint_vel_limit, pc.joint_vel_limit)
    limp = st.qd / (1.0 + dt * motor.kd / pc.swing_joint_inertia)
    qd = torch.where((motor.kp > 0) | stance[..., None], servo, limp)
    q = st.q + dt * qd

    # touchdown
    foot = feet_world(p, rot_new, q, cfg)
    landed = torch.stack([foot[..., 0], foot[..., 1],
                          _ground(foot[..., 0], (terrain[0][:, None],
                                                 terrain[1][:, None]))], -1)
    down = stance & ~st.contact
    anchor = torch.where(down[..., None], landed, st.foot_anchor)
    return PlantState(p, quat, v, om, q, qd, anchor, stance)
