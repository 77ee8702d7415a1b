"""Tier-1 batched plant: single-rigid-body dynamics + joint servos +
schedule-driven contact (port of ``hector/plant/srb.py``).

The floating base is one rigid body with the URDF's lumped mass; stance
feet are anchored at touchdown and the commanded ground-reaction wrench acts
on the body, scaled to the joint torque limit; swing legs track their PD
targets through a first-order servo; ground reactions are unilateral
(clipped spring-damper on FK-foot penetration plus a trunk-sphere backstop).
See the JAX module's docstring for the modeling rationale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constant, resolve_device
from ..config import HectorConfig, DEFAULT_CONFIG
from .. import math as hm
from ..kinematics import (foot_position, leg_jacobians, leg_ik,
                          apply_joint_offsets, hip_yaw_locations)
from ..swing import hip_width_offset


class PlantState(NamedTuple):
    position: torch.Tensor     # (B, 3) world CoM
    quat: torch.Tensor         # (B, 4) wxyz body->world
    v_world: torch.Tensor      # (B, 3)
    omega_world: torch.Tensor  # (B, 3)
    q: torch.Tensor            # (B, 2, 5) raw motor angles
    qd: torch.Tensor           # (B, 2, 5)
    foot_anchor: torch.Tensor  # (B, 2, 3) world stance anchors
    contact: torch.Tensor      # (B, 2) bool, previous-tick contact


def nominal_joint_angles(batch: int, dtype=torch.float32,
                         device='cuda') -> torch.Tensor:
    """Raw motor angles (batch, 2, 5) of the nominal knee-bent stance (the
    xacro spawn configuration is near the offset-corrected zero pose)."""
    return torch.zeros((batch, 2, 5), dtype=dtype,
                       device=resolve_device(device))


def init_plant_state(batch: int, cfg: HectorConfig = DEFAULT_CONFIG,
                     height=None, dtype=torch.float32,
                     device='cuda') -> PlantState:
    """``batch`` identical lanes standing with feet on the ground plane at
    the nominal joint angles (all zero raw motor angles)."""
    dev = resolve_device(device)
    q = nominal_joint_angles(batch, dtype, dev)
    p_leg = foot_position(q, cfg)
    hip_yaw = hip_yaw_locations(cfg, q)
    if height is None:
        # stand with feet exactly on the ground plane
        height = -(hip_yaw[0, 2] + p_leg[:, 0, 2])
    else:
        height = torch.full((batch,), float(height), dtype=dtype, device=dev)
    zero = torch.zeros((batch,), dtype=dtype, device=dev)
    position = torch.stack([zero, zero, height], dim=-1)
    anchors = position[:, None, :] + hip_yaw + p_leg
    anchors = torch.cat([anchors[..., :2], torch.zeros_like(anchors[..., 2:])],
                        dim=-1)
    quat = torch.zeros((batch, 4), dtype=dtype, device=dev)
    quat[:, 0] = 1.0
    return PlantState(
        position=position, quat=quat,
        v_world=torch.zeros((batch, 3), dtype=dtype, device=dev),
        omega_world=torch.zeros((batch, 3), dtype=dtype, device=dev),
        q=q, qd=torch.zeros((batch, 2, 5), dtype=dtype, device=dev),
        foot_anchor=anchors,
        contact=torch.ones((batch, 2), dtype=torch.bool, device=dev))


def servo_torque(cmd, q, qd, cfg: HectorConfig):
    """tau = clip(Kp (q*-q) + Kd (dq*-dq) + tau_ff, +-33.5)."""
    tau = cmd.kp * (cmd.q_des - q) + cmd.kd * (cmd.qd_des - qd) + cmd.tau
    return torch.clamp(tau, -cfg.plant.torque_limit, cfg.plant.torque_limit)


def terrain_height(x, step_height, step_length):
    """Stairs heightfield h(x) = step_height * floor(x / step_length);
    step_height = 0 -> flat ground."""
    return step_height * torch.floor(x / torch.clamp(step_length, min=1e-3))


def step(state: PlantState, cmd, wrench_world, contact_sched,
         disturbance=None, terrain=None,
         cfg: HectorConfig = DEFAULT_CONFIG) -> PlantState:
    """One 1 ms physics tick.

    cmd: MotorCommand ((B, 2, 5) arrays); wrench_world: (B, 2, 6) world
    GRF+GRM for stance legs; contact_sched: (B, 2) scheduled contact;
    disturbance: optional (B, 6) world wrench [force, torque] added to the
    body's on this tick (a push); terrain: optional (step_height (B,),
    step_length (B,)).
    """
    dtype = state.position.dtype
    pcfg = cfg.plant
    like = state.position
    dt = constant(('plant.dt', pcfg.dt), pcfg.dt, like)
    mass = constant(('plant.mass', pcfg.mass), pcfg.mass, like)
    g_vec = constant(('gravity_vector', pcfg.gravity),
                     [0.0, 0.0, -pcfg.gravity], like)
    hip_yaw = hip_yaw_locations(cfg, state.position)

    in_contact = contact_sched > 0
    in_f = in_contact.to(dtype)

    # torque-feasibility scaling of the commanded stance wrench
    j_fm, _ = leg_jacobians(state.q, cfg)
    rot = hm.quat_to_rot(state.quat)                   # body->world
    r_body = rot.transpose(-1, -2)                     # world->body
    f_body = torch.cat([-(wrench_world[..., 0:3] @ rot),
                        -(wrench_world[..., 3:6] @ rot)], dim=-1)
    tau_wrench = hm.rmatvec(j_fm, f_body)
    tau_peak = tau_wrench.abs().amax(-1)
    scale = torch.clamp(pcfg.torque_limit / torch.clamp(tau_peak, min=1e-6),
                        max=1.0)
    wrench_eff = wrench_world * (scale * in_f)[..., None]

    # unilateral ground contact on the FK foot's penetration
    fk_foot0 = state.position[:, None, :] + \
        (hip_yaw + foot_position(state.q, cfg)) @ r_body
    if terrain is not None:
        foot_ground0 = terrain_height(fk_foot0[..., 0], terrain[0][:, None],
                                      terrain[1][:, None])
        trunk_ground = terrain_height(state.position[:, 0], terrain[0],
                                      terrain[1])
    else:
        foot_ground0 = torch.zeros_like(fk_foot0[..., 0])
        trunk_ground = torch.zeros_like(state.position[:, 0])
    vz = state.v_world[:, 2]
    pen = foot_ground0 - fk_foot0[..., 2]
    n_foot = torch.clamp(pcfg.contact_kp * pen - pcfg.contact_kd * vz[:, None],
                         min=0.0)
    n_foot = n_foot * in_f * (pen > 0).to(dtype)

    # trunk-sphere backstop
    pen_trunk = trunk_ground + pcfg.trunk_radius - state.position[:, 2]
    n_trunk = torch.clamp(pcfg.contact_kp * pen_trunk - pcfg.contact_kd * vz,
                          min=0.0) * (pen_trunk > 0).to(dtype)

    # plant-side friction clamp on each foot's total shear
    fz_tot = wrench_eff[..., 2] + n_foot
    shear = wrench_eff[..., 0:2]
    shear_mag = torch.sqrt((shear * shear).sum(-1))
    shear_cap = pcfg.ground_mu * torch.clamp(fz_tot, min=0.0)
    shear_scale = torch.clamp(shear_cap / torch.clamp(shear_mag, min=1e-9),
                              max=1.0)
    wrench_eff = torch.cat([wrench_eff[..., 0:2] * shear_scale[..., None],
                            wrench_eff[..., 2:]], dim=-1)

    # --- base dynamics ---
    grf = torch.cat([wrench_eff[..., 0:2],
                     (wrench_eff[..., 2] + n_foot)[..., None]], dim=-1)
    grm = wrench_eff[..., 3:6]
    force = grf.sum(1)
    force = torch.cat([force[:, :2], (force[:, 2] + n_trunk)[:, None]], -1)
    r_arm = state.foot_anchor - state.position[:, None, :]
    torque = (hm.cross(r_arm, grf) + grm).sum(1)
    if disturbance is not None:
        force = force + disturbance[:, 0:3]
        torque = torque + disturbance[:, 3:6]

    i_body = torch.diag(constant(('inertia_body', pcfg.inertia_body),
                                 pcfg.inertia_body, like))
    i_world = rot @ i_body @ r_body
    omega = state.omega_world
    omega_dot = hm.matvec(hm.inv3(i_world), torque - hm.cross(
        omega, hm.matvec(i_world, omega)))

    v_new = state.v_world + dt * (force / mass + g_vec)
    p_new = state.position + dt * v_new                # semi-implicit Euler
    omega_new = omega + dt * omega_dot
    quat_new = hm.quat_integrate(state.quat, omega_new, dt)

    # --- joint kinematics (first-order servo tracking) ---
    rot_new = hm.quat_to_rot(quat_new)
    r_body_new = rot_new.transpose(-1, -2)
    anchor_b = ((state.foot_anchor - p_new[:, None, :]) @ r_body_new.transpose(
        -1, -2) + hip_width_offset(cfg, p_new))
    q_stance = leg_ik(anchor_b, apply_joint_offsets(state.q), cfg)

    has_target = (cmd.kp > 0) | in_contact[..., None]
    q_target = torch.where(in_contact[..., None], q_stance, cmd.q_des)
    track = constant(('joint_tracking_tau', pcfg.joint_tracking_tau),
                     pcfg.joint_tracking_tau, like)
    qd_des = torch.clamp((q_target - state.q) / track,
                         -pcfg.joint_vel_limit, pcfg.joint_vel_limit)
    # limp joints: implicit first-order velocity decay through kd
    qd_limp = state.qd / (1.0 + dt * cmd.kd / pcfg.swing_joint_inertia)
    qd_new = torch.where(has_target, qd_des, qd_limp)
    q_new = state.q + dt * qd_new

    # --- contact transitions: anchor at touchdown ---
    p_leg = foot_position(q_new, cfg)
    fk_foot = p_new[:, None, :] + (hip_yaw + p_leg) @ rot_new.transpose(-1, -2)
    touchdown = in_contact & ~state.contact
    if terrain is not None:
        foot_ground = terrain_height(fk_foot[..., 0], terrain[0][:, None],
                                     terrain[1][:, None])
    else:
        foot_ground = torch.zeros_like(fk_foot[..., 0])
    landed = torch.cat([fk_foot[..., :2], foot_ground[..., None]], dim=-1)
    anchors = torch.where(touchdown[..., None], landed, state.foot_anchor)

    return PlantState(
        position=p_new, quat=quat_new, v_world=v_new,
        omega_world=omega_new, q=q_new, qd=qd_new,
        foot_anchor=anchors, contact=in_contact)
