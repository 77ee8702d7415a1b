"""State estimate, desired-command integration, leg torque mapping and the
FSM as a tensor (port of ``hector/control.py``).

Every function takes the scenario batch as the leading dimension B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as hm

MODE_PASSIVE = 0
MODE_WALKING = 1


class StateEstimate(NamedTuple):
    """Mirror of StateEstimate (StateEstimatorContainer.h:48); r_body is the
    world->body matrix (the reference's rBody)."""

    position: torch.Tensor      # (B, 3)
    v_world: torch.Tensor       # (B, 3)
    v_body: torch.Tensor        # (B, 3)
    omega_world: torch.Tensor   # (B, 3)
    quat: torch.Tensor          # (B, 4) wxyz
    rpy: torch.Tensor           # (B, 3)
    r_body: torch.Tensor        # (B, 3, 3) world->body


def estimate_state(position, v_world, quat, omega_world) -> StateEstimate:
    """Cheater estimator passthrough (ground truth from the plant)."""
    r_body = hm.quat_to_rot(quat).transpose(-1, -2)
    return StateEstimate(
        position=position, v_world=v_world,
        v_body=hm.matvec(r_body, v_world),
        omega_world=omega_world, quat=quat,
        rpy=hm.quat_to_rpy(quat), r_body=r_body)


class CommandState(NamedTuple):
    """DesiredStateCommand carry: the integrated yaw setpoint
    (DesiredCommand.cpp:26-38)."""

    yaw_des: torch.Tensor       # (B,)


def command_update(state: CommandState, est: StateEstimate, yaw_rate, dt):
    """Integrate yaw with the +-3.1 wrap guard (DesiredCommand.cpp:26-38)."""
    yaw_est = est.rpy[:, 2]
    yaw = state.yaw_des + dt * yaw_rate
    yaw = torch.where((yaw > 3.1) & (yaw_est < 0), yaw_est, yaw)
    yaw = torch.where((yaw < -3.1) & (yaw_est > 0), yaw_est, yaw)
    return CommandState(yaw_des=yaw)


class MotorCommand(NamedTuple):
    """Per-motor command arrays (LowLevelCmd.h:36-56), leg-major (B, 2, 5)."""

    tau: torch.Tensor
    q_des: torch.Tensor
    qd_des: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor


def leg_torque_command(j_force_moment, f_ff, stance_mask, q_des, kp, kd
                       ) -> MotorCommand:
    """tau = J_fm^T f_ff for stance legs; joint-PD setpoints for swing
    (LegController.cpp:57-106, ConvexMPCLocomotion.cpp:196-268).

    j_force_moment: (B, 2, 6, 5); f_ff: (B, 2, 6) body-frame stance wrench;
    stance_mask: (B, 2); q_des/kp/kd: (B, 2, 5).
    """
    wrench = f_ff * stance_mask[..., None]
    tau = hm.rmatvec(j_force_moment, wrench)
    return MotorCommand(tau=tau, q_des=q_des, qd_des=torch.zeros_like(q_des),
                        kp=kp, kd=kd)


def finite_lanes(x):
    """(B,) True where every entry of the lane is finite."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def apply_safety(mode, est: StateEstimate):
    """FSM::checkSafty (FSM.cpp:78-87): rBody(2,2) < 0.5 -> passive, and a
    lane whose state went non-finite is frozen to passive."""
    unhealthy = ~(finite_lanes(est.position) & finite_lanes(est.v_world)
                  & finite_lanes(est.quat))
    fallen = (est.r_body[:, 2, 2] < 0.5) | unhealthy
    return torch.where(fallen, torch.full_like(mode, MODE_PASSIVE), mode)


def apply_mode(cmd: MotorCommand, mode) -> MotorCommand:
    """Passive mode: zero torques/targets, pure damping kd = 5
    (FSMState_Passive.cpp:10)."""
    passive = (mode == MODE_PASSIVE)[:, None, None]
    z = torch.zeros_like(cmd.tau)
    return MotorCommand(
        tau=torch.where(passive, z, cmd.tau),
        q_des=torch.where(passive, z, cmd.q_des),
        qd_des=torch.where(passive, z, cmd.qd_des),
        kp=torch.where(passive, z, cmd.kp),
        kd=torch.where(passive, torch.full_like(cmd.kd, 5.0), cmd.kd))
