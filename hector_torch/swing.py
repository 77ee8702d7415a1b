"""Swing-leg controller: Raibert placement, Bezier trajectory, IK setpoints
(port of ``hector/swing.py``, after ``src/common/SwingLegController.cpp``).

Reference quirks kept: ``updateSwingTimes`` runs twice per tick (once per
foot from ConvexMPCLocomotion.cpp:196-205), the Bezier z-velocity is
d/dphase, world foot positions force z = 0, and the apex height is 0.15.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constant
from .config import HectorConfig, DEFAULT_CONFIG
from . import math as hm
from .kinematics import hip_yaw_locations, leg_ik


class SwingState(NamedTuple):
    """Carry of the swing controller."""

    first_swing: torch.Tensor   # (B, 2) bool
    swing_times: torch.Tensor   # (B, 2) remaining swing time [s]
    p0: torch.Tensor            # (B, 2, 3) Bezier start (world)
    pf: torch.Tensor            # (B, 2, 3) Bezier end (world)


def init_swing_state(p_foot_w, dtype=torch.float32) -> SwingState:
    bsz = p_foot_w.shape[0]
    dev = p_foot_w.device
    return SwingState(
        first_swing=torch.ones((bsz, 2), dtype=torch.bool, device=dev),
        swing_times=torch.zeros((bsz, 2), dtype=dtype, device=dev),
        p0=p_foot_w.to(dtype), pf=p_foot_w.to(dtype))


def hip_width_offset(cfg, like):
    """(2, 3) hip-width shift of the IK target (SwingLegController.cpp:146),
    with the dtype and device of ``like``."""
    x, y = cfg.swing.hip_width_offset_x, cfg.swing.hip_width_offset_y
    return constant(('hip_width_offset', x, y), [[x, -y, 0.0], [x, y, 0.0]],
                    like)


def _update_swing_times_once(first_swing, swing_times, full_swing_time, dt):
    """One ``updateSwingTimes`` pass (SwingLegController.cpp:80-91)."""
    t = torch.where(first_swing, full_swing_time, swing_times - dt)
    first = torch.where(first_swing, first_swing, t <= 0.0)
    return first, t


def swing_update(state: SwingState, est, leg_data_p, v_des_robot,
                 swing_phase, gait_stance_segments, n_segments,
                 cfg: HectorConfig = DEFAULT_CONFIG):
    """One controller tick of the swing pipeline (updateSwingLeg,
    SwingLegController.cpp:46-54).

    leg_data_p: (B, 2, 3) leg-frame foot positions; v_des_robot: (B, 3);
    swing_phase: (B, 2); gait_stance_segments: (B,); n_segments: scalar.
    Returns (new_state, p_foot_b (B, 2, 3), in_swing (B, 2) bool).
    """
    dtype = leg_data_p.dtype
    sw = cfg.swing
    dt_swing = constant(('dt_mpc', cfg.mpc.dt_mpc), cfg.mpc.dt_mpc,
                        leg_data_p)
    dt = constant(('dt', cfg.mpc.dt), cfg.mpc.dt, leg_data_p)
    r_body = est.r_body
    r_body_t = r_body.transpose(-1, -2)
    hip_yaw = hip_yaw_locations(cfg, leg_data_p)
    pos = est.position[:, None, :]

    # updateFootPosition: world foot positions, z forced to 0
    p_foot_w = pos + (hip_yaw + leg_data_p) @ r_body
    p_foot_w = torch.cat([p_foot_w[..., :2], torch.zeros_like(
        p_foot_w[..., 2:])], dim=-1)

    # updateSwingTimes, applied twice (double-call quirk)
    full_swing = (dt_swing * (n_segments - gait_stance_segments))[:, None]
    first, times = _update_swing_times_once(
        state.first_swing, state.swing_times, full_swing, dt)
    first, times = _update_swing_times_once(first, times, full_swing, dt)

    # computeFootPlacement (SwingLegController.cpp:96-126)
    v_des_world = hm.matvec(r_body_t, v_des_robot)
    v_w = est.v_world
    pf = pos + hip_yaw @ r_body + v_w[:, None, :] * times[..., None]
    k_stance = (0.5 * gait_stance_segments * dt_swing)[:, None, None]
    p_rel = (sw.raibert_gain * v_w[:, None, :2] * k_stance
             + sw.vel_gain * (v_w[:, None, :2] - v_des_world[:, None, :2]))
    p_rel = torch.clamp(p_rel, -sw.p_rel_max, sw.p_rel_max)
    pf = torch.cat([pf[..., :2] + p_rel, torch.zeros_like(pf[..., 2:])],
                   dim=-1)

    # computeFootDesiredPosition (SwingLegController.cpp:132-152)
    in_swing = swing_phase > 0
    consume_first = in_swing & first
    p0 = torch.where(consume_first[..., None], p_foot_w, state.p0)
    first = torch.where(in_swing, torch.zeros_like(first), first)

    phase = swing_phase[..., None].to(dtype)
    p_des = hm.cubic_bezier(p0, pf, phase)
    z_first = hm.cubic_bezier(p0[..., 2], p0[..., 2] + sw.swing_height,
                              swing_phase * 2.0)
    z_second = hm.cubic_bezier(p0[..., 2] + sw.swing_height, pf[..., 2],
                               swing_phase * 2.0 - 1.0)
    z = torch.where(swing_phase < 0.5, z_first, z_second)
    p_des = torch.cat([p_des[..., :2], z[..., None]], dim=-1)

    p_foot_b = (p_des - pos) @ r_body_t + hip_width_offset(cfg, leg_data_p)
    return SwingState(first, times, p0, pf), p_foot_b, in_swing


def swing_joint_setpoints(p_foot_b, q_data, in_swing,
                          cfg: HectorConfig = DEFAULT_CONFIG):
    """IK + joint gains; stance legs get zero gains
    (setDesiredJointState, SwingLegController.cpp:192-219).
    Returns (q_des (B,2,5) raw-motor-frame, kp (B,2,5), kd (B,2,5))."""
    q_des = leg_ik(p_foot_b, q_data, cfg)
    sw = in_swing[..., None].to(p_foot_b.dtype)
    kp = constant(('kp_swing', cfg.swing.kp_swing), cfg.swing.kp_swing,
                  p_foot_b) * sw
    kd = constant(('kd_swing', cfg.swing.kd_swing), cfg.swing.kd_swing,
                  p_foot_b) * sw
    q_des = torch.where(in_swing[..., None], q_des, torch.zeros_like(q_des))
    return q_des, kp, kd
