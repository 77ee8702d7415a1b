"""The reference controller: one 1 kHz tick of the published controller
under the cheater estimator, and one MPC period of the tier-1 loop (five
ticks, the first solving, five plant steps, the NaN quarantine).

Written from the controller's own sources (Hector_Simulation,
hector_control; the port cites the same lines): FSM.cpp:28-87 (the
safety check), DesiredCommand.cpp:26-38 (the yaw set-point),
GaitGenerator.cpp:29-113 (phases, sub-phases and the MPC's contact
table), ConvexMPCLocomotion.cpp:196-441 (the swing legs, the reference
trajectory, the solve, the feed-forward wrench) and
SwingLegController.cpp:46-219 (foot placement, the Bezier swing, joint
set-points), LegController.cpp:57-106 (tau = J' f on stance legs),
FSMState_Passive.cpp:10 (passive: zero torque, kd 5); with the quirks of
docs/DESIGN.md section 8 (the swing timer updated twice a tick, world feet
at z = 0, the triple joint offset of the foot rotation, exact-float
compares).  The QP is mpc.py's and its solve qp.py's.

Every function works in the dtype of the state's tensors (float64 for the
check) and takes the state in the program's field names and order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import legs, mpc, plant, qp
from .config import DEFAULT_CONFIG, JOINT_OFFSETS

N_SEGMENTS = 10
PASSIVE, WALKING = 0, 1


class Command(NamedTuple):
    vx: torch.Tensor
    vy: torch.Tensor
    yaw_rate: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    gait_offsets: torch.Tensor     # (B, 2) segments
    gait_durations: torch.Tensor   # (B, 2) segments
    terrain_step_height: torch.Tensor
    terrain_step_length: torch.Tensor


class SwingState(NamedTuple):
    first_swing: torch.Tensor   # (B, 2) bool
    swing_times: torch.Tensor   # (B, 2) s of swing left
    p0: torch.Tensor            # (B, 2, 3) swing start, world
    pf: torch.Tensor            # (B, 2, 3) swing end, world


class Carry(NamedTuple):
    tick: torch.Tensor
    mode: torch.Tensor
    world_position_desired: torch.Tensor
    f_ff: torch.Tensor          # (B, 2, 6) body-frame stance wrench
    swing: SwingState
    yaw_des: torch.Tensor


class MotorCommand(NamedTuple):
    tau: torch.Tensor
    q_des: torch.Tensor
    qd_des: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor


class Tick(NamedTuple):
    carry: Carry
    motor: MotorCommand
    wrench: torch.Tensor        # (B, 2, 6) world, stance and mode masked
    stance: torch.Tensor        # (B, 2) bool
    certified: torch.Tensor     # (B,) bool, the solve's certificate


def rpy_of(quat):
    """ZYX (roll, pitch, yaw) of a quaternion (SolverMPC.cpp:333-341), the
    asin argument held within +-0.99999."""
    w, x, y, z = quat.unbind(-1)
    sp = torch.clamp(2.0 * (w * y - x * z), -0.99999, 0.99999)
    return torch.stack([
        torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y)),
        torch.asin(sp),
        torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))], -1)


def _bezier(y0, yf, x):
    return y0 + (x ** 3 + 3.0 * x * x * (1.0 - x)) * (yf - y0)


def _finite(x):
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(1)


def gait(tick, cmd, dtype):
    """(contact sub-phase (B, 2), swing sub-phase (B, 2), the MPC's
    contact table (B, h, 2)) at ``tick``.  The phase is float32, as the
    program keeps it."""
    per_segment = DEFAULT_CONFIG.mpc.iterations_between_mpc
    segment = torch.div(tick, per_segment, rounding_mode='floor') % N_SEGMENTS
    phase = ((tick % (per_segment * N_SEGMENTS)).to(torch.float32)
             / (per_segment * N_SEGMENTS)).to(dtype)[:, None]
    off = cmd.gait_offsets / N_SEGMENTS
    dur = cmd.gait_durations / N_SEGMENTS
    p = phase - off
    p = torch.where(p < 0, p + 1.0, p)
    contact = torch.where(p > dur, 0.0, p / dur)
    s_off = off + dur
    s_off = torch.where(s_off > 1.0, s_off - 1.0, s_off)
    s_dur = 1.0 - dur
    p = phase - s_off
    p = torch.where(p < 0, p + 1.0, p)
    swing = torch.where((s_dur == 0) | (p > s_dur), 0.0,
                        p / torch.where(s_dur == 0, 1.0, s_dur))
    ahead = (segment[:, None] + torch.arange(N_SEGMENTS, device=tick.device)
             ) % N_SEGMENTS                                   # (B, h)
    table = ((ahead[..., None] - cmd.gait_offsets.to(torch.int64)[:, None])
             % N_SEGMENTS) < cmd.gait_durations.to(torch.int64)[:, None]
    return contact, swing, table.to(dtype)


def interior_start(r_foot, r_body, table, mpc_cfg):
    """A point strictly inside every row of the QP: on each stance leg a
    vertical force of 100 N and a moment of half the Mx bound about the
    foot's x axis; zero on the eliminated variables."""
    bsz, h = table.shape[:2]
    u = r_body.new_zeros((bsz, h, 12))
    for leg in range(2):
        rl = r_foot[:, leg].transpose(-1, -2) @ r_body.transpose(-1, -2)
        on = table[:, :, leg:leg + 1]
        u[:, :, 3 * leg + 2] = 100.0 * on[..., 0]
        u[:, :, 6 + 3 * leg:9 + 3 * leg] = \
            0.5 * mpc_cfg.mx_bound * rl[:, None, 0, :] * on
    return u.reshape(bsz, 12 * h)


def solve_mpc(est, wpd, q_data, feet_w, v_des_robot, cmd, table, cfg):
    """One solve (ConvexMPCLocomotion.cpp:274-441): (the clamped desired
    position, f_ff (B, 2, 6) body, world wrench (B, 2, 6), certified)."""
    m = cfg.mpc
    p, rot, rpy = est['p'], est['rot'], est['rpy']
    v_des = (rot @ v_des_robot[..., None])[..., 0]
    xy = torch.minimum(torch.maximum(wpd[:, :2], p[:, :2] - m.max_pos_error),
                       p[:, :2] + m.max_pos_error)
    wpd = torch.cat([xy, wpd[:, 2:]], -1)

    # the reference trajectory (ConvexMPCLocomotion.cpp:351-406)
    k = torch.arange(m.horizon, dtype=p.dtype, device=p.device) * m.dt_mpc
    traj = p.new_zeros((p.shape[0], m.horizon, 12))
    for axis, col in ((0, 3), (1, 4)):
        vel = v_des[:, axis:axis + 1]
        base = torch.where(vel == 0, xy[:, axis:axis + 1],
                           p[:, axis:axis + 1])
        traj[:, :, col] = base + k * vel
    rate = cmd.yaw_rate[:, None]
    traj[:, :, 0] = cmd.roll[:, None]
    traj[:, :, 1] = cmd.pitch[:, None]
    traj[:, :, 2] = torch.where(rate == 0, 0.0, rpy[:, 2:3] + k * rate)
    traj[:, :, 5] = m.body_height
    traj[:, :, 8] = cmd.yaw_rate[:, None]
    traj[:, :, 9] = v_des[:, 0:1]
    traj[:, :, 10] = v_des[:, 1:2]
    traj[:, 0, 0:3] = rpy
    traj[:, 0, 3:6] = p

    x0 = torch.cat([rpy, p, est['omega'], est['v'],
                    torch.full_like(p[:, :1], m.gravity)], -1)
    q_foot = q_data + 2.0 * q_data.new_tensor(JOINT_OFFSETS)
    r_foot = legs.foot_rotation(q_foot)
    i_body = torch.diag(p.new_tensor(cfg.robot.inertia_body))
    prob = mpc.build(x0, traj, rot, r_foot, feet_w - p[:, None, :], table,
                     i_body, m)
    big = cfg.solver.big_threshold
    gm = torch.cat([prob.a, -prob.a], 1)
    h = torch.cat([prob.ub, -prob.lb], 1)
    rows = torch.cat([prob.keep_c & (prob.ub < big),
                      prob.keep_c & (prob.lb > -big)], 1)
    sol = qp.solve(prob.h, prob.g, gm, h, rows, prob.keep_v,
                   interior_start(r_foot, rot, table, m))
    u = sol.u
    grf = u[:, 0:6].reshape(-1, 2, 3)
    grm = u[:, 6:12].reshape(-1, 2, 3)
    rt = rot.transpose(-1, -2)
    f_ff = -torch.cat([(rt[:, None] @ grf[..., None])[..., 0],
                       (rt[:, None] @ grm[..., None])[..., 0]], -1)
    return wpd, f_ff, torch.cat([grf, grm], -1), sol.certified


def controller_tick(carry: Carry, st: plant.PlantState, cmd: Command,
                    do_mpc: bool, cfg=DEFAULT_CONFIG) -> Tick:
    """One tick: the cheater's estimate, the safety check, the command, the
    gait, the solve on ``do_mpc`` ticks, the swing legs, the torques."""
    m, sw = cfg.mpc, cfg.swing
    dtype = st.position.dtype
    rot = plant.rotation(st.quat)                  # body to world
    rpy = rpy_of(st.quat)
    est = {'p': st.position, 'rot': rot, 'rpy': rpy, 'v': st.v_world,
           'omega': st.omega_world}

    healthy = _finite(st.position) & _finite(st.v_world) & _finite(st.quat)
    mode = torch.where((rot[:, 2, 2] < 0.5) | ~healthy,
                       torch.full_like(carry.mode, PASSIVE), carry.mode)

    p_leg, jac = legs.foot_and_jacobian(st.q)
    q_data = st.q + st.q.new_tensor(JOINT_OFFSETS)
    zero = torch.zeros_like(cmd.vx)
    v_des_robot = torch.stack([cmd.vx, cmd.vy, zero], -1)
    v_des = (rot @ v_des_robot[..., None])[..., 0]

    yaw = carry.yaw_des + m.dt * cmd.yaw_rate
    yaw = torch.where((yaw > 3.1) & (rpy[:, 2] < 0), rpy[:, 2], yaw)
    yaw = torch.where((yaw < -3.1) & (rpy[:, 2] > 0), rpy[:, 2], yaw)

    wpd = carry.world_position_desired
    wpd = torch.stack([wpd[:, 0] + m.dt * v_des[:, 0],
                       wpd[:, 1] + m.dt * v_des[:, 1],
                       torch.full_like(wpd[:, 2], m.body_height)], -1)
    hips = plant.hip_yaw(cfg, st.position)
    feet_w = st.position[:, None] + torch.einsum('bij,blj->bli', rot,
                                                 hips + p_leg)
    contact_sub, swing_sub, table = gait(carry.tick, cmd, dtype)

    f_ff = carry.f_ff
    certified = torch.ones_like(healthy)
    if do_mpc:
        wpd, f_ff, wrench, certified = solve_mpc(
            est, wpd, q_data, feet_w, v_des_robot, cmd, table, cfg)
    else:
        wrench = -torch.cat([(rot[:, None] @ f_ff[..., :3, None])[..., 0],
                             (rot[:, None] @ f_ff[..., 3:, None])[..., 0]], -1)

    # the swing legs (SwingLegController.cpp:46-152)
    stance_seg = cmd.gait_durations[:, 0:1]
    full = m.dt_mpc * (N_SEGMENTS - stance_seg)
    first, left = carry.swing.first_swing, carry.swing.swing_times
    for _ in range(2):                       # updateSwingTimes, twice
        left = torch.where(first, full, left - m.dt)
        first = first | (left <= 0.0)
    ground = feet_w.clone()
    ground[..., 2] = 0.0
    pf = st.position[:, None] + torch.einsum('bij,lj->bli', rot, hips) \
        + st.v_world[:, None] * left[..., None]
    shift = (sw.raibert_gain * st.v_world[:, None, :2]
             * (0.5 * stance_seg * m.dt_mpc)[..., None]
             + sw.vel_gain * (st.v_world[:, None, :2] - v_des[:, None, :2]))
    shift = torch.clamp(shift, -sw.p_rel_max, sw.p_rel_max)
    pf = torch.cat([pf[..., :2] + shift, torch.zeros_like(pf[..., 2:])], -1)
    in_swing = swing_sub > 0
    p0 = torch.where((in_swing & first)[..., None], ground, carry.swing.p0)
    first = first & ~in_swing
    x = swing_sub[..., None]
    target = _bezier(p0, pf, x)
    top = p0[..., 2] + sw.swing_height
    z = torch.where(swing_sub < 0.5, _bezier(p0[..., 2], top, 2 * swing_sub),
                    _bezier(top, pf[..., 2], 2 * swing_sub - 1))
    target = torch.cat([target[..., :2], z[..., None]], -1)
    target_b = torch.einsum('bji,blj->bli', rot, target - st.position[:, None])
    target_b = target_b + plant.hip_width(cfg, st.position)

    on = in_swing[..., None].to(dtype)
    q_des = torch.where(in_swing[..., None],
                        legs.inverse_kinematics(target_b, q_data), 0.0)
    kp = on * st.q.new_tensor(sw.kp_swing)
    kd = on * st.q.new_tensor(sw.kd_swing)
    stance = ~in_swing & (contact_sub > 0)
    s = stance.to(dtype)[..., None]
    tau = torch.einsum('blkj,blk->blj', jac, f_ff * s)
    passive = (mode == PASSIVE)[:, None, None]
    motor = MotorCommand(
        tau=torch.where(passive, 0.0, tau),
        q_des=torch.where(passive, 0.0, q_des),
        qd_des=torch.zeros_like(q_des),
        kp=torch.where(passive, 0.0, kp),
        kd=torch.where(passive, 5.0, kd))
    walking = (mode == WALKING).to(dtype)[:, None, None]
    new = Carry(carry.tick + 1, mode, wpd, f_ff,
                SwingState(first, left, p0, pf), yaw)
    return Tick(new, motor, wrench * s * walking, stance, certified)


def _keep_where(ok, new, old):
    if isinstance(new, tuple):
        return type(new)(*[_keep_where(ok, a, b) for a, b in zip(new, old)])
    return torch.where(ok.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def period(carry: Carry, st: plant.PlantState, cmd: Command, push,
           cfg=DEFAULT_CONFIG):
    """One MPC period: (carry', plant', the first tick).  A lane whose
    plant went non-finite keeps its state, turns passive and counts the
    ticks."""
    terrain = (cmd.terrain_step_height, cmd.terrain_step_length)
    c, p, first = carry, st, None
    for k in range(cfg.mpc.mpc_cadence):
        t = controller_tick(c, p, cmd, k == 0, cfg)
        first = t if k == 0 else first
        p = plant.step(p, t.motor, t.wrench, t.stance, push, terrain, cfg)
        c = t.carry
    ok = _finite(p.position) & _finite(p.v_world) & _finite(p.quat) \
        & _finite(p.q)
    mode = torch.where(ok, c.mode, torch.full_like(c.mode, PASSIVE))
    carry_out = _keep_where(ok, c, carry)._replace(mode=mode, tick=c.tick)
    return carry_out, _keep_where(ok, p, st), first


def first_carry(st: plant.PlantState, tick, cfg=DEFAULT_CONFIG) -> Carry:
    """The carry of a first run at ``st`` (ConvexMPCLocomotion.cpp:66-111)
    at gait tick ``tick``: walking, the desired position where the body
    is, no wrench yet, each foot's swing to start from where it is."""
    rot = plant.rotation(st.quat)
    p_leg, _ = legs.foot_and_jacobian(st.q)
    feet = st.position[:, None] + torch.einsum(
        'bij,blj->bli', rot, plant.hip_yaw(cfg, st.position) + p_leg)
    bsz = st.position.shape[0]
    return Carry(
        tick=tick, mode=torch.ones_like(tick),
        world_position_desired=st.position.clone(),
        f_ff=st.position.new_zeros((bsz, 2, 6)),
        swing=SwingState(
            torch.ones((bsz, 2), dtype=torch.bool, device=tick.device),
            st.position.new_zeros((bsz, 2)), feet, feet.clone()),
        yaw_des=st.position.new_zeros(bsz))
