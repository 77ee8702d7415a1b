"""Controller tick, the planning step and the tier-1 closed loop (port of
``hector/runtime.py``).

The rollout steps MPC periods of 5 control ticks where only tick 0 solves
the QP; ``do_mpc`` is a Python bool, so the batched solve runs exactly at
the 200 Hz cadence.  Every tensor carries the scenario batch as its leading
dimension.  PyTorch runs eagerly, so the loops are Python loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import resolve_device
from .config import HectorConfig, DEFAULT_CONFIG, JOINT_OFFSETS
from . import gait as G
from . import control as C
from . import estimation as EST
from . import mpc as M
from . import swing as SW
from .plant import srb
from .kinematics import foot_position, leg_jacobians

N_SEGMENTS = 10  # gait table length == MPC horizon (GaitGenerator ctor args)

# user mode commands, per lane and period (the batched analog of the
# UserCommand keys, src/interface/KeyBoard.cpp:31-93, and FSM
# checkTransition): MODE_CMD_NONE keeps the mode; C.MODE_PASSIVE (0) goes
# limp (FSMState_Walking.cpp:49-51); C.MODE_WALKING (1) re-enters walking
# (FSMState_Passive.cpp:33-39, where the reference lacks a `return`; the
# intended transition is implemented, as in the JAX package)
MODE_CMD_NONE = -1


class ScenarioCommand(NamedTuple):
    """Per-scenario teleop command + gait selection; every field (B,) except
    the gait fields (B, 2)."""

    vx: torch.Tensor
    vy: torch.Tensor
    yaw_rate: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    gait_offsets: torch.Tensor    # (B, 2) segments
    gait_durations: torch.Tensor  # (B, 2) segments
    terrain_step_height: torch.Tensor
    terrain_step_length: torch.Tensor


def _command(batch, values, offsets, durations, dtype, device):
    dev = resolve_device(device)

    def full(v):
        return torch.full((batch,), float(v), dtype=dtype, device=dev)

    def pair(v):
        return torch.tensor(v, dtype=dtype, device=dev).expand(batch, 2).clone()

    vx, vy, yaw_rate, step_height, step_length = values
    return ScenarioCommand(
        vx=full(vx), vy=full(vy), yaw_rate=full(yaw_rate), roll=full(0.0),
        pitch=full(0.0), gait_offsets=pair(offsets),
        gait_durations=pair(durations), terrain_step_height=full(step_height),
        terrain_step_length=full(step_length))


def walking_command(batch: int, vx=0.0, vy=0.0, yaw_rate=0.0,
                    step_height=0.0, step_length=1.0, dtype=torch.float32,
                    device='cuda') -> ScenarioCommand:
    """``batch`` lanes of the walking gait Gait(10, (0,5), (5,5))."""
    return _command(batch, (vx, vy, yaw_rate, step_height, step_length),
                    [0.0, 5.0], [5.0, 5.0], dtype, device)


def standing_command(batch: int, dtype=torch.float32,
                     device='cuda') -> ScenarioCommand:
    """``batch`` lanes of the standing gait Gait(10, (0,0), (10,10))."""
    return _command(batch, (0.0, 0.0, 0.0, 0.0, 1.0), [0.0, 0.0],
                    [10.0, 10.0], dtype, device)


def concat(*trees):
    """Concatenate NamedTuples (possibly nested) along the batch axis."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*[concat(*xs) for xs in zip(*trees)])
    return torch.cat(trees, dim=0)


class ControllerCarry(NamedTuple):
    tick: torch.Tensor          # (B,) int32 iterationCounter
    mode: torch.Tensor          # (B,) int32 FSM mode
    planner: M.PlannerState
    swing: SW.SwingState
    command: C.CommandState
    est: EST.EstimatorState


def init_controller_carry(plant: srb.PlantState,
                          cfg: HectorConfig = DEFAULT_CONFIG
                          ) -> ControllerCarry:
    """firstRun initialization (ConvexMPCLocomotion.cpp:66-111), on the
    plant's device."""
    dtype, dev = plant.position.dtype, plant.position.device
    bsz = plant.position.shape[0]
    est = C.estimate_state(plant.position, plant.v_world, plant.quat,
                           plant.omega_world)
    p_leg = foot_position(plant.q, cfg)
    p_foot_w = M.foot_positions_world(est, p_leg, cfg)
    return ControllerCarry(
        tick=torch.zeros((bsz,), dtype=torch.int32, device=dev),
        mode=torch.full((bsz,), C.MODE_WALKING, dtype=torch.int32,
                        device=dev),
        planner=M.init_planner_state(plant.position, dtype),
        swing=SW.init_swing_state(p_foot_w, dtype),
        command=C.CommandState(yaw_des=torch.zeros((bsz,), dtype=dtype,
                                                   device=dev)),
        est=EST.est_init(plant, cfg))


def reentry_estimate(estimator: str, carry: ControllerCarry,
                     plant: srb.PlantState) -> C.StateEstimate:
    """The state estimate available at an FSM re-entry, per estimator kind:
    the cheater re-enters from ground truth, as the reference does.  The
    'kf' and 'filtered' kinds re-enter from their own filter state, which
    is not ported yet (ROADMAP.md queue A item 12), and raise."""
    if estimator in ('kf', 'filtered'):
        raise NotImplementedError(
            f'reentry_estimate({estimator!r}) is not ported yet (ROADMAP.md '
            f'queue A item 12)')
    return C.estimate_state(plant.position, plant.v_world, plant.quat,
                            plant.omega_world)


def reenter_walking(carry: ControllerCarry, plant: srb.PlantState,
                    cfg: HectorConfig = DEFAULT_CONFIG,
                    est: C.StateEstimate = None) -> ControllerCarry:
    """FSMState_Walking::enter() + ConvexMPCLocomotion firstRun
    (ConvexMPCLocomotion.cpp:66-111): the planner, swing and command carry
    re-initialized at the current state of every lane.  est: the estimate
    to re-enter from (reentry_estimate); None = ground truth."""
    dtype = plant.position.dtype
    if est is None:
        est = C.estimate_state(plant.position, plant.v_world, plant.quat,
                               plant.omega_world)
    p_foot_w = M.foot_positions_world(est, foot_position(plant.q, cfg), cfg)
    return carry._replace(
        planner=M.init_planner_state(est.position, dtype),
        swing=SW.init_swing_state(p_foot_w, dtype),
        command=C.CommandState(yaw_des=torch.zeros_like(est.position[:, 0])))


def apply_mode_command(carry: ControllerCarry, plant: srb.PlantState,
                       mode_cmd, cfg: HectorConfig = DEFAULT_CONFIG,
                       estimator: str = 'cheater') -> ControllerCarry:
    """The FSM NORMAL/CHANGE step (FSM.cpp:37-54) per lane: a non-negative
    mode_cmd (B,) requests that mode; a lane entering WALKING re-runs the
    walking enter() initialization from the estimate its estimator kind
    provides (reentry_estimate)."""
    req = torch.as_tensor(mode_cmd, dtype=carry.mode.dtype,
                          device=carry.mode.device).expand_as(carry.mode)
    new_mode = torch.where(req >= 0, req, carry.mode)
    entering_walk = ((new_mode == C.MODE_WALKING)
                     & (carry.mode != C.MODE_WALKING))
    fresh = reenter_walking(carry, plant, cfg,
                            est=reentry_estimate(estimator, carry, plant))
    return _where_tree(entering_walk, fresh, carry)._replace(mode=new_mode)


def controller_tick(carry: ControllerCarry, plant: srb.PlantState,
                    cmd: ScenarioCommand, do_mpc: bool,
                    cfg: HectorConfig = DEFAULT_CONFIG,
                    estimator: str = 'cheater'):
    """One 1 kHz FSM tick (FSM.cpp:28-57, FSMState_Walking.cpp:26-41).

    Returns (carry', MotorCommand, wrench_world (B,2,6), stance_mask (B,2),
    diagnostics dict).
    """
    dtype, dev = plant.position.dtype, plant.position.device
    offsets = torch.tensor(JOINT_OFFSETS, dtype=dtype, device=dev)

    # --- state estimation ---
    est_state, est = EST.est_update(estimator, carry.est, plant, cfg)
    mode = C.apply_safety(carry.mode, est)

    # --- LegController::updateData (+ the data.q mutation quirk) ---
    j_fm, _ = leg_jacobians(plant.q, cfg)
    p_leg = foot_position(plant.q, cfg)
    q_data = plant.q + offsets

    # --- DesiredStateCommand ---
    v_des_robot = torch.stack([cmd.vx, cmd.vy, torch.zeros_like(cmd.vx)], -1)
    command = C.command_update(carry.command, est, cmd.yaw_rate, cfg.mpc.dt)

    # --- planner every-tick updates ---
    planner, _ = M.integrate_position_setpoint(carry.planner, est,
                                               v_des_robot, cfg)
    p_foot_w = M.foot_positions_world(est, p_leg, cfg)

    # --- gait phase ---
    iteration, phase = G.phase_state(
        carry.tick, cfg.mpc.iterations_between_mpc, N_SEGMENTS)
    contact_sub = G.contact_subphase(
        phase.to(dtype), cmd.gait_offsets, cmd.gait_durations, N_SEGMENTS)
    swing_sub = G.swing_subphase(
        phase.to(dtype), cmd.gait_offsets, cmd.gait_durations, N_SEGMENTS)
    gait_table = G.mpc_gait_table(
        iteration, cmd.gait_offsets, cmd.gait_durations, N_SEGMENTS).to(dtype)

    # --- MPC solve at the 200 Hz cadence ---
    diag = {}
    if do_mpc:
        planner, wrench_world, sol = M.mpc_update(
            planner, est, q_data, p_foot_w, v_des_robot, cmd.yaw_rate,
            cmd.roll, cmd.pitch, gait_table, cfg)
        diag = dict(qp_mu=sol.mu, qp_r_dual=sol.r_dual, qp_r_prim=sol.r_prim)
    else:
        # reuse last solution: reconstruct the world wrench from stored f_ff
        f = planner.f_ff
        wrench_world = torch.cat([-(f[..., 0:3] @ est.r_body),
                                  -(f[..., 3:6] @ est.r_body)], dim=-1)

    # --- swing-leg controller (double-call quirk inside) ---
    swing_state, p_foot_b, in_swing = SW.swing_update(
        carry.swing, est, p_leg, v_des_robot, swing_sub,
        cmd.gait_durations[:, 0], float(N_SEGMENTS), cfg)
    q_des, kp, kd = SW.swing_joint_setpoints(p_foot_b, q_data, in_swing, cfg)

    # --- stance/swing dispatch (ConvexMPCLocomotion.cpp:196-268) ---
    stance_mask = (~in_swing) & (contact_sub > 0)
    stance_f = stance_mask.to(dtype)
    motor_cmd = C.leg_torque_command(j_fm, planner.f_ff, stance_f, q_des, kp,
                                     kd)
    motor_cmd = C.apply_mode(motor_cmd, mode)
    wrench_world = wrench_world * stance_f[..., None]
    wrench_world = wrench_world * (mode == C.MODE_WALKING).to(dtype)[:, None,
                                                                     None]

    new_carry = ControllerCarry(
        tick=carry.tick + 1, mode=mode, planner=planner,
        swing=swing_state, command=command, est=est_state)
    diag.update(height=est.position[:, 2], vx=est.v_world[:, 0],
                vy=est.v_world[:, 1], yaw=est.rpy[:, 2],
                v_body=est.v_body[:, 0:2], xy=est.position[:, 0:2],
                fallen=(mode == C.MODE_PASSIVE))
    return new_carry, motor_cmd, wrench_world, stance_mask, diag


def plan_step_fn(cfg: HectorConfig = DEFAULT_CONFIG):
    """The benchmark unit: ONE full batched MPC planning step (FK -> gait ->
    reference -> QP build -> solve -> wrench -> torque map)."""

    def plan_step(carry: ControllerCarry, plant: srb.PlantState,
                  cmd: ScenarioCommand):
        new_carry, motor_cmd, wrench, _stance, _diag = controller_tick(
            carry, plant, cmd, do_mpc=True, cfg=cfg)
        return new_carry, wrench, motor_cmd

    return plan_step


def _where_tree(cond, new, old):
    """Per-lane select over a (nested) NamedTuple of (B, ...) tensors."""
    if isinstance(new, tuple):
        return type(new)(*[_where_tree(cond, n, o) for n, o in zip(new, old)])
    c = cond.reshape(cond.shape + (1,) * (new.dim() - 1))
    return torch.where(c, new, old)


def make_rollout(n_periods: int, cfg: HectorConfig = DEFAULT_CONFIG,
                 with_disturbance: bool = False, estimator: str = 'cheater',
                 with_schedule: bool = False):
    """A rollout of ``n_periods`` MPC periods (5 ticks each) over the tier-1
    plant, returning (carry', plant', diagnostics), the diagnostics stacked
    as (B, n_periods, ...).  Its call form follows the two switches, as in
    the JAX package (runtime.py:356-367):

        rollout(carry, plant, cmd[, disturbance][, schedule])

    with_disturbance: ``disturbance`` (B, n_periods, 6) is a world wrench
    [force, torque] added to the body on every tick of its period (pushes;
    the analog of external_force teleop, external_force.cpp).

    with_schedule: ``schedule = (cmd_t, mode_cmd_t)``.  cmd_t is a
    ScenarioCommand with (B, n_periods, ...) fields that replaces ``cmd``
    in each period (teleop trajectories, gait switches, terrain);
    mode_cmd_t (B, n_periods) int32 holds the user mode commands
    (MODE_CMD_NONE, C.MODE_PASSIVE, C.MODE_WALKING), applied before each
    period's ticks (apply_mode_command).

    Lanes that go non-finite in a period are frozen at their last finite
    state and flipped passive (NaN quarantine, runtime.py:330-347).  The
    non-cheater estimators are not ported yet (ROADMAP.md queue A item 12)
    and raise.
    """
    EST.require_cheater(estimator)

    def rollout(carry, plant, cmd, disturbance=None, schedule=None):
        diags = []
        for t in range(n_periods):
            cmd_t = (ScenarioCommand(*[f[:, t] for f in schedule[0]])
                     if with_schedule else cmd)
            dist = disturbance[:, t] if with_disturbance else None
            terrain = (cmd_t.terrain_step_height, cmd_t.terrain_step_length)
            c0, p0 = carry, plant
            c, p = c0, p0
            if with_schedule:
                c = apply_mode_command(c, p, schedule[1][:, t], cfg,
                                       estimator=estimator)
            diag0 = None
            for k in range(cfg.mpc.mpc_cadence):
                c, motor_cmd, wrench, stance, diag = controller_tick(
                    c, p, cmd_t, do_mpc=(k == 0), cfg=cfg,
                    estimator=estimator)
                if k == 0:
                    diag0 = {**diag, 'wrench': wrench, 'contact': stance}
                p = srb.step(p, motor_cmd, wrench, stance, disturbance=dist,
                             terrain=terrain, cfg=cfg)
            healthy = (C.finite_lanes(p.position) & C.finite_lanes(p.v_world)
                       & C.finite_lanes(p.quat) & C.finite_lanes(p.q))
            plant = _where_tree(healthy, p, p0)
            mode = torch.where(healthy, c.mode,
                               torch.full_like(c.mode, C.MODE_PASSIVE))
            carry = _where_tree(healthy, c, c0)._replace(mode=mode,
                                                          tick=c.tick)
            diag0.update(mode=mode, fallen=diag0['fallen'] | ~healthy,
                         quarantined=~healthy)
            diags.append(diag0)
        stacked = {key: torch.stack([d[key] for d in diags], dim=1)
                   for key in diags[0]}
        return carry, plant, stacked

    if with_disturbance and with_schedule:
        return rollout
    if with_disturbance:
        def pushed(carry, plant, cmd, disturbance):
            return rollout(carry, plant, cmd, disturbance=disturbance)
        return pushed
    if with_schedule:
        def scheduled(carry, plant, cmd, schedule):
            return rollout(carry, plant, cmd, schedule=schedule)
        return scheduled

    def plain(carry, plant, cmd):
        return rollout(carry, plant, cmd)
    return plain
