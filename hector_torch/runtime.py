"""Controller tick, the planning step and the tier-1 closed loop (port of
``hector/runtime.py``).

The rollout steps MPC periods of 5 control ticks where only tick 0 solves
the QP; ``do_mpc`` is a Python bool, so the batched solve runs exactly at
the 200 Hz cadence.  Every tensor carries the scenario batch as its leading
dimension.  The reference jits a lax.scan over the periods; here one period
is captured as a CUDA graph once per rollout object, batch size, dtype and
device, and replayed once a period (graph.StepGraph), for the backends in
GRAPH_BACKENDS (every backend but 'qpoases', which runs the periods as a
Python loop).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import resolve_device
from . import graph, prng
from .config import HectorConfig, DEFAULT_CONFIG
from . import gait as G
from . import control as C
from . import estimation as EST
from . import mpc as M
from . import swing as SW
from .plant import srb
from .io.profiling import span
from .kinematics import foot_position, leg_data

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
                          cfg: HectorConfig = DEFAULT_CONFIG, key=None,
                          noise: EST.SensorNoise = EST.SensorNoise()
                          ) -> ControllerCarry:
    """firstRun initialization (ConvexMPCLocomotion.cpp:66-111), on the
    plant's device.

    key: (B, 2) or (2,) PRNG key seeding each lane's sensor-noise stream
    (prng; unused by the cheater); None is PRNGKey(0) on every lane, what
    a vmapped ``None`` gives in the JAX package.  noise: the sensor noise
    model; the lane's TRUE gyro bias is drawn here (est_init), so pass the
    same model to the rollout (``make_rollout(noise=)``)."""
    dtype, dev = plant.position.dtype, plant.position.device
    bsz = plant.position.shape[0]
    if key is None:
        key = prng.PRNGKey(0, dev)
    key = key.to(dev).expand(bsz, 2)
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
        est=EST.est_init(plant, key, cfg, noise=noise))


def reentry_estimate(estimator: str, carry: ControllerCarry,
                     plant: srb.PlantState) -> C.StateEstimate:
    """The state estimate available at an FSM re-entry, per estimator kind:
    the honest 'kf' path re-enters from its own filter state (KF position
    and velocity, Mahony attitude; omega does not enter the re-init and is
    zero), never from plant truth; 'filtered' from its IIR state (its quat
    channel is that path's documented staging cheat); the cheater from
    ground truth, as the reference does."""
    if estimator == 'kf':
        x = carry.est.kf.x
        return C.estimate_state(x[:, 0:3], x[:, 3:6], carry.est.mahony.quat,
                                torch.zeros_like(x[:, 0:3]))
    if estimator == 'filtered':
        return C.estimate_state(carry.est.filt.pos, carry.est.filt.vel,
                                plant.quat, plant.omega_world)
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
                    estimator: str = 'cheater', est_ground_z: float = 0.0,
                    noise: EST.SensorNoise = EST.SensorNoise()):
    """One 1 kHz FSM tick (FSM.cpp:28-57, FSMState_Walking.cpp:26-41).

    estimator: 'cheater' | 'filtered' | 'kf' (estimation.py); the
    controller consumes only the estimate.  est_ground_z: the KF's FK-foot
    height on flat ground (estimation.est_update).  Returns (carry',
    MotorCommand, wrench_world (B,2,6), stance_mask (B,2), diagnostics
    dict).
    """
    dtype = plant.position.dtype

    # --- state estimation; the KF's foot-height rows read the commanded
    # terrain map at its own foot-x estimates, never the plant's ground ---
    with span('tick.estimate'):
        est_state, est = EST.est_update(
            estimator, carry.est, plant, cfg, noise=noise,
            ground_z=est_ground_z,
            terrain=(cmd.terrain_step_height, cmd.terrain_step_length))
        mode = C.apply_safety(carry.mode, est)

    # --- LegController::updateData (+ the data.q mutation quirk) ---
    with span('tick.legs'):
        j_fm, p_leg, q_data = leg_data(plant.q, cfg)

    with span('tick.command'):
        # --- DesiredStateCommand ---
        v_des_robot = torch.stack([cmd.vx, cmd.vy, torch.zeros_like(cmd.vx)],
                                  -1)
        command = C.command_update(carry.command, est, cmd.yaw_rate,
                                   cfg.mpc.dt)

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
            iteration, cmd.gait_offsets, cmd.gait_durations,
            N_SEGMENTS).to(dtype)

    # --- MPC solve at the 200 Hz cadence (spans mpc.*) ---
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
    with span('tick.swing'):
        swing_state, p_foot_b, in_swing = SW.swing_update(
            carry.swing, est, p_leg, v_des_robot, swing_sub,
            cmd.gait_durations[:, 0], float(N_SEGMENTS), cfg)
        q_des, kp, kd = SW.swing_joint_setpoints(p_foot_b, q_data, in_swing,
                                                 cfg)

    # --- stance/swing dispatch (ConvexMPCLocomotion.cpp:196-268) ---
    with span('tick.dispatch'):
        stance_mask = (~in_swing) & (contact_sub > 0)
        stance_f = stance_mask.to(dtype)
        motor_cmd = C.leg_torque_command(j_fm, planner.f_ff, stance_f, q_des,
                                         kp, kd)
        motor_cmd = C.apply_mode(motor_cmd, mode)
        wrench_world = wrench_world * stance_f[..., None]
        wrench_world = wrench_world * (mode == C.MODE_WALKING).to(dtype)[
            :, None, None]

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


# The solver backends whose MPC period is captured as a CUDA graph and
# replayed (graph.StepGraph, the counterpart of the reference's jax.jit over
# its lax.scan), on the tier-1 and the tier-2 plant, in every call form and
# under every estimator: the fused Riccati solver, the Mehrotra stage solver
# 'riccati' and the dense interior point, kernels or plain versions ('riccati'
# and 'xla' included: their torch.linalg calls wait on nothing and capture on
# the card, where chip_smoke.py holds every one of these backends' replays
# bit for bit to their eager runs).  Only 'qpoases' runs the eager loop of
# periods, by this rule and on every device: it solves on the host, a lane
# at a time, which a graph cannot hold.
GRAPH_BACKENDS = M.RICCATI_BACKENDS + M.STAGE_BACKENDS + M.DENSE_BACKENDS


def _rollout(n_periods, cfg, with_disturbance, estimator, with_schedule,
             noise, observe, plant_step, est_ground_z):
    """The closed loop of both tiers: the controller sees ``observe(plant)``
    and ``plant_step(plant, motor_cmd, wrench, stance, push, terrain)``
    advances the plant one tick.  Returns the rollout in the call form the
    two switches select, with ``.init(plant, key=None)`` and ``.eager``, the
    same call form run as a Python loop of periods (what 'qpoases', the one
    backend outside GRAPH_BACKENDS, runs)."""
    if estimator not in EST.KINDS:
        raise ValueError(f'unknown estimator kind {estimator!r}; expected '
                         f'{EST.KINDS}')

    def period(carry, plant, cmd_t, dist, mode_cmd):
        """One MPC period: the mode command (with a schedule), 5 ticks and
        plant steps, the NaN quarantine.  Returns (carry', plant', the
        period's diagnostics)."""
        terrain = (cmd_t.terrain_step_height, cmd_t.terrain_step_length)
        c0, p0 = carry, plant
        c, p = c0, p0
        if with_schedule:
            with span('period.mode'):
                c = apply_mode_command(c, observe(p), mode_cmd, cfg,
                                       estimator=estimator)
        diag0 = None
        for k in range(cfg.mpc.mpc_cadence):
            with span('period.tick'):
                c, motor_cmd, wrench, stance, diag = controller_tick(
                    c, observe(p), cmd_t, do_mpc=(k == 0), cfg=cfg,
                    estimator=estimator, est_ground_z=est_ground_z,
                    noise=noise)
            if k == 0:
                # the per-period GRF/contact telemetry (the
                # foot_contact_plugin wrench topics)
                diag0 = {**diag, 'wrench': wrench, 'contact': stance}
            with span('period.plant'):
                p = plant_step(p, motor_cmd, wrench, stance, dist, terrain)
        # NaN quarantine: a lane this period drove non-finite is frozen
        # at its last finite state and flipped passive
        with span('period.quarantine'):
            healthy = (C.finite_lanes(p.position) & C.finite_lanes(p.v_world)
                       & C.finite_lanes(p.quat) & C.finite_lanes(p.q))
            plant = _where_tree(healthy, p, p0)
            mode = torch.where(healthy, c.mode,
                               torch.full_like(c.mode, C.MODE_PASSIVE))
            carry = _where_tree(healthy, c, c0)._replace(mode=mode,
                                                         tick=c.tick)
            diag0.update(mode=mode, fallen=diag0['fallen'] | ~healthy,
                         quarantined=~healthy)
        return carry, plant, diag0

    def eager(carry, plant, cmd, disturbance=None, schedule=None):
        diags = []
        for t in range(n_periods):
            cmd_t = (ScenarioCommand(*[f[:, t] for f in schedule[0]])
                     if with_schedule else cmd)
            carry, plant, diag = period(
                carry, plant, cmd_t,
                disturbance[:, t] if with_disturbance else None,
                schedule[1][:, t] if with_schedule else None)
            diags.append(diag)
        stacked = {key: torch.stack([d[key] for d in diags], dim=1)
                   for key in diags[0]}
        return carry, plant, stacked

    def step(state, inputs, i):
        """The period as graph.StepGraph replays it: period i's slices of
        the disturbance and the schedule read on the device."""
        def at(x):
            return x.index_select(1, i).squeeze(1)

        cmd_t = (ScenarioCommand(*[at(f) for f in inputs['schedule'][0]])
                 if with_schedule else inputs['cmd'])
        carry, plant, diag = period(
            *state, cmd_t,
            at(inputs['disturbance']) if with_disturbance else None,
            at(inputs['schedule'][1]) if with_schedule else None)
        return (carry, plant), diag

    graphed = graph.StepGraph(step, n_periods)

    def rollout(carry, plant, cmd, disturbance=None, schedule=None):
        backend = M.resolve_backend(cfg.solver.backend, plant.position.device)
        if backend not in GRAPH_BACKENDS:
            return eager(carry, plant, cmd, disturbance, schedule)
        inputs = {}
        if with_schedule:
            inputs['schedule'] = schedule
        else:
            inputs['cmd'] = cmd
        if with_disturbance:
            inputs['disturbance'] = disturbance
        (carry, plant), diags = graphed((carry, plant), inputs)
        return carry, plant, diags

    def with_form(run):
        if with_disturbance and with_schedule:
            def fn(carry, plant, cmd, disturbance, schedule):
                return run(carry, plant, cmd, disturbance, schedule)
        elif with_disturbance:
            def fn(carry, plant, cmd, disturbance):
                return run(carry, plant, cmd, disturbance=disturbance)
        elif with_schedule:
            def fn(carry, plant, cmd, schedule):
                return run(carry, plant, cmd, schedule=schedule)
        else:
            def fn(carry, plant, cmd):
                return run(carry, plant, cmd)
        return fn

    fn = with_form(rollout)

    def init(plant, key=None):
        """init_controller_carry bound to this rollout's cfg and noise model
        (the lane's true gyro bias and its per-tick noise come from the same
        SensorNoise)."""
        return init_controller_carry(observe(plant), cfg, key=key,
                                     noise=noise)

    fn.init = init
    fn.eager = with_form(eager)
    fn.graphed = graphed
    return fn


def make_rollout(n_periods: int, cfg: HectorConfig = DEFAULT_CONFIG,
                 with_disturbance: bool = False, estimator: str = 'cheater',
                 with_schedule: bool = False,
                 noise: EST.SensorNoise = EST.SensorNoise()):
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

    estimator: 'cheater' | 'filtered' | 'kf', the kind that drives the
    controller (estimation.py).  noise: the sensor noise model of the
    non-cheater kinds; ``rollout.init(plant, key=None)`` builds the carry
    with the same model (init_controller_carry).

    Lanes that go non-finite in a period are frozen at their last finite
    state and flipped passive (NaN quarantine, runtime.py:330-347).

    Under a backend of GRAPH_BACKENDS the period is captured as a CUDA
    graph at the first call for a batch size, dtype and device and
    replayed once a period (the reference's jax.jit of its lax.scan);
    ``rollout.eager`` is the same call run as a Python loop of periods.
    """
    def plant_step(p, motor_cmd, wrench, stance, dist, terrain):
        return srb.step(p, motor_cmd, wrench, stance, disturbance=dist,
                        terrain=terrain, cfg=cfg)

    return _rollout(n_periods, cfg, with_disturbance, estimator,
                    with_schedule, noise, lambda p: p, plant_step, 0.0)


def whole_body_observation(p) -> srb.PlantState:
    """What the controller and the estimators observe of the articulated
    plant: each leg's contact flag is the plant's own stick state (any of
    the leg's toe-box corners in ground contact, the foot_contact_plugin's
    ContactSensor) and foot_anchor is the mean world position of the leg's
    toe-box corners."""
    from .plant import whole_body as WB
    pts = WB.foot_positions(p)                       # (B, 2, 4, 3) world
    bsz = p.position.shape[0]
    contact = p.sticking[:, :WB.N_TOE].reshape(bsz, 2, -1).any(dim=-1)
    return srb.PlantState(
        position=p.position, quat=p.quat, v_world=p.v_world,
        omega_world=p.omega_world, q=p.q, qd=p.qd,
        foot_anchor=pts.mean(dim=2), contact=contact)


def make_rollout_whole_body(n_periods: int,
                            cfg: HectorConfig = DEFAULT_CONFIG,
                            with_disturbance: bool = False,
                            estimator: str = 'cheater',
                            with_schedule: bool = False,
                            ccfg=None, n_substeps: int = 4,
                            noise: EST.SensorNoise = EST.SensorNoise()):
    """The tier-2 rollout: the same controller over the articulated plant
    (plant/whole_body.py), the same call forms, estimator kinds, noise
    model and NaN quarantine as make_rollout.  The controller observes the
    plant through whole_body_observation; contact emerges from the penalty
    model, and only the joint torques act (no commanded-wrench shortcut).
    The KF's foot-height rows expect the FK foot point at
    WB.FK_FOOT_CLEARANCE above the ground.  ``rollout.init(plant_wb,
    key=None)`` builds the carry from the observation.

    ccfg / n_substeps: the contact model (WB.ContactConfig, default the
    production model) and the integrator's substeps a tick, passed to
    WB.step; the rollout keeps the latter as ``.n_substeps``.
    """
    from .plant import whole_body as WB
    if ccfg is None:
        ccfg = WB.ContactConfig()

    def plant_step(p, motor_cmd, wrench, stance, dist, terrain):
        return WB.step(p, motor_cmd, cfg=cfg, terrain=terrain,
                       disturbance=dist, ccfg=ccfg, n_substeps=n_substeps)

    fn = _rollout(n_periods, cfg, with_disturbance, estimator,
                  with_schedule, noise, whole_body_observation, plant_step,
                  WB.FK_FOOT_CLEARANCE)
    fn.n_substeps = n_substeps
    return fn
