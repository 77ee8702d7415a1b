"""MPC locomotion orchestration: reference trajectory, foot kinematics, QP
build and solve, force/moment extraction (port of ``hector/mpc.py``, after
``ConvexMPC/ConvexMPCLocomotion.cpp``).

Quirks kept (behavior, not accidents): the solver's foot rotations use the
joint angles with the knee-chain offset applied THREE times; the yaw target
is 0 when yaw_rate == 0; the x/y reference switches on the exact float
comparison v_des_world == 0; f_ff = [-rBody GRF; -rBody GRM]; the MPC model
mass is 9.0 and mu is 2.0 (config.MPCConfig).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import HectorConfig, DEFAULT_CONFIG, JOINT_OFFSETS
from . import math as hm
from .kinematics import foot_rotation, hip_yaw_locations
from .qp.builder import (QPData, StageQPParts, build_qp, build_stage_parts,
                         build_stage_qp)
from .qp import fused_riccati, pdip, ref_check, riccati

# SolverConfig.backend values by the problem form they solve; 'auto' is one
# of the first two by the problem's device (resolve_backend)
RICCATI_BACKENDS = ('riccati_pallas', 'riccati_pallas_interpret')
STAGE_BACKENDS = ('riccati',)
DENSE_BACKENDS = ('dense_auto', 'pallas', 'pallas_interpret', 'xla')
# the reference's own qpOASES on the host (qp/ref_check.py)
QPOASES_BACKENDS = ('qpoases',)
BACKENDS = (('auto',) + RICCATI_BACKENDS + STAGE_BACKENDS + DENSE_BACKENDS
            + QPOASES_BACKENDS)


class PlannerState(NamedTuple):
    """Per-scenario planner carry (ConvexMPCLocomotion member state)."""

    world_position_desired: torch.Tensor  # (B, 3)
    f_ff: torch.Tensor                    # (B, 2, 6) latest stance wrench (body)


def init_planner_state(position, dtype=torch.float32) -> PlannerState:
    return PlannerState(
        world_position_desired=position.to(dtype),
        f_ff=torch.zeros((position.shape[0], 2, 6), dtype=dtype,
                         device=position.device))


def foot_positions_world(est, leg_data_p, cfg: HectorConfig):
    """pFoot[i] = p + rBody^T (hipYaw_i + p_leg_i)
    (ConvexMPCLocomotion.cpp:58-62); (B, 2, 3)."""
    return est.position[:, None, :] + (hip_yaw_locations(cfg, leg_data_p)
                                       + leg_data_p) @ est.r_body


def integrate_position_setpoint(state: PlannerState, est, v_des_robot, cfg):
    """Every-tick world_position_desired integration
    (ConvexMPCLocomotion.cpp:47-55)."""
    v_des_world = hm.rmatvec(est.r_body, v_des_robot)
    wpd = state.world_position_desired
    wpd = torch.stack([wpd[:, 0] + cfg.mpc.dt * v_des_world[:, 0],
                       wpd[:, 1] + cfg.mpc.dt * v_des_world[:, 1],
                       torch.full_like(wpd[:, 2], cfg.mpc.body_height)], -1)
    return state._replace(world_position_desired=wpd), v_des_world


def build_reference_trajectory(est, v_des_world, yaw_rate, roll_des,
                               pitch_des, wpd_xy, cfg: HectorConfig):
    """(B, h, 12) reference rollout (ConvexMPCLocomotion.cpp:351-406).
    Row layout: [roll, pitch, yaw, x, y, z, wx, wy, wz, vx, vy, vz]."""
    h = cfg.mpc.horizon
    dtype, dev = est.position.dtype, est.position.device
    dt_mpc = torch.tensor(cfg.mpc.dt_mpc, dtype=dtype, device=dev)
    yaw = est.rpy[:, 2]
    zero = torch.zeros_like(yaw)
    i = torch.arange(h, dtype=dtype, device=dev)[None, :]        # (1, h)
    step = i * dt_mpc

    def lane(x):
        return x[:, None].expand(-1, h)

    # x/y: integrate from wpd when v_des == 0 else extrapolate from p
    vx, vy = v_des_world[:, 0:1], v_des_world[:, 1:2]
    x_row = torch.where(vx == 0, wpd_xy[:, 0:1] + step * vx,
                        est.position[:, 0:1] + step * vx)
    y_row = torch.where(vy == 0, wpd_xy[:, 1:2] + step * vy,
                        est.position[:, 1:2] + step * vy)
    # yaw: 0 target unless commanded, then integrate from current yaw
    yr = yaw_rate[:, None]
    yaw_row = torch.where(yr == 0, torch.zeros_like(step.expand_as(x_row)),
                          yaw[:, None] + step * yr)
    traj = torch.stack([
        lane(roll_des), lane(pitch_des), yaw_row, x_row, y_row,
        lane(torch.full_like(yaw, cfg.mpc.body_height)),
        lane(zero), lane(zero), lane(yaw_rate),
        lane(v_des_world[:, 0]), lane(v_des_world[:, 1]), lane(zero)],
        dim=-1)
    # row 0 = current state (ConvexMPCLocomotion.cpp:369-377)
    traj = traj.clone()
    traj[:, 0, 0:3] = est.rpy
    traj[:, 0, 3:6] = est.position
    return traj


def _qp_inputs(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
               yaw_rate, roll_des, pitch_des, gait_table, cfg, i_body):
    """Everything of one MPC solve up to the QP build: the drift-clamped
    desired position (B, 3) and the arguments both builders take."""
    dtype, dev = est.position.dtype, est.position.device
    offsets = torch.tensor(JOINT_OFFSETS, dtype=dtype, device=dev)
    if i_body is None:
        i_body = torch.diag(torch.tensor(cfg.robot.inertia_body, dtype=dtype,
                                         device=dev))
    v_des_world = hm.rmatvec(est.r_body, v_des_robot)

    # drift clamp on the desired xy (ConvexMPCLocomotion.cpp:335-346)
    wpd = state.world_position_desired
    p = est.position
    wpd_xy = torch.minimum(torch.maximum(wpd[:, :2],
                                         p[:, :2] - cfg.mpc.max_pos_error),
                           p[:, :2] + cfg.mpc.max_pos_error)
    wpd = torch.cat([wpd_xy, wpd[:, 2:]], dim=-1)

    traj = build_reference_trajectory(
        est, v_des_world, yaw_rate, roll_des, pitch_des, wpd_xy, cfg)
    r_feet = p_foot_w - p[:, None, :]
    x0 = torch.cat([est.rpy, p, est.omega_world, est.v_world,
                    torch.full_like(p[:, :1], cfg.mpc.gravity)], dim=-1)
    # triple-offset foot rotation quirk: leg_q is data.q = raw + 1x offsets;
    # two more applications follow in the reference call chain (mpc.py:156)
    r_foot = foot_rotation(leg_q + 2.0 * offsets)
    r_body_world = est.r_body.transpose(-1, -2)
    return wpd, (x0, traj, r_body_world, r_foot, r_feet, i_body, gait_table,
                 cfg.mpc)


def build_parts(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
                yaw_rate, roll_des, pitch_des, gait_table,
                cfg: HectorConfig = DEFAULT_CONFIG, i_body=None):
    """One MPC solve up to the QP, in the production form: the
    drift-clamped desired position (B, 3) and the compact ``StageQPParts``
    of the batch (the fused Riccati backends)."""
    wpd, args = _qp_inputs(state, est, leg_q, p_foot_w, v_des_robot,
                           yaw_rate, roll_des, pitch_des, gait_table, cfg,
                           i_body)
    return wpd, build_stage_parts(*args)


def build_stage(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
                yaw_rate, roll_des, pitch_des, gait_table,
                cfg: HectorConfig = DEFAULT_CONFIG, i_body=None):
    """One MPC solve up to the QP, in the full stage form: the
    drift-clamped desired position (B, 3) and the ``StageQPData`` of the
    batch (the Mehrotra stage solver, backend 'riccati')."""
    wpd, args = _qp_inputs(state, est, leg_q, p_foot_w, v_des_robot,
                           yaw_rate, roll_des, pitch_des, gait_table, cfg,
                           i_body)
    return wpd, build_stage_qp(*args)


def build_dense(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
                yaw_rate, roll_des, pitch_des, gait_table,
                cfg: HectorConfig = DEFAULT_CONFIG, i_body=None):
    """One MPC solve up to the QP, in the condensed form: the drift-clamped
    desired position (B, 3) and the dense ``QPData`` of the batch (the
    dense interior-point backends)."""
    wpd, args = _qp_inputs(state, est, leg_q, p_foot_w, v_des_robot,
                           yaw_rate, roll_des, pitch_des, gait_table, cfg,
                           i_body)
    return wpd, build_qp(*args)


def build_qpoases(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
                  yaw_rate, roll_des, pitch_des, gait_table,
                  cfg: HectorConfig = DEFAULT_CONFIG, i_body=None):
    """One MPC solve up to the QP, for the 'qpoases' backend: the
    drift-clamped desired position (B, 3) and the dense ``QPData`` of the
    batch with its gait table (``ref_check.GaitQPData``), which the
    reference's swing-variable elimination reads."""
    wpd, args = _qp_inputs(state, est, leg_q, p_foot_w, v_des_robot,
                           yaw_rate, roll_des, pitch_des, gait_table, cfg,
                           i_body)
    return wpd, ref_check.GaitQPData(*build_qp(*args), gait_table)


def resolve_backend(backend: str, device) -> str:
    """'auto' by the device the problem lives on, as the reference resolves
    it by ``jax.default_backend()`` (mpc.py:160-164): the fused Riccati
    solver ('riccati_pallas') on the card, the Mehrotra stage solver
    ('riccati') on the CPU.  Any other name is returned as it is."""
    if backend != 'auto':
        return backend
    return 'riccati' if torch.device(device).type == 'cpu' else \
        'riccati_pallas'


def _builder(backend: str):
    """The QP builder of a resolved backend name: (build function, the
    problem type it returns)."""
    if backend in DENSE_BACKENDS:
        return build_dense, QPData
    if backend in STAGE_BACKENDS:
        return build_stage, riccati.StageQPData
    if backend in QPOASES_BACKENDS:
        ref_check.require_qpoases()     # before the QP is even built
        return build_qpoases, ref_check.GaitQPData
    if backend in RICCATI_BACKENDS:
        return build_parts, StageQPParts
    raise ValueError(f'unknown solver backend {backend!r}: one of {BACKENDS}')


def solve(problem, cfg: HectorConfig = DEFAULT_CONFIG):
    """The backend switch (mpc.py:159-209).

    'auto' resolves by the problem's device (:func:`resolve_backend`).
    'riccati_pallas' runs the fused Riccati interior point on
    ``StageQPParts``: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors, with the active-set polish when
    ``cfg.solver.polish_rounds > 0``.  'riccati_pallas_interpret' runs the
    plain version on any device (the reference runs the Pallas kernel in
    interpret mode under that name).  'riccati' runs the stage solver
    (hector_torch/qp/riccati.py, Mehrotra unless ``cfg.solver.mehrotra``
    is off) on ``StageQPData`` on any device, at any horizon.
    'dense_auto', 'pallas', 'pallas_interpret' and 'xla' run the dense
    interior point (hector_torch/qp/pdip.py) on ``QPData``; 'dense_auto'
    stands for the solver's own 'auto'.  'qpoases' runs the reference's
    qpOASES on the host, one lane after another, on ``GaitQPData``
    (hector_torch/qp/ref_check.py); it raises when the qpOASES sources are
    missing."""
    backend = resolve_backend(cfg.solver.backend, problem[0].device)
    build, form = _builder(backend)
    if not isinstance(problem, form):
        raise TypeError(f'backend {backend!r} solves {form.__name__} '
                        f'({build.__name__}), got {type(problem).__name__}')
    if backend in DENSE_BACKENDS:
        scfg = cfg.solver
        if backend == 'dense_auto':
            scfg = dataclasses.replace(scfg, backend='auto')
        return pdip.solve_batched(problem, scfg)
    if backend in STAGE_BACKENDS:
        return riccati.solve_batched(problem, cfg.solver)
    if backend in QPOASES_BACKENDS:
        return ref_check.solve_batched_qpoases(problem)
    # the kernel is built for the reference's fixed problem shape; a config
    # change must fail loudly here, not deep inside the kernel
    if cfg.mpc.horizon != fused_riccati.H:
        raise ValueError(
            f'the fused Riccati solver is built for horizon '
            f'{fused_riccati.H}, config has {cfg.mpc.horizon}; use '
            f"backend='riccati' for other horizons")
    solve_parts = (fused_riccati.solve_parts_plain
                   if backend == 'riccati_pallas_interpret'
                   else fused_riccati.solve_parts)
    return solve_parts(problem, cfg.solver,
                       q_diag=tuple(cfg.mpc.weights) + (0.0,),
                       r_diag=tuple(cfg.mpc.alpha))


def mpc_update(state: PlannerState, est, leg_q, p_foot_w, v_des_robot,
               yaw_rate, roll_des, pitch_des, gait_table,
               cfg: HectorConfig = DEFAULT_CONFIG, i_body=None):
    """One 200 Hz MPC solve for the batch (updateMPCIfNeeded,
    ConvexMPCLocomotion.cpp:274-441).

    leg_q: (B, 2, 5) the offset-corrected data.q.  Returns (new
    PlannerState, per-leg world GRF/GRM (B, 2, 6), QPSolution).
    """
    build, _ = _builder(resolve_backend(cfg.solver.backend,
                                        est.position.device))
    wpd, problem = build(state, est, leg_q, p_foot_w, v_des_robot, yaw_rate,
                         roll_des, pitch_des, gait_table, cfg, i_body)
    sol = solve(problem, cfg)
    u0 = sol.u[:, :12]
    bsz = u0.shape[0]
    grf = u0[:, 0:6].reshape(bsz, 2, 3)   # world-frame ground reaction forces
    grm = u0[:, 6:12].reshape(bsz, 2, 3)  # world-frame reaction moments
    # f_ff = [-rBody GRF; -rBody GRM] (ConvexMPCLocomotion.cpp:428-439)
    r_t = est.r_body.transpose(-1, -2)
    f_ff = torch.cat([-(grf @ r_t), -(grm @ r_t)], dim=-1)
    new_state = PlannerState(world_position_desired=wpd, f_ff=f_ff)
    return new_state, torch.cat([grf, grm], dim=-1), sol
