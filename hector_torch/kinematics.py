"""Leg forward kinematics, Jacobians, foot rotation and analytic IK (port of
``hector/kinematics.py``).

Each leg is the chain Rz(q0) Rx(q1) Ry(q2) Ry(q3) Ry(q4) with translations;
the constants come from ``config.py`` (LegFKModel / LegJacobianModel /
LegIKModel).  The reference's quirks are kept: the FK and Jacobian chains use
different constants, and the IK has its own side convention.

The JAX package takes the force Jacobian as ``jax.jacfwd`` of the Jacobian
chain; here it is the same derivative written in closed form.

All functions take the two legs stacked on axis -2: q has shape (..., 2, 5);
leg 0 is left.

:func:`leg_data` is what the controller tick reads of the legs: on CUDA
tensors one launch of ``tick_legs_kernel`` (``hector_torch/csrc/
srb_plant.cu``, beside the plant step, whose device functions and
constants, :func:`srb_params`, it shares), counted in ``legs_launches`` of
the registry ``cuda.counts``; on CPU tensors the batched ops of
:func:`leg_jacobians`, :func:`foot_position` and the offsets.  The JAX
package leaves these to XLA's fusion, so the kernel replaces no TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import constant
from .config import HectorConfig, DEFAULT_CONFIG, JOINT_OFFSETS
from .cuda import SRB, LegsArgs, make_srb_params

# side sign per leg for the FK / Jacobian models (LegController.cpp:122-126)
FK_SIDE = (1.0, -1.0)
# side sign per leg in the IK's own convention (SwingLegController.cpp:160)
IK_SIDE = (-1.0, 1.0)


def hip_yaw_locations(cfg: HectorConfig, like):
    """(2, 3) hip-yaw joint locations in the body frame (Biped.h), with the
    dtype and device of ``like``."""
    return constant(
        ('hip_yaw_locations', cfg.robot),
        [cfg.robot.hip_yaw_location(0), cfg.robot.hip_yaw_location(1)], like)


def _offsets(like):
    return constant('JOINT_OFFSETS', JOINT_OFFSETS, like)


def apply_joint_offsets(q):
    """Raw motor angles -> effective chain angles (+0.3pi, -0.6pi, +0.3pi on
    the knee chain; LegController.cpp:111-113)."""
    return q + _offsets(q)


def _chain_terms(q5, b_y, l1, l2, l3):
    """Shared trigonometry of the chain for one leg; q5 (..., 5)."""
    q0, q1, q2, q3, q4 = (q5[..., i] for i in range(5))
    s23 = q2 + q3
    s234 = s23 + q4
    t = dict(
        c0=torch.cos(q0), s0=torch.sin(q0), c1=torch.cos(q1),
        s1=torch.sin(q1), c2=torch.cos(q2), s2=torch.sin(q2),
        c23=torch.cos(s23), s23=torch.sin(s23), c234=torch.cos(s234),
        s234=torch.sin(s234))
    # planar reach in the pitch plane
    t['sx'] = l1 * t['s2'] + l2 * t['s23'] + l3 * t['s234']
    t['kz'] = l1 * t['c2'] + l2 * t['c23'] + l3 * t['c234']
    # u = b + (-sx, 0, -kz); v = Rx(q1) u
    u_z = -t['kz']
    t['v_x'] = -t['sx']
    t['v_y'] = t['c1'] * b_y - t['s1'] * u_z
    t['v_z'] = t['s1'] * b_y + t['c1'] * u_z
    return t


def _chain_position(q5, a_x, a_y, a_z, b_y, l1, l2, l3):
    """p = Rz(q0) (a + Rx(q1) (b + Ry(q2)(0,0,-l1) + Ry(q2+q3)(0,0,-l2)
    + Ry(q2+q3+q4)(0,0,-l3)))."""
    t = _chain_terms(q5, b_y, l1, l2, l3)
    w_x, w_y = a_x + t['v_x'], a_y + t['v_y']
    return torch.stack([t['c0'] * w_x - t['s0'] * w_y,
                        t['s0'] * w_x + t['c0'] * w_y,
                        a_z + t['v_z']], dim=-1)


def _chain_jacobian(q5, a_x, a_y, b_y, l1, l2, l3):
    """d p / d q of _chain_position, (..., 3, 5), in closed form."""
    t = _chain_terms(q5, b_y, l1, l2, l3)
    c0, s0, c1, s1 = t['c0'], t['s0'], t['c1'], t['s1']
    w_x, w_y = a_x + t['v_x'], a_y + t['v_y']
    zero = torch.zeros_like(c0)
    cols = [torch.stack([-s0 * w_x - c0 * w_y, c0 * w_x - s0 * w_y, zero], -1)]
    # q1: only v_y, v_z move
    dvy = -s1 * b_y + c1 * t['kz']
    dvz = c1 * b_y + s1 * t['kz']
    cols.append(torch.stack([-s0 * dvy, c0 * dvy, dvz], -1))
    # q2, q3, q4: d sx and d kz of the planar reach
    dsx = (l1 * t['c2'] + l2 * t['c23'] + l3 * t['c234'],
           l2 * t['c23'] + l3 * t['c234'],
           l3 * t['c234'])
    dkz = (-(l1 * t['s2'] + l2 * t['s23'] + l3 * t['s234']),
           -(l2 * t['s23'] + l3 * t['s234']),
           -l3 * t['s234'])
    for j in range(3):
        dvx = -dsx[j]
        dvy = s1 * dkz[j]
        dvz = -c1 * dkz[j]
        cols.append(torch.stack([c0 * dvx - s0 * dvy, s0 * dvx + c0 * dvy,
                                 dvz], -1))
    return torch.stack(cols, dim=-1)


def foot_position(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """Foot position in the hip-yaw frame for both legs.

    q_raw: (..., 2, 5) raw motor angles.  Returns (..., 2, 3).
    Parity target: LegController.cpp:190-194.
    """
    q = apply_joint_offsets(q_raw)
    fk = cfg.fk
    legs = [_chain_position(q[..., leg, :], fk.a_x, fk.a_y_side * s, fk.a_z,
                            fk.b_y_side * s, fk.l_thigh, fk.l_calf, fk.l_toe)
            for leg, s in enumerate(FK_SIDE)]
    return torch.stack(legs, dim=-2)


def leg_jacobians(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """(J_force_moment (..., 2, 6, 5), J_force (..., 2, 3, 5)).

    J_force is d p_J / d q of the Jacobian-model chain (the reference's
    symbolic matrix, LegController.cpp:131-186); the angular rows 3:6 are
    the world-frame joint axes (z, Rz x, Rz Rx y).
    """
    q = apply_joint_offsets(q_raw)
    jm = cfg.jac
    jms, jfs = [], []
    for leg, s in enumerate(FK_SIDE):
        q5 = q[..., leg, :]
        jf = _chain_jacobian(q5, jm.a_x, jm.a_y_side * s,
                             jm.b_y_side * s + jm.b_y_const,
                             jm.l_thigh, jm.l_calf, jm.l_toe)
        c0, s0 = torch.cos(q5[..., 0]), torch.sin(q5[..., 0])
        c1, s1 = torch.cos(q5[..., 1]), torch.sin(q5[..., 1])
        z = torch.zeros_like(c0)
        one = torch.ones_like(c0)
        ax_yaw = torch.stack([z, z, one], -1)
        ax_roll = torch.stack([c0, s0, z], -1)
        ax_pitch = torch.stack([-c1 * s0, c0 * c1, s1], -1)
        jang = torch.stack([ax_yaw, ax_roll, ax_pitch, ax_pitch, ax_pitch],
                           dim=-1)                        # (..., 3, 5)
        jms.append(torch.cat([jf, jang], dim=-2))
        jfs.append(jf)
    return torch.stack(jms, dim=-3), torch.stack(jfs, dim=-3)


def leg_data(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """What the controller tick reads of the legs (LegController::updateData
    with the data.q quirk): (J_force_moment (B, 2, 6, 5), the first output
    of :func:`leg_jacobians`; p_leg (B, 2, 3), :func:`foot_position`;
    q_data (B, 2, 5), the offset-corrected angles) of raw motor angles
    q_raw (B, 2, 5).

    A CUDA tensor goes to :func:`leg_data_cuda`, a CPU tensor to the batched
    ops; nothing falls back from one to the other.
    """
    if q_raw.device.type == 'cuda':
        return leg_data_cuda(q_raw, cfg)
    j_fm, _ = leg_jacobians(q_raw, cfg)
    return j_fm, foot_position(q_raw, cfg), q_raw + _offsets(q_raw)


@functools.cache
def srb_params(cfg: HectorConfig, dtype):
    """The ``SrbParams`` of ``cfg`` for a state of ``dtype`` (float32 or
    float64), made once per pair: the constants of both kernels of
    csrc/srb_plant.cu, in double precision, each the Python number (or the
    values of the constant tensor) that the plain versions round to the
    state's dtype."""
    pc, fk, jm, ik, sw = cfg.plant, cfg.fk, cfg.jac, cfg.ik, cfg.swing
    hip = [cfg.robot.hip_yaw_location(0), cfg.robot.hip_yaw_location(1)]
    x, y = sw.hip_width_offset_x, sw.hip_width_offset_y
    return make_srb_params(dtype, dict(
        dt=pc.dt, mass=pc.mass, gravity=pc.gravity,
        torque_limit=pc.torque_limit, contact_kp=pc.contact_kp,
        contact_kd=pc.contact_kd, trunk_radius=pc.trunk_radius,
        ground_mu=pc.ground_mu, joint_vel_limit=pc.joint_vel_limit,
        joint_tracking_tau=pc.joint_tracking_tau,
        swing_joint_inertia=pc.swing_joint_inertia,
        inertia=list(pc.inertia_body), offsets=list(JOINT_OFFSETS),
        hip_yaw=[v for leg in hip for v in leg],
        hip_width=[x, -y, 0.0, x, y, 0.0],
        fk_a_x=fk.a_x, fk_a_y=[fk.a_y_side * s for s in FK_SIDE],
        fk_a_z=fk.a_z, fk_b_y=[fk.b_y_side * s for s in FK_SIDE],
        fk_l=[fk.l_thigh, fk.l_calf, fk.l_toe],
        jac_a_x=jm.a_x, jac_a_y=[jm.a_y_side * s for s in FK_SIDE],
        jac_b_y=[jm.b_y_side * s + jm.b_y_const for s in FK_SIDE],
        jac_l=[jm.l_thigh, jm.l_calf, jm.l_toe],
        ik_hip_x=ik.hip_x, ik_hip_z=ik.hip_z, ik_dh=ik.distance_horizontal,
        ik_dh2=ik.distance_horizontal ** 2, ik_eps=ik.eps_vertical,
        ik_two_l=2.0 * ik.l_link, ik_side=list(IK_SIDE), pi=math.pi))


def legs_launch_args(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """The kernel's arguments: (``LegsArgs``, the ``SrbParams`` of ``cfg``,
    the outputs (j_fm, p_leg, q_data) as new tensors on q_raw's device).
    Takes a float32 or float64 (B, 2, 5) tensor of any strides (read
    through them, nothing copied); raises on anything else."""
    if not isinstance(q_raw, torch.Tensor):
        raise TypeError(f'leg_data: q must be a tensor, got {type(q_raw)}')
    dtype, dev = q_raw.dtype, q_raw.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'leg_data: the kernel takes float32 or float64, '
                        f'got {dtype}')
    if q_raw.dim() != 3 or tuple(q_raw.shape[1:]) != (2, 5):
        raise ValueError(f'leg_data: q must have shape (B, 2, 5), got '
                         f'{tuple(q_raw.shape)}')
    bsz = q_raw.shape[0]
    out = (torch.empty((bsz, 2, 6, 5), dtype=dtype, device=dev),
           torch.empty((bsz, 2, 3), dtype=dtype, device=dev),
           torch.empty((bsz, 2, 5), dtype=dtype, device=dev))
    args = LegsArgs(q_raw.data_ptr(), *q_raw.stride(),
                    (ctypes.c_void_p * 3)(*[t.data_ptr() for t in out]), bsz)
    return args, srb_params(cfg, dtype), out


def leg_data_cuda(q_raw, cfg: HectorConfig = DEFAULT_CONFIG):
    """:func:`leg_data` as one launch of ``tick_legs_kernel`` on the current
    stream, no synchronisation, counted in ``legs_launches``; raises on
    what :func:`legs_launch_args` refuses, on a tensor off the card and on
    a launch error."""
    dev = q_raw.device
    if dev.type != 'cuda':
        raise ValueError(f'kinematics.leg_data_cuda: q is on {dev}, the '
                         f'kernel runs on a CUDA device')
    args, prm, out = legs_launch_args(q_raw, cfg)
    SRB.launch('tick_legs', dev, int(q_raw.dtype == torch.float64),
               ctypes.byref(args), ctypes.byref(prm),
               counted=('legs_launches',))
    return out


def foot_rotation(q_eff):
    """R_foot = Rz(q0) Rx(q1) Ry(q2+q3+q4) for both legs.

    q_eff: (..., 2, 5) effective angles; the caller decides how many offset
    corrections are applied (mpc.py applies the reference's triple
    correction).  Parity target: SolverMPC.cpp:428-433.
    """
    q0, q1 = q_eff[..., 0], q_eff[..., 1]
    s234 = q_eff[..., 2] + q_eff[..., 3] + q_eff[..., 4]
    c0, s0 = torch.cos(q0), torch.sin(q0)
    c1, s1 = torch.cos(q1), torch.sin(q1)
    cs, ss = torch.cos(s234), torch.sin(s234)
    r = torch.stack([
        c0 * cs - s0 * s1 * ss, -s0 * c1, c0 * ss + s0 * s1 * cs,
        s0 * cs + c0 * s1 * ss, c0 * c1, s0 * ss - c0 * s1 * cs,
        -c1 * ss, s1, c1 * cs,
    ], dim=-1)
    return r.reshape(q_eff.shape[:-1] + (3, 3))


def foot_velocity(q_raw, qd, cfg: HectorConfig = DEFAULT_CONFIG):
    """v = J_force @ qd for both legs (LegController.cpp:52); (..., 2, 3)."""
    _, jf = leg_jacobians(q_raw, cfg)
    return torch.matmul(jf, qd.unsqueeze(-1)).squeeze(-1)


def leg_ik(p_foot_b, q_data, cfg: HectorConfig = DEFAULT_CONFIG):
    """Geometric 5-DoF IK; returns raw-motor-frame joint targets.

    p_foot_b: (..., 2, 3) desired foot position in body frame; q_data:
    (..., 2, 5) current offset-corrected angles (the toe joint follows
    theta4 = -q3 - q2, SwingLegController.cpp:181).
    Parity target: SwingLegController.cpp:157-187.
    """
    ik = cfg.ik
    side = constant('IK_SIDE', IK_SIDE, p_foot_b)
    hip = constant(('ik_hip', ik.hip_x, ik.hip_z), [ik.hip_x, 0.0, ik.hip_z],
                   p_foot_b)
    d = p_foot_b - hip
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    dist3 = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    dist_yoz = torch.sqrt(d1 * d1 + d2 * d2)
    dh = ik.distance_horizontal
    dist_vert = torch.sqrt(torch.clamp(dist_yoz ** 2 - dh ** 2,
                                       min=ik.eps_vertical))
    # the reference takes pow(dist3^2 - dh^2, 0.5) unguarded
    # (SwingLegController.cpp:168); the same epsilon clamp keeps every lane
    # finite (identical output for reachable targets)
    dist_xoz = torch.sqrt(torch.clamp(dist3 ** 2 - dh ** 2,
                                      min=ik.eps_vertical))

    def clamp1(x):
        return torch.clamp(x, -1.0, 1.0)

    acos_arg1 = clamp1(dist_xoz / (2.0 * ik.l_link))
    acos_arg2 = clamp1(dist_vert / dist_xoz)
    divisor = torch.where(torch.abs(d0) == 0.0,
                          torch.full_like(d0, 1e-6), torch.abs(d0))

    th0 = torch.zeros_like(d0)
    th1 = (torch.asin(clamp1(d1 / dist_yoz))
           + torch.asin(clamp1(dh * side / dist_yoz)))
    th2 = torch.acos(acos_arg1) - torch.acos(acos_arg2) * d0 / divisor
    th3 = 2.0 * torch.asin(clamp1(dist_xoz / (2.0 * ik.l_link))) - math.pi
    th4 = -q_data[..., 3] - q_data[..., 2]

    q_des = torch.stack([th0, th1, th2, th3, th4], dim=-1)
    return q_des - _offsets(q_des)
