"""Pluggable state estimation (port of ``hector/estimation.py``).

An estimator is a pure function (carry, measurements) -> (carry,
StateEstimate) over a batch of lanes, so every kind composes with the same
rollout:

- ``cheater``: ground truth, the reference's configuration (main.cpp:46-47);
- ``noisy_sensors``, ``imu_accel``, ``gyro_body_meas``: the sensor model
  (a body-frame rate gyro with a constant per-lane bias, the body-frame
  specific force, and direct pos/vel/quat proxies used only by the staged
  'filtered' kind), with Gaussian noise drawn from ``prng``, the port's copy
  of ``jax.random``, so that a lane draws the JAX package's noise;
- ``filtered``: a first-order IIR low-pass on the noisy pos/vel channels
  (FirstOrderIIRFilter.h);
- ``mahony_*``: the gyro-integrating Mahony orientation filter with the
  accelerometer's gravity correction and bias estimation;
- ``kf_*``: the contact-aided linear Kalman filter over [p, v, p_feet]
  (12 states, 14 measurements).

The 'kf' kind composes Mahony and the KF into the sensor-honest path: gyro,
accelerometer, joint encoders and contact flags are its only inputs.  The
JAX module's docstring and comments give the modeling rationale
(observability of yaw, contact gating by inflated noise).

Every tensor carries the lane batch as its leading dimension B.  The tick
(``est_update``) synchronises with no card: its constants are cached on the
device and the KF's 14x14 solve is ``torch.linalg.solve_ex``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constant, resolve_device
from . import control as C
from . import math as hm
from . import prng

KINDS = ('cheater', 'filtered', 'kf')


class SensorNoise(NamedTuple):
    pos_std: float = 0.002
    vel_std: float = 0.02
    gyro_std: float = 0.01
    quat_std: float = 0.002   # small-angle noise, radians
    accel_std: float = 0.05   # accelerometer, m/s^2 (body-frame channels)
    gyro_bias_std: float = 0.005  # per-lane constant gyro bias, rad/s


def _noisy_quat(quat, dq):
    """The unit quaternion rotated by the small angle dq (B, 3)."""
    w, x, y, z = (quat[..., i] for i in range(4))
    dx, dy, dz = dq[..., 0], dq[..., 1], dq[..., 2]
    q = torch.stack([
        w - 0.5 * (x * dx + y * dy + z * dz),
        x + 0.5 * (w * dx + y * dz - z * dy),
        y + 0.5 * (w * dy + z * dx - x * dz),
        z + 0.5 * (w * dz + x * dy - y * dx),
    ], dim=-1)
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def noisy_sensors(key, plant, noise: SensorNoise = SensorNoise()):
    """Corrupt plant ground truth into measurements; key (B, 2).  The four
    channels draw from split(key, 4), in one threefry pass."""
    eps = prng.normal(prng.split(key, 4), (3,), plant.position.dtype)
    pos = plant.position + noise.pos_std * eps[:, 0]
    vel = plant.v_world + noise.vel_std * eps[:, 1]
    gyro = plant.omega_world + noise.gyro_std * eps[:, 2]
    quat = _noisy_quat(plant.quat, noise.quat_std * eps[:, 3])
    return pos, vel, quat, gyro


def _gravity_vector(gravity, like):
    return constant(('gravity_vector', gravity), [0.0, 0.0, -gravity], like)


def _imu_accel(plant, prev_v, dt, eps, noise, gravity):
    a_true = (plant.v_world - prev_v) / dt
    r_bw = hm.quat_to_rot(plant.quat)                  # body->world (true)
    f_body = hm.rmatvec(r_bw, a_true - _gravity_vector(gravity, a_true))
    return f_body + noise.accel_std * eps


def imu_accel(key, plant, prev_v, dt, noise: SensorNoise = SensorNoise(),
              gravity: float = 9.81):
    """Body-frame accelerometer (specific force): the finite difference of
    the true velocity over the last tick minus gravity, rotated into the
    body frame, plus noise.  ``gravity`` is the plant's own constant."""
    eps = prng.normal(key, (3,), plant.position.dtype)
    return _imu_accel(plant, prev_v, dt, eps, noise, gravity)


def _gyro_body(plant, bias, eps, noise):
    w_body = hm.rmatvec(hm.quat_to_rot(plant.quat), plant.omega_world)
    return w_body + bias + noise.gyro_std * eps


def gyro_body_meas(key, plant, bias, noise: SensorNoise = SensorNoise()):
    """Body-frame rate gyro: true body rate + constant per-lane bias +
    white noise (the channel the honest 'kf' path consumes)."""
    eps = prng.normal(key, (3,), plant.position.dtype)
    return _gyro_body(plant, bias, eps, noise)


def cheater(plant) -> C.StateEstimate:
    """Ground-truth passthrough (the reference's cheater estimators)."""
    return C.estimate_state(plant.position, plant.v_world, plant.quat,
                            plant.omega_world)


class FilterState(NamedTuple):
    pos: torch.Tensor          # (B, 3)
    vel: torch.Tensor          # (B, 3)


def init_filter_state(plant) -> FilterState:
    return FilterState(pos=plant.position, vel=plant.v_world)


def filtered(state: FilterState, pos_meas, vel_meas, quat_meas, gyro_meas,
             alpha: float = 0.3):
    """First-order IIR low-pass y += alpha (x - y) on the direct pos/vel
    channels (a documented staging cheat: no real sensor gives them)."""
    pos = state.pos + alpha * (pos_meas - state.pos)
    vel = state.vel + alpha * (vel_meas - state.vel)
    est = C.estimate_state(pos, vel, quat_meas, gyro_meas)
    return FilterState(pos=pos, vel=vel), est


# ---------------------------------------------------------------------------
# Mahony complementary orientation filter (gyro propagation at 1 kHz, the
# accelerometer's gravity-direction correction, gyro-bias estimation; yaw is
# pure gyro integration, unobservable from the accelerometer)


class MahonyState(NamedTuple):
    quat: torch.Tensor         # (B, 4) wxyz, estimated body->world
    bias: torch.Tensor         # (B, 3) estimated gyro bias, body frame


def mahony_init(batch: int, dtype=torch.float32,
                device='cuda') -> MahonyState:
    """Initial alignment: identity attitude, zero bias, on every lane."""
    dev = resolve_device(device)
    quat = torch.zeros((batch, 4), dtype=dtype, device=dev)
    quat[:, 0] = 1.0
    return MahonyState(quat=quat,
                       bias=torch.zeros((batch, 3), dtype=dtype, device=dev))


def mahony_update(m: MahonyState, gyro_b, f_body, dt,
                  kp: float = 2.0, ki: float = 0.3,
                  gravity: float = 9.81) -> MahonyState:
    """One 1 kHz step: propagate the quaternion with the bias-corrected body
    rate, corrected toward the accelerometer's gravity direction, the
    correction gated off as |f| leaves g (dynamic accelerations)."""
    r_bw = hm.quat_to_rot(m.quat)
    # r_bw^T (0, 0, 1): the predicted up direction in the body frame
    v_hat = r_bw[:, 2, :]
    f_norm = torch.sqrt(torch.sum(f_body * f_body, dim=-1, keepdim=True))
    v_meas = f_body / torch.clamp(f_norm, min=1e-6)       # measured up
    # max() guards gravity = 0 worlds: the gate is zero for any nonzero |f|
    gate = torch.clamp(
        1.0 - 2.0 * torch.abs(f_norm - gravity) / max(gravity, 1e-6),
        0.0, 1.0)
    err = hm.cross(v_meas, v_hat) * gate
    bias = m.bias - ki * dt * err
    w_corr = gyro_b - bias + kp * err                      # body frame
    quat = hm.quat_integrate(m.quat, hm.matvec(r_bw, w_corr), dt)
    return MahonyState(quat=quat, bias=bias)


# ---------------------------------------------------------------------------
# Contact-aided linear Kalman filter.  State x = [p, v, p_f0, p_f1] (world,
# 12); process p' = p + dt v, v' = v + dt a, feet stationary; measurements
# (14): the per-leg kinematic foot offsets p_f_i - p = R_bw (hip_i + p_leg_i)
# (rows 0:6), the per-leg velocity v = -R_bw (J qd + omega x rel_i) (6:12),
# the per-leg foot height p_f_i,z = ground height (12:14).  A swing leg stays
# in the filter, its noise inflated by 1/trust.


class KFNoise(NamedTuple):
    q_pos: float = 0.0004      # process noise densities (per sqrt(dt))
    q_vel: float = 0.02
    q_foot: float = 0.0004
    r_rel: float = 0.001       # kinematic relative-position measurement
    r_vel: float = 0.05        # kinematic velocity measurement
    r_height: float = 0.001    # foot-height measurement
    swing_inflation: float = 1e6


class KFState(NamedTuple):
    x: torch.Tensor            # (B, 12)
    cov: torch.Tensor          # (B, 12, 12)


def _kf_h() -> np.ndarray:
    """The (14, 12) measurement matrix."""
    h = np.zeros((14, 12))
    for i in range(2):
        h[3 * i:3 * i + 3, 0:3] = -np.eye(3)                  # -p
        h[3 * i:3 * i + 3, 6 + 3 * i:9 + 3 * i] = np.eye(3)   # +p_f_i
        h[6 + 3 * i:9 + 3 * i, 3:6] = np.eye(3)               # v
        h[12 + i, 8 + 3 * i] = 1.0                            # p_f_i,z
    return h


def _kf_a(dt) -> np.ndarray:
    """The (12, 12) process matrix: p' = p + dt v."""
    a = np.eye(12)
    a[0:3, 3:6] = dt * np.eye(3)
    return a


def kf_init(position, v_world, p_feet_world, cov0: float = 0.01) -> KFState:
    """p_feet_world: (B, 2, 3) initial world foot positions."""
    bsz = position.shape[0]
    x = torch.cat([position, v_world, p_feet_world.reshape(bsz, 6)], dim=-1)
    eye = torch.eye(12, dtype=x.dtype, device=x.device)
    return KFState(x=x, cov=(cov0 * eye).expand(bsz, 12, 12).clone())


def kf_update(kf: KFState, accel_world, r_body, rel_body, rel_vel_body,
              omega_body, contact, dt, ground_z=0.0,
              noise: KFNoise = KFNoise()) -> KFState:
    """One predict + update step.

    accel_world (B, 3): gravity-compensated world acceleration input;
    r_body (B, 3, 3): world->body; rel_body (B, 2, 3): body-frame
    trunk->foot vectors; rel_vel_body (B, 2, 3): their rates (J qd);
    omega_body (B, 3); contact (B, 2) in [0, 1]; ground_z: a scalar or
    (B, 2), the terrain height under each foot.
    """
    x, p_cov = kf.x, kf.cov
    bsz = x.shape[0]

    # --- predict ---
    a_mat = constant(('kf_a', dt), lambda: _kf_a(dt), x)
    x = hm.matvec(a_mat, x) + torch.cat(
        [0.5 * dt * dt * accel_world, dt * accel_world,
         torch.zeros_like(x[:, 6:])], dim=-1)
    trust = torch.clamp(contact, 0.0, 1.0)
    infl = 1.0 + (noise.swing_inflation - 1.0) * (1.0 - trust)   # (B, 2)
    foot_q = noise.q_foot * infl
    q_diag = torch.cat([
        torch.full_like(x[:, 0:3], noise.q_pos),
        torch.full_like(x[:, 3:6], noise.q_vel),
        torch.repeat_interleave(foot_q, 3, dim=-1)], dim=-1)
    p_cov = a_mat @ p_cov @ a_mat.T + dt * torch.diag_embed(q_diag)

    # --- measurements ---
    rel_w = rel_body @ r_body                                   # (B, 2, 3)
    relv_w = (rel_vel_body + hm.cross(omega_body[:, None, :], rel_body)
              ) @ r_body
    gz = (ground_z.expand(bsz, 2) if torch.is_tensor(ground_z)
          else torch.full_like(x[:, 0:2], ground_z))
    y = torch.cat([rel_w.reshape(bsz, 6), (-relv_w).reshape(bsz, 6), gz],
                  dim=-1)
    r_diag = torch.cat([
        torch.repeat_interleave(noise.r_rel * infl, 3, dim=-1),
        torch.repeat_interleave(noise.r_vel * infl, 3, dim=-1),
        noise.r_height * infl], dim=-1)

    h = constant('kf_h', _kf_h, x)
    innov = y - hm.matvec(h, x)
    s = h @ p_cov @ h.T + torch.diag_embed(r_diag)
    # solve_ex: no check of info, so no wait on the card (jnp.linalg.solve
    # checks nothing either)
    k_gain = torch.linalg.solve_ex(s, h @ p_cov)[0].transpose(-1, -2)
    x = x + hm.matvec(k_gain, innov)
    eye = torch.eye(12, dtype=x.dtype, device=x.device)
    p_cov = (eye - k_gain @ h) @ p_cov
    p_cov = 0.5 * (p_cov + p_cov.transpose(-1, -2))
    return KFState(x=x, cov=p_cov)


def kf_estimate(kf: KFState, quat_meas, gyro_meas) -> C.StateEstimate:
    """KF posterior + orientation measurements -> StateEstimate."""
    return C.estimate_state(kf.x[:, 0:3], kf.x[:, 3:6], quat_meas, gyro_meas)


# ---------------------------------------------------------------------------
# The estimator carry of the closed loop: the kind is a Python string, the
# carry covers every kind (StateEstimatorContainer.h:110-137)


class EstimatorState(NamedTuple):
    """One carry covering every estimator kind, as in the JAX package."""

    key: torch.Tensor          # (B, 2) PRNG key words of the noise model
    filt: FilterState
    kf: KFState
    mahony: MahonyState        # orientation filter (the honest 'kf' path)
    gyro_bias: torch.Tensor    # (B, 3) TRUE per-lane gyro bias
    prev_v: torch.Tensor       # (B, 3) last-tick true v_world (IMU model)


def _rel_feet_body(plant, cfg):
    """Trunk->foot vectors and their rates in the body frame, from the joint
    encoders (q, qd): (B, 2, 3) each."""
    from .kinematics import foot_position, hip_yaw_locations, leg_jacobians
    rel = hip_yaw_locations(cfg, plant.q) + foot_position(plant.q, cfg)
    _, j_f = leg_jacobians(plant.q, cfg)
    return rel, hm.matvec(j_f, plant.qd)


def est_init(plant, key, cfg,
             noise: SensorNoise = SensorNoise()) -> EstimatorState:
    """The estimator carry at the plant state; key (B, 2).  The lane's true
    gyro bias is drawn from the second half of split(key), as in JAX."""
    rel, _ = _rel_feet_body(plant, cfg)
    r_body = hm.quat_to_rot(plant.quat).transpose(-1, -2)
    p_feet_w = plant.position[:, None, :] + rel @ r_body
    keys = prng.split(key, 2)
    dtype, dev = plant.position.dtype, plant.position.device
    return EstimatorState(
        key=keys[:, 0],
        filt=init_filter_state(plant),
        kf=kf_init(plant.position, plant.v_world, p_feet_w),
        mahony=mahony_init(plant.position.shape[0], dtype, dev),
        gyro_bias=noise.gyro_bias_std * prng.normal(keys[:, 1], (3,), dtype),
        prev_v=plant.v_world)


def est_update(kind: str, state: EstimatorState, plant, cfg,
               noise: SensorNoise = SensorNoise(), ground_z: float = 0.0,
               terrain=None):
    """One 1 kHz estimator tick; returns (new EstimatorState,
    StateEstimate).

    ground_z: the height the KF expects the FK foot point to sit at when
    planted on flat ground, a calibration constant of the foot model (0 on
    the tier-1 plant; plant/whole_body.FK_FOOT_CLEARANCE on the articulated
    one).  terrain: optional (step_height, step_length), (B,) each, the
    terrain map the command carries; the KF's foot-height rows read it at
    each foot's own prior x estimate.  None = flat.
    """
    if kind not in KINDS:
        raise ValueError(f'unknown estimator kind {kind!r}; expected {KINDS}')
    if kind == 'cheater':
        return state, cheater(plant)

    keys = prng.split(state.key, 3)           # key, sub, sub_a
    if kind == 'filtered':
        pos_m, vel_m, quat_m, gyro_m = noisy_sensors(keys[:, 1], plant, noise)
        filt, est = filtered(state.filt, pos_m, vel_m, quat_m, gyro_m)
        return state._replace(key=keys[:, 0], filt=filt), est

    # 'kf': the body-frame gyro, the specific force, the joint encoders and
    # the contact flags only; the gyro (sub) and accelerometer (sub_a)
    # noise in one threefry pass
    dtype, dt, g = plant.position.dtype, cfg.plant.dt, cfg.plant.gravity
    eps = prng.normal(keys[:, 1:3], (3,), dtype)
    gyro_b_m = _gyro_body(plant, state.gyro_bias, eps[:, 0], noise)
    f_body_m = _imu_accel(plant, state.prev_v, dt, eps[:, 1], noise, g)
    mah = mahony_update(state.mahony, gyro_b_m, f_body_m, dt, gravity=g)
    r_bw_est = hm.quat_to_rot(mah.quat)            # body->world (estimated)
    omega_b_est = gyro_b_m - mah.bias
    omega_w_est = hm.matvec(r_bw_est, omega_b_est)

    rel, rel_vel = _rel_feet_body(plant, cfg)
    accel_world = hm.matvec(r_bw_est, f_body_m) + _gravity_vector(g, f_body_m)
    if terrain is None:
        gz = ground_z
    else:
        from .plant.srb import terrain_height
        foot_x_est = state.kf.x[:, 6:10:3]             # prior foot x
        gz = terrain_height(foot_x_est, terrain[0][:, None],
                            terrain[1][:, None]) + ground_z
    kf = kf_update(
        state.kf, accel_world=accel_world,
        r_body=r_bw_est.transpose(-1, -2), rel_body=rel, rel_vel_body=rel_vel,
        omega_body=omega_b_est, contact=plant.contact.to(dtype), dt=dt,
        ground_z=gz)
    est = kf_estimate(kf, mah.quat, omega_w_est)
    return state._replace(key=keys[:, 0], kf=kf, mahony=mah,
                          prev_v=plant.v_world), est
