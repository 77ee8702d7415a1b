"""The port's estimators (``hector_torch/estimation.py``) against the JAX
package on the same numpy-seeded inputs, in float64 on the CPU: the sensor
model, the IIR filter, Mahony, the contact-aided KF, the estimator carry's
init and tick for every kind (with and without a terrain map), re-entry
from the filter states, and tier-1 rollouts driven by 'kf' and 'filtered'.

The noise streams are JAX's key for key (tests/test_torch_prng.py); the
normals differ by ~1e-15 relative through erfinv, far below these bars.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import estimation as JE
from hector import math as jhm
from hector import runtime as JRT
from hector.plant import srb as JSRB
from hector.config import DEFAULT_CONFIG as JCFG

from hector_torch import convert
from hector_torch import estimation as TE
from hector_torch import prng
from hector_torch import runtime as TRT
from hector_torch.plant import srb as TSRB
from hector_torch.config import DEFAULT_CONFIG as TCFG

from .test_torch_slice import (JCFG_FS, _jax_batch, _to_port, _with_solver,
                               assert_tree_close, todict)

torch.set_num_threads(1)

F64 = torch.float64
# module math in float64: the same arithmetic in another order
TOL = 1e-10
# the rollout bars of tests/test_torch_robustness.py: the jitted IK's
# 2.5e-7 rad reaches the plant through the joint servo
ROLL_TOL, ROLL_OVER = 1e-6, {'qd': 1e-5}
N_PERIODS = 6
B = 6


def tt(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(k), torch.tensor(k.astype(np.int64))


def _plants(seed, n=B):
    """Perturbed tier-1 plant states, moving and tilted, with mixed contact
    flags: (JAX PlantState, port PlantState)."""
    rng = np.random.default_rng(seed)
    p1 = JSRB.init_plant_state(JCFG, dtype=jnp.float64)
    s = {k: np.broadcast_to(np.asarray(v), (n,) + v.shape).copy()
         for k, v in zip(p1._fields, p1)}
    s['position'] += rng.normal(0.0, 0.03, (n, 3))
    s['v_world'] += rng.normal(0.0, 0.4, (n, 3))
    s['omega_world'] += rng.normal(0.0, 0.5, (n, 3))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.08, (n, 4))
    s['quat'] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    s['q'] += rng.normal(0.0, 0.1, (n, 2, 5))
    s['qd'] += rng.normal(0.0, 1.0, (n, 2, 5))
    s['contact'] = rng.integers(0, 2, (n, 2)).astype(bool)
    j = JSRB.PlantState(*[jnp.asarray(s[k]) for k in JSRB.PlantState._fields])
    return j, convert.from_numpy(TSRB.PlantState, s, F64, 'cpu')


def test_noisy_sensors_matches_jax():
    jp, tp = _plants(1)
    jk, tk = _keys(1, B)
    noise = JE.SensorNoise(pos_std=0.01, vel_std=0.05, gyro_std=0.02,
                           quat_std=0.01)
    j = jax.vmap(lambda k, p: JE.noisy_sensors(k, p, noise))(jk, jp)
    t = TE.noisy_sensors(tk, tp, TE.SensorNoise(*noise))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0)
    # the noise is really there, and the quaternion stays unit
    assert float((t[0] - tp.position).abs().max()) > 1e-3
    np.testing.assert_allclose(t[2].norm(dim=-1).numpy(), 1.0, atol=1e-14)


def test_imu_accel_and_gyro_match_jax():
    jp, tp = _plants(2)
    jk, tk = _keys(2, B)
    rng = np.random.default_rng(3)
    prev_v = rng.normal(0.0, 0.4, (B, 3))
    bias = rng.normal(0.0, 0.005, (B, 3))
    j_f = jax.vmap(lambda k, p, v: JE.imu_accel(k, p, v, 0.001,
                                                 gravity=9.7))(
        jk, jp, jnp.asarray(prev_v))
    t_f = TE.imu_accel(tk, tp, tt(prev_v), 0.001, gravity=9.7)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=1e-9,
                               rtol=1e-13)
    j_g = jax.vmap(JE.gyro_body_meas)(jk, jp, jnp.asarray(bias))
    t_g = TE.gyro_body_meas(tk, tp, tt(bias))
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), atol=TOL, rtol=0)


def test_filtered_matches_jax():
    jp, tp = _plants(4)
    jk, tk = _keys(4, B)
    js, ts = jax.vmap(JE.init_filter_state)(jp), TE.init_filter_state(tp)
    for _ in range(3):
        jk, jsub = jax.vmap(jax.random.split, out_axes=1)(jk)
        tk, tsub = prng.split(tk).unbind(1)
        js, j_est = jax.vmap(lambda s, *m: JE.filtered(s, *m))(
            js, *jax.vmap(JE.noisy_sensors)(jsub, jp))
        ts, t_est = TE.filtered(ts, *TE.noisy_sensors(tsub, tp))
        assert_tree_close(todict(js), convert.to_numpy(ts), TOL)
        assert_tree_close(todict(j_est), convert.to_numpy(t_est), TOL)


def _mahony_inputs(seed, n=8):
    """Gyro rates, specific forces at |f| = g (full gate), 1.2 g (partial)
    and 2 g (gated off), attitudes tilted off level."""
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0.0, 0.5, (n, 3))
    f_dir = np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.2, (n, 3))
    f_dir /= np.linalg.norm(f_dir, axis=-1, keepdims=True)
    f_body = f_dir * (9.81 * np.array([1.0, 1.2, 2.0, 1.05] * (n // 4)))[:,
                                                                         None]
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.1, (n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    bias = rng.normal(0.0, 0.01, (n, 3))
    return gyro, f_body, quat, bias


def test_mahony_update_matches_jax():
    gyro, f_body, quat, bias = _mahony_inputs(5)
    jm = JE.MahonyState(quat=jnp.asarray(quat), bias=jnp.asarray(bias))
    tm = TE.MahonyState(quat=tt(quat), bias=tt(bias))
    for _ in range(20):
        jm = jax.vmap(lambda m, g, f: JE.mahony_update(m, g, f, 0.001))(
            jm, jnp.asarray(gyro), jnp.asarray(f_body))
        tm = TE.mahony_update(tm, tt(gyro), tt(f_body), 0.001)
    assert_tree_close(todict(jm), convert.to_numpy(tm), TOL)
    # the gate: at 2 g the bias estimate has not moved
    np.testing.assert_array_equal(tm.bias[2::4].numpy(), bias[2::4])
    assert float((tm.bias[0::4] - tt(bias[0::4])).abs().max()) > 1e-6


def _kf_inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal([0.0, 0.0, 0.5], 0.05, (n, 3)),
                        rng.normal(0.0, 0.3, (n, 3)),
                        rng.normal([0.0, 0.1, 0.0], 0.05, (n, 3)),
                        rng.normal([0.0, -0.1, 0.0], 0.05, (n, 3))], axis=-1)
    a = rng.normal(0.0, 0.02, (n, 12, 12))
    cov = 0.01 * np.eye(12) + np.einsum('bij,bkj->bik', a, a)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.05, (n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    r_body = np.swapaxes(np.asarray(jax.vmap(jhm.quat_to_rot)(
        jnp.asarray(quat))), -1, -2)
    args = dict(
        accel_world=rng.normal(0.0, 1.0, (n, 3)), r_body=r_body,
        rel_body=rng.normal([0.0, 0.0, -0.5], 0.1, (n, 2, 3)),
        rel_vel_body=rng.normal(0.0, 0.3, (n, 2, 3)),
        omega_body=rng.normal(0.0, 0.5, (n, 3)),
        contact=np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.0, 0.0],
                          [0.5, 1.0], [1.0, 0.25]])[:n])
    return x, cov, args


@pytest.mark.parametrize('ground', ['scalar', 'per_foot'])
def test_kf_update_matches_jax(ground):
    x, cov, args = _kf_inputs(6)
    gz = 0.07 if ground == 'scalar' else np.random.default_rng(7).uniform(
        0.0, 0.1, (B, 2))
    jk = JE.KFState(x=jnp.asarray(x), cov=jnp.asarray(cov))
    tk = TE.KFState(x=tt(x), cov=tt(cov))
    j_args = {k: jnp.asarray(v) for k, v in args.items()}
    t_args = {k: tt(v) for k, v in args.items()}
    for _ in range(5):
        if ground == 'scalar':
            jk = jax.vmap(lambda k, a: JE.kf_update(k, dt=0.001, ground_z=gz,
                                                    **a))(jk, j_args)
            tk = TE.kf_update(tk, dt=0.001, ground_z=gz, **t_args)
        else:
            jk = jax.vmap(lambda k, a, g: JE.kf_update(k, dt=0.001,
                                                       ground_z=g, **a))(
                jk, j_args, jnp.asarray(gz))
            tk = TE.kf_update(tk, dt=0.001, ground_z=tt(gz), **t_args)
    assert_tree_close(todict(jk), convert.to_numpy(tk), TOL)
    est_j = jax.vmap(JE.kf_estimate)(jk, jnp.asarray(_mahony_inputs(8)[2][:B]),
                                     j_args['omega_body'])
    est_t = TE.kf_estimate(tk, tt(_mahony_inputs(8)[2][:B]),
                           t_args['omega_body'])
    assert_tree_close(todict(est_j), convert.to_numpy(est_t), TOL)


def test_kf_init_and_measurement_matrix_match_jax():
    np.testing.assert_array_equal(TE._kf_h(), np.asarray(JE._kf_h()))
    x, _, _ = _kf_inputs(9)
    j = jax.vmap(JE.kf_init)(jnp.asarray(x[:, :3]), jnp.asarray(x[:, 3:6]),
                             jnp.asarray(x[:, 6:].reshape(B, 2, 3)))
    t = TE.kf_init(tt(x[:, :3]), tt(x[:, 3:6]), tt(x[:, 6:].reshape(B, 2, 3)))
    assert_tree_close(todict(j), convert.to_numpy(t), 0.0)


def test_est_init_matches_jax():
    jp, tp = _plants(10)
    jk, tk = _keys(10, B)
    noise = JE.SensorNoise(gyro_bias_std=0.02)
    j = jax.vmap(lambda p, k: JE.est_init(p, k, JCFG, noise))(jp, jk)
    t = TE.est_init(tp, tk, TCFG, TE.SensorNoise(*noise))
    assert_tree_close(todict(j), convert.to_numpy(t), TOL)
    assert float(t.gyro_bias.abs().max()) > 1e-3


@pytest.mark.parametrize('kind,terrain', [
    ('cheater', False), ('filtered', False), ('kf', False), ('kf', True)])
def test_est_update_matches_jax(kind, terrain):
    """Five chained ticks over changing plant states; with a terrain map
    the KF's foot-height rows read the stairs at its own foot-x estimates
    (the stairs' edges sit between the feet)."""
    jk, tk = _keys(11, B)
    jp, tp = _plants(11)
    js = jax.vmap(lambda p, k: JE.est_init(p, k, JCFG))(jp, jk)
    ts = TE.est_init(tp, tk, TCFG)
    th = (np.full(B, 0.03), np.full(B, 0.05))
    for tick in range(5):
        jp, tp = _plants(100 + tick)
        if terrain:
            j_t = tuple(jnp.asarray(v) for v in th)
            js, j_est = jax.vmap(lambda s, p, h, l: JE.est_update(
                kind, s, p, JCFG, ground_z=0.0682, terrain=(h, l)))(
                js, jp, *j_t)
            ts, t_est = TE.est_update(kind, ts, tp, TCFG, ground_z=0.0682,
                                      terrain=tuple(tt(v) for v in th))
        else:
            js, j_est = jax.vmap(lambda s, p: JE.est_update(
                kind, s, p, JCFG))(js, jp)
            ts, t_est = TE.est_update(kind, ts, tp, TCFG)
        assert_tree_close(todict(js), convert.to_numpy(ts), TOL)
        assert_tree_close(todict(j_est), convert.to_numpy(t_est), TOL)
    if kind != 'cheater':
        assert not np.array_equal(ts.key.numpy(), tk.numpy())


def test_unknown_estimator_kind_raises():
    with pytest.raises(ValueError, match='unknown estimator'):
        TE.est_update('bogus', None, None, None)
    with pytest.raises(ValueError, match='unknown estimator'):
        TRT.make_rollout(2, TCFG, estimator='bogus')


def test_kf_path_never_consumes_direct_pose_channels(monkeypatch):
    """Sensor honesty, structurally: the 'kf' kind never calls
    noisy_sensors (the direct quat/pos/vel proxies); 'filtered' does."""
    def boom(*a, **k):
        raise AssertionError('kf path consumed noisy_sensors')
    monkeypatch.setattr(TE, 'noisy_sensors', boom)
    plant = TSRB.init_plant_state(2, TCFG, dtype=F64, device='cpu')
    state = TE.est_init(plant, prng.PRNGKey(0, 'cpu').expand(2, 2), TCFG)
    _, est = TE.est_update('kf', state, plant, TCFG)
    assert torch.isfinite(est.position).all()
    with pytest.raises(AssertionError):
        TE.est_update('filtered', state, plant, TCFG)


def _lane_keys(n):
    j = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(7),
                                                jnp.arange(n))
    return j, prng.fold_in(prng.PRNGKey(7, 'cpu'), torch.arange(n))


def _estimator_batch(seed):
    """_jax_batch's lanes with per-lane keys (fold_in of PRNGKey(7)): the
    JAX carry built with those keys, and the port's."""
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed)
    jk, tk = _lane_keys(4)
    fresh = jax.vmap(lambda p, k: JRT.init_controller_carry(p, JCFG, key=k))(
        plant, jk)
    carry = carry._replace(est=fresh.est)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, F64)
    t_fresh = TRT.init_controller_carry(t_plant, TCFG, key=tk)
    assert_tree_close(todict(fresh), convert.to_numpy(t_fresh), TOL)
    return (carry, plant, cmd), (t_carry, t_plant, t_cmd)


@pytest.mark.parametrize('estimator,jcfg,tcfg', [
    ('kf', JCFG_FS, _with_solver(TCFG, backend='riccati_pallas')),
    ('kf', JCFG, TCFG),
    ('filtered', JCFG, TCFG)], ids=['kf_fixed_sigma', 'kf_default',
                                    'filtered_default'])
def test_rollout_with_estimator_matches_jax(estimator, jcfg, tcfg):
    """The tier-1 loop driven by a noisy estimator, period by period; lane
    3 is standing."""
    (carry, plant, cmd), (t_carry, t_plant, t_cmd) = _estimator_batch(31)
    j_roll = JRT.make_rollout(N_PERIODS, jcfg, batched=True,
                              estimator=estimator)
    carry, plant, j_diags = j_roll(carry, plant, cmd)
    t_roll = TRT.make_rollout(N_PERIODS, tcfg, estimator=estimator)
    t_carry, t_plant, t_diags = t_roll(t_carry, t_plant, t_cmd)
    t_diags = {k: v.numpy() for k, v in t_diags.items()}
    j_diags = todict(j_diags)
    assert set(t_diags) == set(j_diags)
    for k in range(N_PERIODS):
        assert_tree_close({n: v[:, k] for n, v in j_diags.items()},
                          {n: v[:, k] for n, v in t_diags.items()}, ROLL_TOL,
                          f'period {k}', ROLL_OVER)
    assert_tree_close(todict(plant), convert.to_numpy(t_plant), ROLL_TOL, '',
                      ROLL_OVER)
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), ROLL_TOL, '',
                      ROLL_OVER)
    assert not t_diags['fallen'].any()


@pytest.mark.parametrize('estimator', ['kf', 'filtered'])
def test_reentry_from_the_filter_state_matches_jax(estimator):
    """apply_mode_command under a noisy estimator re-enters walking from the
    filter's own state (reentry_estimate), after one estimator tick."""
    (carry, plant, cmd), (t_carry, t_plant, t_cmd) = _estimator_batch(32)
    carry = jax.jit(jax.vmap(lambda c, p, m: JRT.controller_tick(
        c, p, m, do_mpc=False, cfg=JCFG, estimator=estimator)[0]))(
        carry, plant, cmd)
    t_carry = TRT.controller_tick(t_carry, t_plant, t_cmd, False, TCFG,
                                  estimator=estimator)[0]
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), TOL)
    carry = carry._replace(mode=jnp.asarray([1, 0, 0, 1], jnp.int32))
    t_carry = t_carry._replace(mode=torch.tensor([1, 0, 0, 1],
                                                 dtype=torch.int32))
    mode_cmd = np.array([-1, 1, -1, 0], np.int32)
    j_est = jax.vmap(lambda c, p: JRT.reentry_estimate(estimator, c, p))(
        carry, plant)
    t_est = TRT.reentry_estimate(estimator, t_carry, t_plant)
    assert_tree_close(todict(j_est), convert.to_numpy(t_est), TOL)
    j_new = jax.vmap(lambda c, p, m: JRT.apply_mode_command(
        c, p, m, JCFG, estimator=estimator))(carry, plant,
                                             jnp.asarray(mode_cmd))
    t_new = TRT.apply_mode_command(t_carry, t_plant, torch.tensor(mode_cmd),
                                   TCFG, estimator=estimator)
    assert_tree_close(todict(j_new), convert.to_numpy(t_new), TOL)
    # lane 1 re-entered from the filter's position, not from the plant's
    filt = (t_carry.est.kf.x[1, 0:3] if estimator == 'kf'
            else t_carry.est.filt.pos[1])
    np.testing.assert_allclose(
        t_new.planner.world_position_desired[1].numpy(), filt.numpy(),
        atol=TOL)
    assert float((filt - t_plant.position[1]).abs().max()) > 1e-5


def test_rollout_threads_custom_noise_model():
    """The noise model given to make_rollout reaches every tick and the
    carry (rollout.init): with zero noise and zero bias a 0.2 s stand keeps
    the Mahony yaw at machine zero (tests/test_estimation.py stands 0.5 s;
    the default model drifts ~1e-3 rad in 0.2 s on the bias alone)."""
    noise = TE.SensorNoise(pos_std=0.0, vel_std=0.0, gyro_std=0.0,
                           quat_std=0.0, accel_std=0.0, gyro_bias_std=0.0)
    plant = TSRB.init_plant_state(2, TCFG, dtype=F64, device='cpu')
    roll = TRT.make_rollout(40, TCFG, estimator='kf', noise=noise)
    carry = roll.init(plant, key=prng.PRNGKey(2, 'cpu'))
    c, p, d = roll(carry, plant, TRT.standing_command(2, F64, 'cpu'))
    assert not d['fallen'].any()
    from hector_torch import math as hm
    yaw_err = hm.quat_to_rpy(c.est.mahony.quat)[:, 2] - hm.quat_to_rpy(
        p.quat)[:, 2]
    assert float(yaw_err.abs().max()) < 1e-4
    assert float(c.est.gyro_bias.abs().max()) == 0.0


def test_convert_carries_the_noise_models():
    noise = JE.SensorNoise(pos_std=0.1, gyro_bias_std=0.0)
    t = convert.from_numpy(TE.SensorNoise, noise._asdict(), device='cpu')
    assert t == TE.SensorNoise(*noise)
    assert convert.from_numpy(TE.KFNoise, JE.KFNoise()._asdict(),
                              device='cpu') == TE.KFNoise()
