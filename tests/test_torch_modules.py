"""The PyTorch port's modules against the JAX package, in float64.

The same inputs, made from a numpy seed, go through the JAX function (on
the CPU, vmapped where it is written per scenario) and its counterpart in
hector_torch (device='cpu').  Tolerance 1e-10: both sides evaluate the same
closed-form float64 arithmetic, so only summation order and libm rounding
differ (observed differences are ~1e-15 relative).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import config as jcfg
from hector import math as jmath
from hector import kinematics as jkin
from hector import gait as jgait
from hector import constraints as jcon
from hector import control as jctl
from hector import swing as jswing
from hector.qp import builder as jbuild
from hector.plant import srb as jsrb

import hector_torch
from hector_torch import config as tcfg
from hector_torch import math as tmath
from hector_torch import kinematics as tkin
from hector_torch import gait as tgait
from hector_torch import constraints as tcon
from hector_torch import control as tctl
from hector_torch import swing as tswing
from hector_torch.qp import builder as tbuild
from hector_torch.plant import srb as tsrb

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

TOL = 1e-10
F64 = torch.float64
JCFG = jcfg.DEFAULT_CONFIG
TCFG = tcfg.DEFAULT_CONFIG
GOLD = np.load(__file__.rsplit('/', 1)[0] + '/golden/kinematics.npz')


def tt(x, dtype=F64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=0)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# --------------------------------------------------------------------- config

@pytest.mark.parametrize('name', ['robot', 'mpc', 'swing', 'plant', 'solver',
                                  'fk', 'jac', 'ik'])
def test_config_matches_jax(name):
    assert dataclasses.asdict(getattr(TCFG, name)) == \
        dataclasses.asdict(getattr(JCFG, name))


def test_config_constants_match_jax():
    assert tcfg.JOINT_OFFSETS == jcfg.JOINT_OFFSETS
    assert tcfg.PI == jcfg.PI
    assert TCFG.mpc.dt_mpc == JCFG.mpc.dt_mpc
    for name in ('WALKING_GAIT', 'STANDING_GAIT'):
        assert dataclasses.asdict(getattr(tcfg, name)) == \
            dataclasses.asdict(getattr(jcfg, name))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrb.init_plant_state(2, TCFG)


# ----------------------------------------------------------------------- math

def _math_inputs(rng):
    q = unit_quats(rng, 16)
    rpy = rng.uniform(-1.0, 1.0, (16, 3))
    m = rng.normal(size=(16, 3, 3)) + 3.0 * np.eye(3)
    v = rng.normal(size=(16, 3))
    x = rng.uniform(0.0, 1.0, (16, 1))
    return q, rpy, m, v, x


MATH_CASES = {
    'quat_to_rot': lambda mod, q, rpy, m, v, x, c: mod.quat_to_rot(c(q)),
    'quat_to_rpy': lambda mod, q, rpy, m, v, x, c: mod.quat_to_rpy(c(q)),
    'euler_rate_matrix': lambda mod, q, rpy, m, v, x, c:
        mod.euler_rate_matrix(c(rpy)),
    'skew': lambda mod, q, rpy, m, v, x, c: mod.skew(c(v)),
    'inv3': lambda mod, q, rpy, m, v, x, c: mod.inv3(c(m)),
    'cubic_bezier': lambda mod, q, rpy, m, v, x, c:
        mod.cubic_bezier(c(v), c(rpy), c(x)),
    'quat_integrate': lambda mod, q, rpy, m, v, x, c:
        mod.quat_integrate(c(q), c(v), 0.001),
}


@pytest.mark.parametrize('name', sorted(MATH_CASES))
def test_math_matches_jax(name):
    args = _math_inputs(np.random.default_rng(1))
    fn = MATH_CASES[name]
    close(fn(jmath, *args, jnp.asarray), fn(tmath, *args, tt))


def test_cross_matches_numpy():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(8, 2, 3)), rng.normal(size=(8, 2, 3))
    close(np.cross(a, b), tmath.cross(tt(a), tt(b)))


# ----------------------------------------------------------------- kinematics

def _joint_angles(seed, n=12):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, (n, 2, 5))


def test_foot_position_matches_jax_and_golden():
    q = _joint_angles(3)
    close(jkin.foot_position(jnp.asarray(q)), tkin.foot_position(tt(q)))
    close(GOLD['p'], tkin.foot_position(tt(GOLD['q_raw'])), 2e-5)


def test_leg_jacobians_match_jax_and_golden():
    """The closed-form Jacobian against jax.jacfwd of the same chain."""
    q = _joint_angles(4)
    jm_j, jf_j = jkin.leg_jacobians(jnp.asarray(q))
    jm_t, jf_t = tkin.leg_jacobians(tt(q))
    close(jm_j, jm_t)
    close(jf_j, jf_t)
    jm_g, jf_g = tkin.leg_jacobians(tt(GOLD['q_raw']))
    close(GOLD['J_fm'], jm_g, 2e-5)
    close(GOLD['J_f'], jf_g, 2e-5)


def test_foot_rotation_matches_jax_and_golden():
    q = _joint_angles(5)
    close(jkin.foot_rotation(jnp.asarray(q)), tkin.foot_rotation(tt(q)))
    close(GOLD['R_foot'], tkin.foot_rotation(tt(GOLD['q_eff2'])), 1e-12)


def test_leg_ik_matches_jax_and_golden():
    rng = np.random.default_rng(6)
    target = np.stack([rng.uniform(-0.1, 0.1, (12, 2)),
                       rng.uniform(-0.08, 0.08, (12, 2)),
                       rng.uniform(-0.7, -0.45, (12, 2))], axis=-1)
    qd = _joint_angles(7)
    close(jkin.leg_ik(jnp.asarray(target), jnp.asarray(qd)),
          tkin.leg_ik(tt(target), tt(qd)))
    close(GOLD['ik_qdes'], tkin.leg_ik(tt(GOLD['ik_target']),
                                       tt(GOLD['ik_qdata'])), 2e-5)


def test_apply_joint_offsets_matches_jax():
    q = _joint_angles(8)
    close(jkin.apply_joint_offsets(jnp.asarray(q)),
          tkin.apply_joint_offsets(tt(q)))


# ----------------------------------------------------------------------- gait

GAITS = {'walking': ([0.0, 5.0], [5.0, 5.0]),
         'standing': ([0.0, 0.0], [10.0, 10.0])}


def test_phase_state_matches_jax():
    ticks = np.arange(0, 1205, dtype=np.int32)
    it_j, ph_j = jgait.phase_state(jnp.asarray(ticks), 40, 10)
    it_t, ph_t = tgait.phase_state(torch.tensor(ticks), 40, 10)
    assert ph_t.dtype == torch.float32        # float32 even in f64 runs
    np.testing.assert_array_equal(np.asarray(it_j), it_t.numpy())
    np.testing.assert_array_equal(np.asarray(ph_j), ph_t.numpy())


@pytest.mark.parametrize('gait', sorted(GAITS))
def test_gait_subphases_and_table_match_jax(gait):
    off, dur = GAITS[gait]
    ticks = np.arange(0, 800, 7, dtype=np.int32)
    n = len(ticks)
    off_b, dur_b = np.tile(off, (n, 1)), np.tile(dur, (n, 1))
    it_j, ph_j = jgait.phase_state(jnp.asarray(ticks), 40, 10)
    it_t, ph_t = tgait.phase_state(torch.tensor(ticks), 40, 10)
    ph_j64, ph_t64 = jnp.asarray(ph_j, jnp.float64), ph_t.to(F64)
    close(jgait.contact_subphase(ph_j64, jnp.asarray(off_b),
                                 jnp.asarray(dur_b), 10),
          tgait.contact_subphase(ph_t64, tt(off_b), tt(dur_b), 10))
    close(jgait.swing_subphase(ph_j64, jnp.asarray(off_b),
                               jnp.asarray(dur_b), 10),
          tgait.swing_subphase(ph_t64, tt(off_b), tt(dur_b), 10))
    table_j = jax.vmap(lambda i, o, d: jgait.mpc_gait_table(i, o, d, 10))(
        it_j, jnp.asarray(off_b), jnp.asarray(dur_b))
    close(table_j, tgait.mpc_gait_table(it_t, tt(off_b), tt(dur_b), 10))


# ---------------------------------------------------------------- constraints

def _rotations(seed, n=6):
    rng = np.random.default_rng(seed)
    r_body = np.asarray(jmath.quat_to_rot(jnp.asarray(unit_quats(rng, n))))
    r_foot = np.asarray(jkin.foot_rotation(
        jnp.asarray(rng.uniform(-0.5, 0.5, (n, 2, 5)))))
    return r_body, r_foot


def _gait_tables(seed, n=6):
    return np.random.default_rng(seed).integers(0, 2, (n, 10, 2)).astype(
        np.float64)


def test_constraint_block_matches_jax():
    r_body, r_foot = _rotations(9)
    close(jcon.constraint_block(jnp.asarray(r_body), jnp.asarray(r_foot),
                                JCFG.mpc),
          tcon.constraint_block(tt(r_body), tt(r_foot), TCFG.mpc))


def test_constraint_bounds_and_mask_match_jax():
    gt = _gait_tables(10)
    lb_j, ub_j = jcon.constraint_bounds(jnp.asarray(gt), JCFG.mpc)
    lb_t, ub_t = tcon.constraint_bounds(tt(gt), TCFG.mpc)
    close(lb_j, lb_t)
    close(ub_j, ub_t)
    close(jcon.input_mask(jnp.asarray(gt)), tcon.input_mask(tt(gt)))


def test_heel_row_sign_quirk_kept():
    """Leg 1's heel row reuses +M_vec (SolverMPC.cpp:545-546)."""
    r_body, r_foot = _rotations(11, 1)
    f = tcon.constraint_block(tt(r_body), tt(r_foot), TCFG.mpc)[0].numpy()
    np.testing.assert_array_equal(f[14, 9:12], f[13, 9:12])
    np.testing.assert_array_equal(f[6, 6:9], -f[5, 6:9])


# -------------------------------------------------------------------- builder

def test_build_stage_parts_matches_jax():
    rng = np.random.default_rng(12)
    n = 6
    x0 = np.concatenate([rng.uniform(-0.2, 0.2, (n, 3)),
                         rng.normal(size=(n, 3)), rng.normal(size=(n, 6)),
                         np.full((n, 1), 9.81)], axis=-1)
    traj = rng.normal(size=(n, 10, 12))
    r_body, r_foot = _rotations(13, n)
    r_feet = rng.normal(0.0, 0.2, (n, 2, 3))
    i_body = np.diag([0.5413, 0.5200, 0.0691])
    gt = _gait_tables(14, n)
    parts_j = jax.vmap(lambda *a: jbuild.build_stage_parts(
        *a[:5], jnp.asarray(i_body), a[5], JCFG.mpc))(
        *[jnp.asarray(v) for v in (x0, traj, r_body, r_foot, r_feet, gt)])
    parts_t = tbuild.build_stage_parts(tt(x0), tt(traj), tt(r_body),
                                       tt(r_foot), tt(r_feet), tt(i_body),
                                       tt(gt), TCFG.mpc)
    assert parts_t._fields == parts_j._fields
    for a, b in zip(parts_j, parts_t):
        close(a, b)


# ---------------------------------------------------------- control and swing

def _estimates(seed, n=6):
    rng = np.random.default_rng(seed)
    arrs = dict(position=rng.normal(0.0, 0.3, (n, 3)) + [0, 0, 0.5],
                v_world=rng.normal(0.0, 0.5, (n, 3)),
                quat=unit_quats(rng, n) * [4, 1, 1, 1],
                omega_world=rng.normal(0.0, 0.5, (n, 3)))
    arrs['quat'] /= np.linalg.norm(arrs['quat'], axis=-1, keepdims=True)
    est_j = jax.vmap(jctl.estimate_state)(
        *[jnp.asarray(arrs[k]) for k in
          ('position', 'v_world', 'quat', 'omega_world')])
    est_t = tctl.estimate_state(*[tt(arrs[k]) for k in
                                  ('position', 'v_world', 'quat',
                                   'omega_world')])
    return est_j, est_t


def test_estimate_state_matches_jax():
    est_j, est_t = _estimates(15)
    assert est_t._fields == est_j._fields
    for a, b in zip(est_j, est_t):
        close(a, b)


def test_command_safety_mode_match_jax():
    rng = np.random.default_rng(16)
    est_j, est_t = _estimates(17)
    yaw_des = rng.uniform(-3.2, 3.2, 6)
    yaw_rate = rng.uniform(-1.0, 1.0, 6)
    cj = jax.vmap(lambda y, e, r: jctl.command_update(
        jctl.CommandState(y), e, r, 0.001))(
        jnp.asarray(yaw_des), est_j, jnp.asarray(yaw_rate))
    ct = tctl.command_update(tctl.CommandState(tt(yaw_des)), est_t,
                             tt(yaw_rate), 0.001)
    close(cj.yaw_des, ct.yaw_des)
    mode = np.array([0, 1, 1, 1, 0, 1], np.int32)
    mj = jax.vmap(jctl.apply_safety)(jnp.asarray(mode), est_j)
    mt = tctl.apply_safety(torch.tensor(mode), est_t)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    arrs = [rng.normal(size=(6, 2, 5)) for _ in range(5)]
    cmd_j = jctl.MotorCommand(*[jnp.asarray(a) for a in arrs])
    cmd_t = tctl.MotorCommand(*[tt(a) for a in arrs])
    out_j = jax.vmap(jctl.apply_mode)(cmd_j, mj)
    out_t = tctl.apply_mode(cmd_t, mt)
    for a, b in zip(out_j, out_t):
        close(a, b)


def test_leg_torque_command_matches_jax():
    rng = np.random.default_rng(18)
    q = _joint_angles(19, 6)
    jm_j, _ = jkin.leg_jacobians(jnp.asarray(q))
    f_ff = rng.normal(0.0, 50.0, (6, 2, 6))
    stance = rng.integers(0, 2, (6, 2)).astype(np.float64)
    gains = [rng.normal(size=(6, 2, 5)) for _ in range(3)]
    out_j = jax.vmap(jctl.leg_torque_command)(
        jm_j, jnp.asarray(f_ff), jnp.asarray(stance),
        *[jnp.asarray(g) for g in gains])
    out_t = tctl.leg_torque_command(tkin.leg_jacobians(tt(q))[0], tt(f_ff),
                                    tt(stance), *[tt(g) for g in gains])
    for a, b in zip(out_j, out_t):
        close(a, b)


def test_swing_update_and_setpoints_match_jax():
    rng = np.random.default_rng(20)
    n = 8
    est_j, est_t = _estimates(21, n)
    p_leg = np.asarray(jkin.foot_position(jnp.asarray(_joint_angles(22, n))))
    state = dict(first_swing=rng.integers(0, 2, (n, 2)).astype(bool),
                 swing_times=rng.uniform(-0.01, 0.2, (n, 2)),
                 p0=rng.normal(0.0, 0.2, (n, 2, 3)),
                 pf=rng.normal(0.0, 0.2, (n, 2, 3)))
    v_des = rng.uniform(-0.5, 0.5, (n, 3))
    phase = rng.uniform(0.0, 1.0, (n, 2)) * rng.integers(0, 2, (n, 2))
    stance_seg = rng.choice([5.0, 10.0], n)
    st_j = jswing.SwingState(*[jnp.asarray(state[k]) for k in
                               jswing.SwingState._fields])
    st_t = tswing.SwingState(*[torch.tensor(state[k]) if k == 'first_swing'
                               else tt(state[k])
                               for k in tswing.SwingState._fields])
    out_j = jax.vmap(lambda s, e, p, v, ph, g: jswing.swing_update(
        s, e, p, v, ph, g, jnp.asarray(10.0), JCFG))(
        st_j, est_j, jnp.asarray(p_leg), jnp.asarray(v_des),
        jnp.asarray(phase), jnp.asarray(stance_seg))
    out_t = tswing.swing_update(st_t, est_t, tt(p_leg), tt(v_des), tt(phase),
                                tt(stance_seg), 10.0, TCFG)
    for a, b in zip(out_j[0], out_t[0]):
        close(a, b)
    close(out_j[1], out_t[1])
    np.testing.assert_array_equal(np.asarray(out_j[2]), out_t[2].numpy())
    q_data = _joint_angles(23, n)
    sp_j = jax.vmap(lambda p, q, s: jswing.swing_joint_setpoints(p, q, s,
                                                                 JCFG))(
        out_j[1], jnp.asarray(q_data), out_j[2])
    sp_t = tswing.swing_joint_setpoints(out_t[1], tt(q_data), out_t[2], TCFG)
    for a, b in zip(sp_j, sp_t):
        close(a, b)


# ---------------------------------------------------------------------- plant

@pytest.mark.parametrize('terrain', [False, True], ids=['flat', 'stairs'])
def test_srb_step_matches_jax(terrain):
    rng = np.random.default_rng(24)
    n = 6
    p1 = jsrb.init_plant_state(JCFG, dtype=jnp.float64)
    state = {k: np.broadcast_to(np.asarray(v), (n,) + v.shape).copy()
             for k, v in zip(p1._fields, p1)}
    state['position'] += rng.normal(0.0, 0.02, (n, 3))
    state['v_world'] += rng.normal(0.0, 0.3, (n, 3))
    state['omega_world'] += rng.normal(0.0, 0.3, (n, 3))
    state['q'] += rng.normal(0.0, 0.05, (n, 2, 5))
    state['qd'] += rng.normal(0.0, 0.5, (n, 2, 5))
    state['contact'] = rng.integers(0, 2, (n, 2)).astype(bool)
    cmd = [rng.normal(0.0, 2.0, (n, 2, 5)), rng.normal(0.0, 0.1, (n, 2, 5)),
           np.zeros((n, 2, 5)), rng.uniform(0.0, 30.0, (n, 2, 5)),
           rng.uniform(0.0, 5.0, (n, 2, 5))]
    wrench = np.concatenate([rng.normal(0.0, 20.0, (n, 2, 2)),
                             rng.uniform(0.0, 120.0, (n, 2, 1)),
                             rng.normal(0.0, 1.0, (n, 2, 3))], axis=-1)
    sched = rng.integers(0, 2, (n, 2)).astype(np.float64)
    heights = (rng.uniform(0.0, 0.05, n), rng.uniform(0.2, 0.5, n))
    ps_j = jsrb.PlantState(*[jnp.asarray(state[k]) for k in
                             jsrb.PlantState._fields])
    ps_t = tsrb.PlantState(*[torch.tensor(state[k]) if k == 'contact'
                             else tt(state[k])
                             for k in tsrb.PlantState._fields])
    if terrain:
        out_j = jax.vmap(lambda s, c, w, k, h, l: jsrb.step(
            s, c, w, k, terrain=(h, l), cfg=JCFG))(
            ps_j, jctl.MotorCommand(*[jnp.asarray(c) for c in cmd]),
            jnp.asarray(wrench), jnp.asarray(sched),
            jnp.asarray(heights[0]), jnp.asarray(heights[1]))
        terr_t = (tt(heights[0]), tt(heights[1]))
    else:
        out_j = jax.vmap(lambda s, c, w, k: jsrb.step(s, c, w, k, cfg=JCFG))(
            ps_j, jctl.MotorCommand(*[jnp.asarray(c) for c in cmd]),
            jnp.asarray(wrench), jnp.asarray(sched))
        terr_t = None
    out_t = tsrb.step(ps_t, tctl.MotorCommand(*[tt(c) for c in cmd]),
                      tt(wrench), tt(sched), terrain=terr_t, cfg=TCFG)
    for name, a, b in zip(tsrb.PlantState._fields, out_j, out_t):
        if name == 'contact':
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            close(a, b)


def test_init_plant_state_matches_jax():
    p_j = jsrb.init_plant_state(JCFG, dtype=jnp.float64)
    p_t = tsrb.init_plant_state(3, TCFG, dtype=F64, device='cpu')
    for a, b in zip(p_j, p_t):
        for lane in range(3):
            close(a, b[lane])


def test_servo_torque_and_terrain_height_match_jax():
    rng = np.random.default_rng(25)
    arrs = [rng.normal(0.0, 3.0, (4, 2, 5)) for _ in range(5)]
    q, qd = rng.normal(size=(4, 2, 5)), rng.normal(size=(4, 2, 5))
    close(jsrb.servo_torque(jctl.MotorCommand(*[jnp.asarray(a) for a in arrs]),
                            jnp.asarray(q), jnp.asarray(qd), JCFG),
          tsrb.servo_torque(tctl.MotorCommand(*[tt(a) for a in arrs]),
                            tt(q), tt(qd), TCFG))
    x = rng.uniform(-2.0, 2.0, 20)
    close(jsrb.terrain_height(jnp.asarray(x), 0.04, 0.3),
          tsrb.terrain_height(tt(x), 0.04, tt(0.3)))


def test_port_imports_no_jax_in_its_sources():
    """No source file of the port names jax or the hector package."""
    import pathlib
    root = pathlib.Path(hector_torch.__file__).parent
    for path in root.rglob('*.py'):
        text = path.read_text()
        for bad in ('import jax', 'from jax', 'from hector ', 'import hector\n',
                    'from hector.', 'import hector.'):
            assert bad not in text, f'{path}: {bad!r}'
