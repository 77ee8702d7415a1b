"""The port's tier-2 plant (``hector_torch/plant/{model,rnea,whole_body}.py``)
and its rollout (``runtime.make_rollout_whole_body``) against the JAX
package, in float64 on the CPU: the model's constants, the dynamics terms
(mass matrix, bias forces, contact points and Jacobian), the contact forces
and one plant tick at 1e-10; the dynamics core's physical properties
(tests/test_whole_body.py:27-52) on the port; and short rollouts under
'cheater' and 'kf' with a push, a gait switch and a passive/walking
re-entry, period by period.

The rollouts are held to the JAX outputs, not to the tier-2 assertions that
fail on the reference itself (ROADMAP C.4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import math as jhm
from hector import runtime as JRT
from hector.control import MotorCommand as JMotor
from hector.plant import model as JMDL
from hector.plant import rnea as JR
from hector.plant import whole_body as JWB
from hector.config import DEFAULT_CONFIG as JCFG

from hector_torch import convert
from hector_torch import math as thm
from hector_torch import prng
from hector_torch import runtime as TRT
from hector_torch.control import MotorCommand as TMotor
from hector_torch.plant import model as TMDL
from hector_torch.plant import rnea as TR
from hector_torch.plant import whole_body as TWB
from hector_torch.config import DEFAULT_CONFIG as TCFG

from .test_torch_slice import assert_tree_close, todict

torch.set_num_threads(1)

F64 = torch.float64
# module math in float64: the same arithmetic in another order (measured
# ~1e-14 on these inputs)
TOL = 1e-10
B = 5


def tt(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=0)


def test_model_matches_jax():
    j, t = JMDL.stacked_leg_models(), TMDL.stacked_leg_models()
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    assert TMDL.total_mass() == JMDL.total_mass()
    assert TMDL.TRUNK_MASS == JMDL.TRUNK_MASS
    np.testing.assert_array_equal(TMDL.TRUNK_INERTIA, JMDL.TRUNK_INERTIA)
    np.testing.assert_array_equal(TMDL.CONTACT_POINTS_TOE,
                                  JMDL.CONTACT_POINTS_TOE)
    assert TMDL.TOE_BOX_Y_CENTER == JMDL.TOE_BOX_Y_CENTER
    np.testing.assert_array_equal(TR.TRUNK_CORNERS, JR.TRUNK_CORNERS)
    assert (TR.N_BODY_POINTS, TWB.N_TOE, TWB.N_CONTACT,
            TWB.FK_FOOT_CLEARANCE) == (JR.N_BODY_POINTS, JWB.N_TOE,
                                       JWB.N_CONTACT, JWB.FK_FOOT_CLEARANCE)
    assert TWB.ContactConfig() == JWB.ContactConfig()
    assert TWB.ContactConfig._fields == JWB.ContactConfig._fields
    assert TWB.WholeBodyState._fields == JWB.WholeBodyState._fields


def _poses(seed, n=B):
    """Trunk poses, joint angles and generalized velocities/accelerations
    from a numpy seed: (numpy dict, JAX rotation, port rotation)."""
    rng = np.random.default_rng(seed)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.1, (n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    x = dict(pos=rng.normal([0.0, 0.0, 0.5], 0.05, (n, 3)),
             q=rng.uniform(-0.5, 0.5, (n, 2, 5)),
             nu=rng.normal(0.0, 1.0, (n, 16)),
             nu_dot=rng.normal(0.0, 1.0, (n, 16)))
    return (x, jax.vmap(jhm.quat_to_rot)(jnp.asarray(quat)),
            thm.quat_to_rot(tt(quat)))


def test_fk_chain_and_kinematics_match_jax():
    x, j_rot, t_rot = _poses(1)
    j = jax.vmap(JR.fk_chain)(jnp.asarray(x['pos']), j_rot,
                              jnp.asarray(x['q']))
    t = TR.fk_chain(tt(x['pos']), t_rot, tt(x['q']))
    for a, b in zip(j, t):
        close(a, b)
    j = jax.vmap(lambda p, r, q, n, nd: JR._kinematics(
        p, r, q, n, nd, jnp.float64))(*[jnp.asarray(x[k]) if k != 'rot'
                                        else j_rot for k in
                                        ('pos', 'rot', 'q', 'nu', 'nu_dot')])
    t = TR._kinematics(tt(x['pos']), t_rot, tt(x['q']), tt(x['nu'])[:, None],
                       tt(x['nu_dot'])[:, None])
    for k, (a, b) in enumerate(zip(j, t)):
        # the motion quantities (omega, omega_dot, a_com) carry K = 1
        close(a, b[:, 0] if k in (3, 4, 5) else b)


@pytest.mark.parametrize('gravity', [9.81, 0.0, 3.7])
def test_rnea_matches_jax(gravity):
    x, j_rot, t_rot = _poses(2)
    j = jax.vmap(lambda p, r, q, n, nd: JR.rnea(p, r, q, n, nd, gravity))(
        jnp.asarray(x['pos']), j_rot, jnp.asarray(x['q']),
        jnp.asarray(x['nu']), jnp.asarray(x['nu_dot']))
    t = TR.rnea(tt(x['pos']), t_rot, tt(x['q']), tt(x['nu']),
                tt(x['nu_dot']), gravity)
    close(j, t)


def test_mass_matrix_and_bias_forces_match_jax():
    x, j_rot, t_rot = _poses(3)
    args_j = (jnp.asarray(x['pos']), j_rot, jnp.asarray(x['q']))
    args_t = (tt(x['pos']), t_rot, tt(x['q']))
    close(jax.vmap(JR.mass_matrix)(*args_j), TR.mass_matrix(*args_t))
    close(jax.vmap(lambda p, r, q, n: JR.bias_forces(p, r, q, n, 9.81))(
        *args_j, jnp.asarray(x['nu'])),
        TR.bias_forces(*args_t, tt(x['nu']), 9.81))


@pytest.mark.parametrize('include_body,custom', [
    (False, False), (True, False), (True, True)])
def test_contact_points_and_jac_match_jax(include_body, custom):
    x, j_rot, t_rot = _poses(4)
    cps = JMDL.CONTACT_POINTS_TOE * np.array([1.0, 1.5, 1.0]) + \
        np.array([0.0, 0.0194, 0.0]) if custom else None
    j = jax.vmap(lambda p, r, q, n: JR.contact_points_and_jac(
        p, r, q, n, cps=None if cps is None else jnp.asarray(cps),
        include_body=include_body))(
        jnp.asarray(x['pos']), j_rot, jnp.asarray(x['q']),
        jnp.asarray(x['nu']))
    t = TR.contact_points_and_jac(
        tt(x['pos']), t_rot, tt(x['q']), tt(x['nu']),
        cps=None if cps is None else tt(cps), include_body=include_body)
    n_pts = 8 + (TR.N_BODY_POINTS if include_body else 0)
    assert t[2].shape == (B, n_pts, 3, 16)
    for a, b in zip(j, t):
        close(a, b)


def test_dynamics_is_the_three_passes_in_one():
    """rnea.dynamics (what the plant's step calls) computes exactly what
    mass_matrix, bias_forces and contact_points_and_jac compute."""
    x, _, t_rot = _poses(5)
    args = (tt(x['pos']), t_rot, tt(x['q']))
    got = TR.dynamics(*args, tt(x['nu']), 9.81, include_body=True)
    want = (TR.mass_matrix(*args), TR.bias_forces(*args, tt(x['nu']), 9.81),
            *TR.contact_points_and_jac(*args, tt(x['nu']),
                                       include_body=True))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the physical properties of tests/test_whole_body.py:27-52, on the port

def test_mass_matrix_properties():
    q = tt(np.random.default_rng(0).uniform(-0.3, 0.3, (1, 2, 5)))
    m = TR.mass_matrix(tt([[0.0, 0.0, 0.55]]), torch.eye(3, dtype=F64)[None],
                       q)[0].numpy()
    assert np.abs(m - m.T).max() < 1e-10
    np.testing.assert_allclose(np.diag(m)[:3], TMDL.total_mass(), rtol=1e-9)
    assert np.linalg.eigvalsh(m).min() > 0


def test_gravity_bias_equals_weight():
    q = tt(np.random.default_rng(1).uniform(-0.3, 0.3, (1, 2, 5)))
    bias = TR.bias_forces(tt([[0.0, 0.0, 0.55]]),
                          torch.eye(3, dtype=F64)[None], q,
                          torch.zeros((1, 16), dtype=F64), 9.81)[0].numpy()
    np.testing.assert_allclose(bias[2], TMDL.total_mass() * 9.81, rtol=1e-9)
    np.testing.assert_allclose(bias[:2], 0.0, atol=1e-12)


def _motor(kp=None, kd=None, n=1):
    z = torch.zeros((n, 2, 5), dtype=F64)
    return TMotor(tau=z, q_des=z, qd_des=z,
                  kp=z if kp is None else tt(kp).expand(n, 2, 5),
                  kd=z if kd is None else tt(kd).expand(n, 2, 5))


def test_free_fall():
    s = TWB.init_whole_body_state(5.0, 1, F64, 'cpu')
    for _ in range(100):
        s = TWB.step(s, _motor(), TCFG)
    np.testing.assert_allclose(float(s.v_world[0, 2]), -0.981, atol=2e-3)


def test_passive_pd_standing():
    s = TWB.init_whole_body_state(0.545, 1, F64, 'cpu')
    cmd = _motor(kp=[[100.0, 100, 300, 300, 100]] * 2, kd=np.full((2, 5), 5.0))
    for _ in range(500):
        s = TWB.step(s, cmd, TCFG)
    assert 0.5 < float(s.position[0, 2]) < 0.6
    assert abs(float(s.position[0, 0])) < 0.1


def _state(seed, n=B):
    """Tier-2 states near the ground, moving, some toe corners sticking at
    anchors: (numpy dict, JAX state, port state)."""
    rng = np.random.default_rng(seed)
    s1 = JWB.init_whole_body_state(0.545, jnp.float64)
    s = {k: np.broadcast_to(np.asarray(v), (n,) + v.shape).copy()
         for k, v in zip(s1._fields, s1)}
    s['position'][:, 2] = rng.uniform(0.50, 0.52, n)
    s['position'][:, :2] = rng.normal(0.0, 0.1, (n, 2))
    s['v_world'] += rng.normal(0.0, 0.2, (n, 3))
    s['omega_world'] += rng.normal(0.0, 0.3, (n, 3))
    s['q'] += rng.normal(0.0, 0.1, (n, 2, 5))
    s['qd'] += rng.normal(0.0, 0.5, (n, 2, 5))
    s['sticking'][:, :4] = True
    s['anchor'] = rng.normal(0.0, 0.1, (n, JWB.N_CONTACT, 2))
    j = JWB.WholeBodyState(*[jnp.asarray(s[k])
                             for k in JWB.WholeBodyState._fields])
    return s, j, convert.from_numpy(TWB.WholeBodyState, s, F64, 'cpu')


def test_contact_forces_match_jax():
    x, j_rot, t_rot = _poses(6)
    s, _, _ = _state(6)
    rng = np.random.default_rng(7)
    j_pts, j_vel, _ = jax.vmap(lambda p, r, q, n: JR.contact_points_and_jac(
        p, r, q, n, include_body=True))(
        jnp.asarray(s['position']), j_rot, jnp.asarray(s['q']),
        jnp.asarray(rng.normal(0.0, 0.5, (B, 16))))
    # some points 2 cm in the ground (beyond pen_cap), some sliding fast
    j_pts = j_pts.at[:, :, 2].set(j_pts[:, :, 2] - 0.45)
    ccfg = JWB.ContactConfig(mu=0.6)
    for terrain in (None, (np.full(B, 0.03), np.full(B, 0.05))):
        j_t = None if terrain is None else tuple(jnp.asarray(v)
                                                 for v in terrain)
        j = jax.vmap(lambda p, v, a, st, *t: JWB.contact_forces(
            p, v, a, st, t if t else None, ccfg))(
            j_pts, j_vel, jnp.asarray(s['anchor']),
            jnp.asarray(s['sticking']), *(j_t or ()))
        t = TWB.contact_forces(
            tt(j_pts), tt(j_vel), tt(s['anchor']), torch.tensor(s['sticking']),
            None if terrain is None else tuple(tt(v) for v in terrain),
            TWB.ContactConfig(*ccfg))
        for a, b in zip(j, t):
            assert_tree_close(np.asarray(a), b.numpy(), TOL)
        in_c = t[3]
        assert in_c.any() and not in_c.all()
        slipped = (t[2] != tt(s['anchor'])).any(-1) & in_c
        assert slipped.any()


@pytest.mark.parametrize('extras', ['plain', 'terrain_push', 'contact_model'])
def test_step_matches_jax(extras):
    """One 1 ms tick (4 implicit substeps) from states in ground contact;
    with a stairs map and a push, and with another contact model (a wider,
    outboard toe box, 2 substeps)."""
    s, j_state, t_state = _state(8)
    rng = np.random.default_rng(9)
    cmd = [rng.normal(0.0, 5.0, (B, 2, 5)), rng.normal(0.0, 0.1, (B, 2, 5)),
           np.zeros((B, 2, 5)), rng.uniform(0.0, 300.0, (B, 2, 5)),
           rng.uniform(0.0, 5.0, (B, 2, 5))]
    kw_j, kw_t = {}, {}
    if extras == 'terrain_push':
        terrain = (np.full(B, 0.03), np.full(B, 0.05))
        dist = rng.normal(0.0, 40.0, (B, 6))
        kw_j = dict(terrain=tuple(jnp.asarray(v) for v in terrain),
                    disturbance=jnp.asarray(dist))
        kw_t = dict(terrain=tuple(tt(v) for v in terrain),
                    disturbance=tt(dist))
    if extras == 'contact_model':
        ccfg = JWB.ContactConfig(toe_halfwidth_scale=1.5, toe_y_offset=0.0194,
                                 mu=0.7)
        kw_j = dict(ccfg=ccfg, n_substeps=2)
        kw_t = dict(ccfg=TWB.ContactConfig(*ccfg), n_substeps=2)
    j_keys = tuple(kw_j)
    j = jax.vmap(lambda st, c, *a: JWB.step(
        st, c, JCFG, **{**kw_j, **dict(zip(
            [k for k in j_keys if k in ('terrain', 'disturbance')], a))}))(
        j_state, JMotor(*[jnp.asarray(c) for c in cmd]),
        *[kw_j[k] for k in j_keys if k in ('terrain', 'disturbance')])
    t = TWB.step(t_state, TMotor(*[tt(c) for c in cmd]), TCFG, **kw_t)
    assert_tree_close(todict(j), convert.to_numpy(t), TOL)
    assert t.sticking[:, :TWB.N_TOE].any()


def test_observation_and_init_match_jax():
    s, j_state, t_state = _state(10)
    assert_tree_close(todict(jax.vmap(JRT.whole_body_observation)(j_state)),
                      convert.to_numpy(TRT.whole_body_observation(t_state)),
                      TOL)
    close(jax.vmap(JWB.foot_positions)(j_state),
          TWB.foot_positions(t_state))
    j0 = JWB.init_whole_body_state(0.545, jnp.float64)
    t0 = TWB.init_whole_body_state(0.545, 3, F64, 'cpu')
    assert_tree_close({k: np.broadcast_to(v, (3,) + v.shape)
                       for k, v in todict(j0).items()},
                      convert.to_numpy(t0), 0.0)


# ---------------------------------------------------------------- rollouts

N_PERIODS = 6
# tier-2 lanes over N_PERIODS: 0 walking at 0.3 m/s; 1 the same with a 40 N
# lateral push over periods 1-3; 2 walking at 0.4 m/s, standing from period
# 3; 3 walking, passive at period 1, walking again at period 3
WALK, NONE, PASSIVE = 1, JRT.MODE_CMD_NONE, 0
# The rollouts run a stiff contact model (1e5 N/m, 0.25 ms substeps) for
# 120 substeps, and the MPC's QP between: float64 rounding in another order
# of operations grows to 1.6e-7 N in the wrench, 1.8e-8 rad/s in qd and
# 7.6e-9 rad/s in omega (measured, both estimators); every contact flag,
# mode and fall flag equal
ROLL_TOL = 1e-6


def _wb_inputs():
    walk = lambda vx: JRT.walking_command(vx=vx, dtype=jnp.float64)
    stand = JRT.standing_command(jnp.float64)
    n = N_PERIODS
    cmds = [[walk(0.3)] * n, [walk(0.3)] * n,
            [walk(0.4) if t < 3 else stand for t in range(n)],
            [walk(0.3)] * n]
    cmd_t = jax.tree.map(lambda *lanes: jnp.stack(lanes),
                         *[jax.tree.map(lambda *ps: jnp.stack(ps), *c)
                           for c in cmds])
    modes = np.full((4, n), NONE, np.int32)
    modes[3, 1], modes[3, 3] = PASSIVE, WALK
    dist = np.zeros((4, n, 6))
    dist[1, 1:4, 1] = 40.0
    return cmd_t, modes, dist


@pytest.mark.parametrize('estimator', ['cheater', 'kf'])
def test_rollout_whole_body_matches_jax(estimator):
    """Both sides under the default solver ('auto', the Mehrotra stage
    solver on a CPU), from lanes at rest at 0.545 m, per-lane keys
    fold_in(PRNGKey(5), lane)."""
    cmd_t, modes, dist = _wb_inputs()
    plant1 = JWB.init_whole_body_state(0.545, jnp.float64)
    plant = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape),
                         plant1)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(5),
                                                   jnp.arange(4))
    j_roll = JRT.make_rollout_whole_body(N_PERIODS, JCFG, batched=True,
                                         with_disturbance=True,
                                         with_schedule=True,
                                         estimator=estimator)
    carry = jax.vmap(j_roll.init)(plant, keys)
    cmd = jax.tree.map(lambda x: x[:, 0], cmd_t)
    carry, plant, j_diags = j_roll(carry, plant, cmd, jnp.asarray(dist),
                                   (cmd_t, jnp.asarray(modes)))

    t_roll = TRT.make_rollout_whole_body(N_PERIODS, TCFG,
                                         with_disturbance=True,
                                         with_schedule=True,
                                         estimator=estimator)
    t_plant = TWB.init_whole_body_state(0.545, 4, F64, 'cpu')
    t_carry = t_roll.init(t_plant, prng.fold_in(prng.PRNGKey(5, 'cpu'),
                                                torch.arange(4)))
    sched = convert.from_numpy(convert.SCHEDULE, (todict(cmd_t), modes), F64,
                               'cpu')
    t_cmd = TRT.ScenarioCommand(*[f[:, 0] for f in sched[0]])
    t_carry, t_plant, t_diags = t_roll(t_carry, t_plant, t_cmd, tt(dist),
                                       sched)
    t_diags = {k: v.numpy() for k, v in t_diags.items()}
    j_diags = todict(j_diags)
    assert set(t_diags) == set(j_diags)
    for k in range(N_PERIODS):
        assert_tree_close({n: v[:, k] for n, v in j_diags.items()},
                          {n: v[:, k] for n, v in t_diags.items()}, ROLL_TOL,
                          f'period {k}')
    assert_tree_close(todict(plant), convert.to_numpy(t_plant), ROLL_TOL)
    assert_tree_close(todict(carry), convert.to_numpy(t_carry), ROLL_TOL)
    mode = t_diags['mode']
    assert (mode[3, 1:3] == PASSIVE).all() and (mode[3, 3:] == WALK).all()
    assert not t_diags['quarantined'].any()
    # the feet reached the ground: emergent contact
    assert t_diags['contact'].any() and t_plant.sticking.any()


def test_whole_body_call_forms_match_the_combined_form():
    """with_disturbance alone is the combined form with a schedule that
    keeps the command and the modes; with_schedule alone is the combined
    form with no push; the plain form is both without either."""
    cmd_t, modes, dist = _wb_inputs()
    n = 3
    sched = convert.from_numpy(convert.SCHEDULE, (todict(cmd_t), modes), F64,
                               'cpu')
    sched = (TRT.ScenarioCommand(*[f[:, :n] for f in sched[0]]),
             sched[1][:, :n])
    t_cmd = TRT.ScenarioCommand(*[f[:, 0] for f in sched[0]])
    keep = (TRT.ScenarioCommand(*[f[:, None].expand((4, n) + f.shape[1:])
                                  for f in t_cmd]),
            torch.full((4, n), NONE, dtype=torch.int32))
    push = tt(dist[:, :n])
    plant = TWB.init_whole_body_state(0.545, 4, F64, 'cpu')
    forms = {}
    for name, flags in (('both', (True, True)), ('pushed', (True, False)),
                        ('scheduled', (False, True)),
                        ('plain', (False, False))):
        forms[name] = TRT.make_rollout_whole_body(
            n, TCFG, with_disturbance=flags[0], with_schedule=flags[1])
    carry = forms['both'].init(plant)
    pairs = (
        (forms['pushed'](carry, plant, t_cmd, push),
         forms['both'](carry, plant, t_cmd, push, keep)),
        (forms['scheduled'](carry, plant, t_cmd, sched),
         forms['both'](carry, plant, t_cmd, torch.zeros_like(push), sched)),
        (forms['plain'](carry, plant, t_cmd),
         forms['both'](carry, plant, t_cmd, torch.zeros_like(push), keep)))
    for one, ref in pairs:
        for a, b in zip(ref[:2], one[:2]):
            assert_tree_close(convert.to_numpy(a), convert.to_numpy(b), 0.0)
        assert_tree_close({k: v.numpy() for k, v in ref[2].items()},
                          {k: v.numpy() for k, v in one[2].items()}, 0.0)
    assert float((pairs[0][0][1].v_world
                  - pairs[2][0][1].v_world).abs().max()) > 1e-4
