"""The port's robustness path against the JAX package: pushes
(``srb.step(disturbance=)``), user mode commands and FSM re-entry
(``apply_mode_command``, ``reenter_walking``, ``reentry_estimate``), and
``make_rollout`` with a disturbance and a command/mode schedule, period by
period, in float64 on the CPU.

The rollouts run under the two configurations the port holds to JAX: the
fixed-sigma solver (JAX ``'riccati'`` with ``mehrotra=False`` against the
port's ``'riccati_pallas'``, the fused solver's plain version) and the
default configuration (Mehrotra on both sides: JAX's CPU ``'auto'`` and the
port's ``'auto'`` on CPU tensors).  One JAX compile per configuration; the
four lanes carry a push, a gait switch, a passive command and a passive ->
walking re-entry in the same rollout.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import control as JC
from hector import runtime as JRT
from hector.plant import srb as JSRB
from hector.config import DEFAULT_CONFIG as JCFG

from hector_torch import control as TC
from hector_torch import convert
from hector_torch import runtime as TRT
from hector_torch.plant import srb as TSRB
from hector_torch.config import DEFAULT_CONFIG as TCFG

from .test_torch_slice import (JCFG_FS, _jax_batch, _to_port, _with_solver,
                               assert_tree_close, todict)

# the batches here are tiny; one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

F64 = torch.float64
# module math in float64: the same arithmetic in another order
TOL = 1e-10
# the rollout bars of tests/test_torch_slice.py::test_rollout_matches_jax_
# period_by_period: the jitted IK's 2.5e-7 rad (JIT_IK_TOL there) reaches
# the plant through the joint servo (qd = dq / 0.02 s)
ROLL_TOL, ROLL_OVER = 1e-6, {'qd': 1e-5}
N_PERIODS = 8
PASSIVE, WALKING, NONE = JC.MODE_PASSIVE, JC.MODE_WALKING, JRT.MODE_CMD_NONE


def _push_and_schedule(n_periods):
    """Per lane: (commands by period, mode commands by period), and the
    (4, n_periods, 6) push.

    lane 0: walking at 0.3 m/s, a 40 N lateral push over periods 1-4;
    lane 1: walking at 0.4 m/s, the standing gait from period 3, a -20 N
            push along x over periods 2-3;
    lane 2: walking, commanded passive at period 2 and left there;
    lane 3: walking, passive at period 1, walking again at period 4 (the
            re-entry), a -30 N lateral push over periods 5-6.
    """
    walk = lambda vx: JRT.walking_command(vx=vx, dtype=jnp.float64)
    stand = JRT.standing_command(jnp.float64)
    n = n_periods
    cmds = [[walk(0.3)] * n,
            [walk(0.4) if t < 3 else stand for t in range(n)],
            [walk(0.2)] * n,
            [walk(0.3)] * n]
    modes = np.full((4, n), NONE, np.int32)
    modes[2, 2] = PASSIVE
    modes[3, 1], modes[3, 4] = PASSIVE, WALKING
    cmd_t = jax.tree.map(lambda *lanes: jnp.stack(lanes),
                         *[jax.tree.map(lambda *ps: jnp.stack(ps), *c)
                           for c in cmds])
    dist = np.zeros((4, n, 6))
    dist[0, 1:5, 1] = 40.0
    dist[1, 2:4, 0] = -20.0
    dist[3, 5:7, 1] = -30.0
    return cmd_t, modes, dist


def _port_inputs(cmd_t, modes, dist):
    sched = convert.from_numpy(convert.SCHEDULE, (todict(cmd_t), modes), F64,
                               'cpu')
    return convert.from_numpy(torch.Tensor, dist, F64, 'cpu'), sched


@pytest.mark.parametrize('jcfg,tcfg', [
    (JCFG_FS, _with_solver(TCFG, backend='riccati_pallas')),
    (JCFG, TCFG)], ids=['fixed_sigma', 'default'])
def test_rollout_with_pushes_and_schedule_matches_jax(jcfg, tcfg):
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed=21)
    t_carry, t_plant, t_cmd = _to_port(carry, plant, cmd, F64)
    cmd_t, modes, dist = _push_and_schedule(N_PERIODS)
    t_dist, t_sched = _port_inputs(cmd_t, modes, dist)
    assert t_sched[1].dtype == torch.int32
    j_roll = JRT.make_rollout(N_PERIODS, jcfg, batched=True,
                              with_disturbance=True, with_schedule=True)
    carry, plant, j_diags = j_roll(carry, plant, cmd, jnp.asarray(dist),
                                   (cmd_t, jnp.asarray(modes)))
    t_roll = TRT.make_rollout(N_PERIODS, tcfg, with_disturbance=True,
                              with_schedule=True)
    t_carry, t_plant, t_diags = t_roll(t_carry, t_plant, t_cmd, t_dist,
                                       t_sched)
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
    # what the lanes were given: lane 2 passive from period 2, lane 3
    # passive over periods 1-3 and walking again from 4
    mode = t_diags['mode']
    assert (mode[2, 2:] == PASSIVE).all() and (mode[2, :2] == WALKING).all()
    assert (mode[3, 1:4] == PASSIVE).all() and (mode[3, 4:] == WALKING).all()
    assert (mode[:2] == WALKING).all() and not t_diags['quarantined'].any()


def test_single_input_call_forms_match_the_combined_form():
    """with_disturbance alone is the combined form with a schedule that
    keeps the command and the modes; with_schedule alone is the combined
    form with no push."""
    t_carry, t_plant, t_cmd = _to_port(*_jax_batch(4, jnp.float64, seed=22),
                                       F64)
    n = N_PERIODS
    cmd_t, modes, dist = _push_and_schedule(n)
    t_dist, t_sched = _port_inputs(cmd_t, modes, dist)
    keep = (TRT.ScenarioCommand(*[f[:, None].expand((f.shape[0], n)
                                                    + f.shape[1:])
                                  for f in t_cmd]),
            torch.full((4, n), NONE, dtype=torch.int32))
    both = TRT.make_rollout(n, TCFG, with_disturbance=True,
                            with_schedule=True)
    pushed = TRT.make_rollout(n, TCFG, with_disturbance=True)
    scheduled = TRT.make_rollout(n, TCFG, with_schedule=True)
    for one, ref in (
            (pushed(t_carry, t_plant, t_cmd, t_dist),
             both(t_carry, t_plant, t_cmd, t_dist, keep)),
            (scheduled(t_carry, t_plant, t_cmd, t_sched),
             both(t_carry, t_plant, t_cmd, torch.zeros_like(t_dist),
                  t_sched))):
        assert float(one[2]['wrench'].abs().max()) > 10.0
        assert_tree_close(convert.to_numpy(ref[1]),
                          convert.to_numpy(one[1]), 0.0)
        assert_tree_close(convert.to_numpy(ref[0]),
                          convert.to_numpy(one[0]), 0.0)
        assert_tree_close({k: v.numpy() for k, v in ref[2].items()},
                          {k: v.numpy() for k, v in one[2].items()}, 0.0)
    # and the push moved the plant
    plain = TRT.make_rollout(n, TCFG)(t_carry, t_plant, t_cmd)
    assert float((plain[1].v_world - pushed(t_carry, t_plant, t_cmd,
                                            t_dist)[1].v_world)
                 .abs().max()) > 1e-3


def test_srb_step_with_disturbance_matches_jax():
    rng = np.random.default_rng(26)
    n = 5
    p1 = JSRB.init_plant_state(JCFG, dtype=jnp.float64)
    state = {k: np.broadcast_to(np.asarray(v), (n,) + v.shape).copy()
             for k, v in zip(p1._fields, p1)}
    state['position'] += rng.normal(0.0, 0.02, (n, 3))
    state['v_world'] += rng.normal(0.0, 0.3, (n, 3))
    state['omega_world'] += rng.normal(0.0, 0.3, (n, 3))
    state['q'] += rng.normal(0.0, 0.05, (n, 2, 5))
    cmd = [rng.normal(0.0, 2.0, (n, 2, 5)), rng.normal(0.0, 0.1, (n, 2, 5)),
           np.zeros((n, 2, 5)), rng.uniform(0.0, 30.0, (n, 2, 5)),
           rng.uniform(0.0, 5.0, (n, 2, 5))]
    wrench = np.concatenate([rng.normal(0.0, 20.0, (n, 2, 2)),
                             rng.uniform(0.0, 120.0, (n, 2, 1)),
                             rng.normal(0.0, 1.0, (n, 2, 3))], axis=-1)
    sched = rng.integers(0, 2, (n, 2)).astype(np.float64)
    dist = np.concatenate([rng.normal(0.0, 40.0, (n, 3)),
                           rng.normal(0.0, 5.0, (n, 3))], axis=-1)
    ps_j = JSRB.PlantState(*[jnp.asarray(state[k])
                             for k in JSRB.PlantState._fields])
    out_j = jax.vmap(lambda s, c, w, k, d: JSRB.step(
        s, c, w, k, disturbance=d, cfg=JCFG))(
        ps_j, JC.MotorCommand(*[jnp.asarray(c) for c in cmd]),
        jnp.asarray(wrench), jnp.asarray(sched), jnp.asarray(dist))
    ps_t = convert.from_numpy(TSRB.PlantState, state, F64, 'cpu')

    def tt(x):
        return torch.tensor(x, dtype=F64)

    args = (ps_t, TC.MotorCommand(*[tt(c) for c in cmd]), tt(wrench),
            tt(sched))
    out_t = TSRB.step(*args, disturbance=tt(dist), cfg=TCFG)
    assert_tree_close(todict(out_j), convert.to_numpy(out_t), TOL)
    # a zero push is no push
    none = TSRB.step(*args, cfg=TCFG)
    assert float((out_t.v_world - none.v_world).abs().max()) > 1e-3
    assert_tree_close(convert.to_numpy(none), convert.to_numpy(
        TSRB.step(*args, disturbance=torch.zeros_like(tt(dist)), cfg=TCFG)),
        0.0)


def _advanced(seed):
    """A batch a few ticks into walking, so that the planner and swing
    carry differ from a fresh entry: (JAX carry, plant, cmd)."""
    carry, plant, cmd = _jax_batch(4, jnp.float64, seed)
    tick = jax.vmap(lambda c, p, m: JRT.controller_tick(
        c, p, m, do_mpc=False, cfg=JCFG)[0])
    for _ in range(3):
        carry = tick(carry, plant, cmd)
    return carry, plant, cmd


def test_apply_mode_command_and_reentry_match_jax():
    carry, plant, cmd = _advanced(23)
    carry = carry._replace(mode=jnp.asarray([WALKING, PASSIVE, PASSIVE,
                                             WALKING], jnp.int32))
    mode_cmd = jnp.asarray([NONE, WALKING, NONE, PASSIVE], jnp.int32)
    t_carry, t_plant, _ = _to_port(carry, plant, cmd, F64)
    j_new = jax.vmap(lambda c, p, m: JRT.apply_mode_command(
        c, p, m, JCFG))(carry, plant, mode_cmd)
    t_new = TRT.apply_mode_command(t_carry, t_plant,
                                   torch.tensor(np.asarray(mode_cmd)), TCFG)
    assert_tree_close(todict(j_new), convert.to_numpy(t_new), TOL)
    assert t_new.mode.tolist() == [WALKING, WALKING, PASSIVE, PASSIVE]
    # only lane 1 entered walking: its planner was re-initialized
    changed = (t_new.planner.world_position_desired
               != t_carry.planner.world_position_desired).any(-1)
    assert changed.tolist() == [False, True, False, False]

    j_fresh = jax.vmap(lambda c, p: JRT.reenter_walking(c, p, JCFG))(
        carry, plant)
    t_fresh = TRT.reenter_walking(t_carry, t_plant, TCFG)
    assert_tree_close(todict(j_fresh), convert.to_numpy(t_fresh), TOL)
    j_est = jax.vmap(lambda c, p: JRT.reentry_estimate('cheater', c, p))(
        carry, plant)
    t_est = TRT.reentry_estimate('cheater', t_carry, t_plant)
    assert_tree_close(todict(j_est), convert.to_numpy(t_est), TOL)
    assert_tree_close(todict(j_fresh), convert.to_numpy(TRT.reenter_walking(
        t_carry, t_plant, TCFG, est=t_est)), 0.0)
