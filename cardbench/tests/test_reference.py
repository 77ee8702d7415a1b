"""The reference, written from the published controller, against two
witnesses it shares no code with: the port's plain path in float64 at a
tiny size (the same planning step and the same closed-loop period, the
port's dense interior point on torch.linalg run to convergence), and the
repository's golden QPs (tests/golden/solver.npz: the published
SolverMPC.cpp transcribed in numpy, solved by an active-set method and a
scipy cross-check)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench.reference import legs, mpc, plant as P, qp, tick as R
from cardbench.reference.config import DEFAULT_CONFIG, JOINT_OFFSETS
from cardbench.yardstick import compare, scenarios as S

DT = torch.float64
GOLDEN = Path(__file__).resolve().parents[2] / 'tests' / 'golden'


def port_cfg():
    from hector_torch.config import DEFAULT_CONFIG as PORT
    return dataclasses.replace(PORT, solver=dataclasses.replace(
        PORT.solver, backend='xla', iterations=30))


def inputs(seed, batch=24):
    g = S.generator(seed, 0, 'cpu')
    carry, plant = S.moving_state(g, batch, DT, 'cpu')
    cmd = S.commands(g, batch, 0.25, DT, 'cpu')
    return carry, plant, cmd


def test_planning_step_matches_the_port():
    from hector_torch import runtime as RT
    cfg = port_cfg()
    carry, plant, cmd = inputs(7)
    pcarry, pplant = compare.port_state(carry, plant, cfg)
    new, wrench, motor = RT.plan_step_fn(cfg)(pcarry, pplant,
                                              compare.port_command(cmd))
    ref = R.controller_tick(carry, plant, cmd, True)
    assert bool(ref.certified.all())
    assert wrench.abs().max() > 10.0
    torch.testing.assert_close(ref.wrench, wrench, rtol=0, atol=1e-7)
    torch.testing.assert_close(ref.motor.tau, motor.tau, rtol=0, atol=1e-7)
    torch.testing.assert_close(ref.carry.f_ff, new.planner.f_ff, rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(ref.motor.q_des, motor.q_des, rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(ref.carry.world_position_desired,
                               new.planner.world_position_desired)
    for a, b in zip(ref.carry.swing, new.swing):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert torch.equal(ref.carry.tick, new.tick)


def test_period_matches_the_port():
    from hector_torch import runtime as RT
    cfg = port_cfg()
    carry, plant, cmd = inputs(8)
    push = S.pushes(S.generator(8, 1, 'cpu'), 24, 1, 30.0, 0.5, DT, 'cpu')
    roll = RT.make_rollout(1, cfg, with_disturbance=True)
    pcarry, pplant = compare.port_state(carry, plant, cfg)
    c, p, diags = roll(pcarry, pplant, compare.port_command(cmd), push)
    rc, rp, first = R.period(carry, plant, cmd, push[:, 0])
    torch.testing.assert_close(first.wrench, diags['wrench'][:, 0], rtol=0,
                               atol=1e-7)
    for name in ('position', 'v_world', 'quat', 'omega_world', 'q', 'qd',
                 'foot_anchor'):
        torch.testing.assert_close(getattr(rp, name), getattr(p, name),
                                   rtol=0, atol=1e-8)
    assert torch.equal(rc.tick, c.tick) and torch.equal(rc.mode, c.mode)


@pytest.mark.parametrize('scenario', range(3))
def test_qp_matches_the_golden_transcription(scenario):
    z = np.load(GOLDEN / 'solver.npz')

    def get(name):
        return torch.tensor(z[f's{scenario}_{name}'], dtype=DT)[None]
    m = DEFAULT_CONFIG.mpc
    quat = get('quat')
    rot = P.rotation(quat)
    q = get('joint_angles').reshape(1, 2, 5) + torch.tensor(JOINT_OFFSETS,
                                                            dtype=DT)
    x0 = get('x0')
    prob = mpc.build(x0, get('traj'), rot, legs.foot_rotation(q),
                     get('r_feet'), get('gait'),
                     torch.diag(torch.tensor(
                         DEFAULT_CONFIG.robot.inertia_body, dtype=DT)), m)
    torch.testing.assert_close(prob.h, get('qH'), rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(prob.g, get('qg'), rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(prob.a[:, :16, :12], get('F'), rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(prob.lb, get('Lb').reshape(1, -1))
    torch.testing.assert_close(prob.ub, get('Ub').reshape(1, -1))
    assert torch.equal(prob.keep_v, get('keep_v').bool())
    gm = torch.cat([prob.a, -prob.a], 1)
    h = torch.cat([prob.ub, -prob.lb], 1)
    rows = torch.cat([prob.keep_c & (prob.ub < 1e9),
                      prob.keep_c & (prob.lb > -1e9)], 1)
    table = get('gait')
    sol = qp.solve(prob.h, prob.g, gm, h, rows, prob.keep_v,
                   R.interior_start(legs.foot_rotation(q), rot, table, m))
    assert bool(sol.certified.all())
    torch.testing.assert_close(sol.u, get('q_soln'), rtol=0, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    import ast
    ref = Path(R.__file__).resolve().parent
    for path in ref.rglob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for n in names:
                assert n.split('.')[0] not in ('hector_torch', 'hector',
                                               'jax', 'jaxlib'), (path, n)
