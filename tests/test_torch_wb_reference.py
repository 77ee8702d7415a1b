"""The port's articulated plant against the benchmark's plain reference
(``cardbench/reference/whole_body.py``), in float64 on the CPU.

The reference shares no algorithm with the port: its mass matrix comes
from the composite-rigid-body algorithm and its bias forces from a
spatial-vector Newton-Euler pass (the port runs 33 unit motions through
one point-kinematics RNEA), its contact Jacobian column by column down
the chain, its solve from a Cholesky factorisation (the port's LU).  So
the terms agree to float64's rounding on the model's scale, and a tick
or a period to that rounding grown by the implicit solve's condition.
The states mix lanes in the air and in the ground, corners sticking and
sliding, and joints at their limits; the deployment's ``plant`` group
(``cardbench/configs/hector-h10-wb.json``) is the port's defaults and the
reference's constants.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from cardbench.reference import tick as R
from cardbench.reference import whole_body as RW
from cardbench.reference.config import DEFAULT_CONFIG as REF_CFG
from cardbench.traffic import loop_wb
from cardbench.yardstick import compare, scenarios as S

from hector_torch import math as hm
from hector_torch import runtime as RT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.plant import model as TMDL
from hector_torch.plant import rnea as TR
from hector_torch.plant import whole_body as TWB

torch.set_num_threads(1)
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
B = 32
# the dynamics terms: the same sums in another order, on a model whose
# entries reach 12 kg (M), 130 N (bias) and 0.7 m (points); measured
# 4e-16, 3e-14 and 2e-16 on these states
TERMS_TOL = 1e-11
# one tick: the two factorisations of the implicit matrix (condition up
# to ~1e6 from the toe joints' 2e-4 kg m^2 against the trunk's 12 kg and
# the dampers' dt J'DJ), 4 substeps of 0.25 ms; measured 7e-14 on the
# joint rates, 1e-14 on the trunk's
STEP_TOL = 1e-11
# the contact law: the same formula but a norm (measured: identical)
CONTACT_TOL = 1e-12
# the QP solved by both to ~1e-8 N (the port's dense path at 30
# iterations, the reference's certified barrier method; measured 2.5e-8
# N): the tier-1 period's bar (cardbench/tests/test_reference.py)
WRENCH_TOL = 1e-7
# a period: five ticks from the last, the wrench's gap carried into the
# joints' torques; measured 3e-9 on the joint rates, 1e-11 on the trunk's
# velocity
PERIOD_TOL = 1e-7


def states(seed, batch=B):
    """Reference states: lanes 0-3 in the air, the rest at 0.53-0.56 m
    with the toes in the ground; tilts of 0.1 rad, velocities, joint
    angles of 0.3 rad, lanes 4-7 at their joint limits moving outward;
    a third of the ground points sticking near their anchors, a sixth
    far from them (sliding)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=F64)

    st = RW.standing(batch, 0.545, F64, 'cpu')
    lim = torch.tensor(REF_CFG.plant.joint_limit, dtype=F64)
    height = u(batch, lo=0.53, hi=0.56)
    height[:4] = 0.9
    position = torch.stack([u(batch, lo=-0.2, hi=0.2),
                            u(batch, lo=-0.2, hi=0.2), height], -1)
    quat = S._quat(u(batch, 3, lo=-0.1, hi=0.1))
    q = u(batch, 2, 5, lo=-0.3, hi=0.3)
    qd = u(batch, 2, 5, lo=-2.0, hi=2.0)
    side = torch.where(u(4, 2, 5) > 0, 1.0, -1.0).to(F64)
    q[4:8] = side * lim
    qd[4:8] = side * u(4, 2, 5, lo=0.5, hi=2.0)
    st = st._replace(position=position, quat=quat, q=q, qd=qd,
                     v_world=u(batch, 3, lo=-0.5, hi=0.5),
                     omega_world=u(batch, 3, lo=-1.0, hi=1.0))
    pts, _, _ = RW.contact_points_and_jac(st.position,
                                          hm.quat_to_rot(st.quat), st.q,
                                          torch.zeros(batch, 16, dtype=F64))
    pick = u(batch, RW.N_POINTS, lo=0.0, hi=1.0)
    sticking = pick < 0.5
    near = u(batch, RW.N_POINTS, 2, lo=-1e-4, hi=1e-4)
    far = u(batch, RW.N_POINTS, 2, lo=-2e-2, hi=2e-2)
    offset = torch.where((pick < 1 / 3)[..., None], near, far)
    return st._replace(anchor=torch.where(sticking[..., None],
                                          pts[..., :2] + offset, 0.0),
                       sticking=sticking)


def motor(seed, st):
    """Servo commands up to kp 300; lanes 4-7 limp (kp = kd = 0) with
    8 N m pushing each joint on into its limit."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(st.q.shape, generator=g,
                                           dtype=F64)
    cmd = R.MotorCommand(tau=u(-8.0, 8.0), q_des=u(-0.3, 0.3),
                         qd_des=u(-1.0, 1.0), kp=u(0.0, 300.0),
                         kd=u(0.0, 5.0))
    cmd.tau[4:8] = 8.0 * torch.sign(st.q[4:8])
    cmd.kp[4:8] = 0.0
    cmd.kd[4:8] = 0.0
    return cmd


def close(a, b, tol):
    torch.testing.assert_close(a, b, rtol=0, atol=tol)


def test_model_is_the_ports_transcription():
    legs = TMDL.stacked_leg_models()
    for m, leg in ((1.0, 0), (-1.0, 1)):
        for j, (off, pre, axis, mass, com, inertia) in enumerate(
                RW.leg_joints(m)):
            for name, want in (('offset', off), ('pre', pre),
                               ('axis', axis), ('com', com),
                               ('inertia', inertia)):
                close(torch.tensor(legs[name][leg, j]),
                      torch.tensor(want, dtype=F64), 1e-15)
            assert abs(legs['mass'][leg, j] - mass) < 1e-15
    assert abs(RW.total_mass() - TMDL.total_mass()) < 1e-12
    assert RW.TRUNK_MASS == TMDL.TRUNK_MASS
    close(torch.tensor(RW.TOE_CORNERS, dtype=F64),
          torch.tensor(TMDL.CONTACT_POINTS_TOE), 0.0)
    assert RW.N_POINTS == TWB.N_CONTACT and RW.N_TOE == TWB.N_TOE


@pytest.mark.parametrize('seed', [1, 2])
def test_dynamics_terms_match(seed):
    """The mass matrix (CRBA), the bias forces (Newton-Euler), the contact
    points, velocities and Jacobian (by the chain)."""
    st = states(seed)
    rot = hm.quat_to_rot(st.quat)
    nu = torch.cat([st.v_world, st.omega_world, st.qd.reshape(B, 10)], -1)
    m_ref = RW.mass_matrix(rot, st.q)
    close(TR.mass_matrix(st.position, rot, st.q), m_ref, TERMS_TOL)
    assert float(m_ref.abs().max()) > 11.0
    close(TR.bias_forces(st.position, rot, st.q, nu, 9.81),
          RW.bias_forces(rot, st.q, nu, 9.81), TERMS_TOL)
    pts, vels, jac = TR.contact_points_and_jac(st.position, rot, st.q, nu,
                                               include_body=True)
    ref = RW.contact_points_and_jac(st.position, rot, st.q, nu)
    for a, b in zip((pts, vels, jac), ref):
        close(a, b, TERMS_TOL)


def test_contact_forces_match():
    """Points in the air and in the ground (past pen_cap on some), corners
    sticking and sliding, flat ground and stairs."""
    st = states(3)
    rot = hm.quat_to_rot(st.quat)
    nu = torch.cat([st.v_world, st.omega_world, st.qd.reshape(B, 10)], -1)
    pts, vels, _ = RW.contact_points_and_jac(st.position, rot, st.q, nu)
    pts = pts - torch.tensor([0.0, 0.0, 0.01], dtype=F64)
    for terrain in ((torch.zeros(B, dtype=F64), torch.full((B,), 0.5,
                                                           dtype=F64)),
                    (torch.full((B,), 0.03, dtype=F64),
                     torch.full((B,), 0.05, dtype=F64))):
        ref = RW.contact_forces(pts, vels, st.anchor, st.sticking, terrain)
        got = TWB.contact_forces(pts, vels, st.anchor, st.sticking, terrain,
                                 TWB.ContactConfig())
        for a, b in zip(got, ref):
            if a.dtype == torch.bool:
                assert torch.equal(a, b)
            else:
                close(a, b, CONTACT_TOL)
        touching = ref[3]
        slid = (ref[2] != st.anchor).any(-1) & st.sticking & touching
        stuck = (ref[2] == st.anchor).all(-1) & st.sticking & touching
        assert slid.any() and stuck.any() and not touching.all()
        assert (-pts[..., 2] > RW.CONTACT.pen_cap).any()


@pytest.mark.parametrize('push', [False, True])
def test_step_matches(push):
    """One tick, 4 implicit substeps: servo torques up to the clamp, joints
    at their limits, toes in the ground, with and without a push."""
    st = states(4)
    cmd = motor(5, st)
    g = torch.Generator().manual_seed(6)
    wrench = 40.0 * torch.randn((B, 6), generator=g, dtype=F64)
    terrain = (torch.zeros(B, dtype=F64), torch.full((B,), 0.5, dtype=F64))
    ref = RW.step(st, cmd, wrench if push else torch.zeros_like(wrench),
                  terrain)
    got = TWB.step(TWB.WholeBodyState(*st), cmd, TCFG, terrain=terrain,
                   disturbance=wrench if push else None)
    for name in ('position', 'quat', 'v_world', 'omega_world', 'q', 'qd',
                 'anchor'):
        close(getattr(got, name), getattr(ref, name), STEP_TOL)
    assert torch.equal(got.sticking, ref.sticking)
    assert ref.sticking[:, :RW.N_TOE].any() and not ref.sticking.all()
    lim = torch.tensor(REF_CFG.plant.joint_limit, dtype=F64)
    pinned = (ref.q.abs() == lim) & (ref.qd == 0)
    assert pinned[4:8].any()


def test_period_matches():
    """One tier-2 MPC period, from mid-walk states with pushes: the port's
    plain path (the dense QP at 30 iterations, whose float64 answer is the
    reference's certified optimum to 1e-9 N) against the reference's."""
    cfg = dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, backend='xla', iterations=30))
    n = 16
    g = S.generator(11, 0, 'cpu')
    _, moving = S.moving_state(g, n, F64, 'cpu')
    st = RW.standing(n, 0.545, F64, 'cpu')._replace(
        quat=moving.quat, v_world=moving.v_world,
        omega_world=moving.omega_world,
        q=0.1 * torch.randn((n, 2, 5), generator=torch.Generator()
                            .manual_seed(12), dtype=F64))
    tick = torch.randint(0, 400, (n,), generator=g).to(torch.int32)
    carry = R.first_carry(RW.observe(st), tick)
    cmd = S.commands(g, n, 0.25, F64, 'cpu')
    push = S.pushes(S.generator(11, 1, 'cpu'), n, 1, 30.0, 0.5, F64, 'cpu')
    pcarry, pwb = loop_wb.port_state(carry, st, cfg)
    roll = RT.make_rollout_whole_body(1, cfg, with_disturbance=True)
    c, p, diags = roll(pcarry, pwb, compare.port_command(cmd), push)
    rc, rp, first = RW.period(carry, st, cmd, push[:, 0])
    assert bool(first.certified.all())
    assert float(first.wrench.abs().max()) > 10.0
    close(diags['wrench'][:, 0], first.wrench, WRENCH_TOL)
    for name in ('position', 'quat', 'v_world', 'omega_world', 'q', 'qd',
                 'anchor'):
        close(getattr(p, name), getattr(rp, name), PERIOD_TOL)
    assert torch.equal(p.sticking, rp.sticking)
    assert torch.equal(c.tick, rc.tick) and torch.equal(c.mode, rc.mode)
    # the observation the next period starts from
    close(RT.whole_body_observation(p).foot_anchor,
          RW.observe(rp).foot_anchor, PERIOD_TOL)
    assert torch.equal(RT.whole_body_observation(p).contact,
                       RW.observe(rp).contact)


def test_start_state_is_the_ports():
    got = TWB.init_whole_body_state(0.545, 8, dtype=F64, device='cpu')
    ref = RW.standing(8, 0.545, F64, 'cpu')
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_deployment_plant_group_is_the_ports_and_the_references():
    spec = json.loads((ROOT / 'cardbench' / 'configs'
                       / 'hector-h10-wb.json').read_text())
    plant = spec['plant']
    assert plant['contact'] == TWB.ContactConfig()._asdict()
    assert plant['contact'] == RW.ContactConfig()._asdict()
    import inspect
    defaults = inspect.signature(RT.make_rollout_whole_body).parameters
    assert plant['n_substeps'] == defaults['n_substeps'].default
    assert plant['n_substeps'] == RW.N_SUBSTEPS
    assert plant['n_substeps'] == inspect.signature(
        TWB.step).parameters['n_substeps'].default
    for key in ('dt', 'joint_damping', 'torque_limit', 'joint_vel_limit'):
        assert plant[key] == getattr(TCFG.plant, key) == getattr(
            REF_CFG.plant, key), key
    assert tuple(plant['joint_limit']) == TCFG.plant.joint_limit \
        == REF_CFG.plant.joint_limit
    assert spec['solver'] == json.loads(
        (ROOT / 'cardbench' / 'configs' / 'hector-h10-fused.json')
        .read_text())['solver']
