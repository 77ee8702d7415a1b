"""The tier-1 plant step's CUDA kernel (``hector_torch/csrc/srb_plant.cu``,
``srb_plant_step_kernel<T>``) against its plain version ``srb.step_plain``.

Three kinds of case:

- CPU: ``srb.step`` on CPU tensors is ``step_plain`` bit for bit and
  launches nothing.
- Host build: g++ compiles the kernel's source against
  ``tests/host_cuda/cuda_runtime.h`` (a block's threads as std::threads),
  with ``-ffp-contract=off`` as nvcc's ``-fmad=false``, and runs it on CPU
  tensors through ``srb.launch_args``: the same argument packing, strides
  and constants as on the card.  It checks the arithmetic, the order of the
  branches, NaN and inf propagation and the strided and broadcast inputs;
  speed says nothing here.
- Card (marker ``card``): the kernel built by nvcc and launched by
  ``srb.step`` on CUDA tensors, one step and a captured 100-period rollout.
  Run where there is a card, without this directory's conftest (it
  imports JAX, which the card's machine lacks):

      python -m pytest --noconftest tests/test_torch_plant_kernel.py -m card

The seeded batch (numpy) covers stance, swing and touchdown lanes, limp
joints (kp = 0), flat ground and stairs (a step length under the 1e-3
floor too), pushes and none, a trunk below its radius, feet below the
ground, an active friction clamp and torque scale, and lanes with NaN and
inf in the state, the command, the wrench, the push and the terrain.

Tolerances.  float64: the kernel takes step_plain's operations in its
order, so the two agree to 1e-12 of each output's size (the rest is the
library's transcendentals and the order of the 3-term sums inside a
matrix product), times the stance IK's condition number on the joint
angles and rates of a stance leg.  The IK (SwingLegController.cpp's
formula) takes acos of dist_vert / dist_xoz = 1 - d0^2 / (2 dist_xoz^2)
nearly: with the foot a fraction of a millimetre ahead of or behind the
hip, a last-bit difference in that ratio moves the angle by it over
sqrt(1 - ratio^2), some thousand times more (on an H100, up to 3.5e-12 of
the rates' size over 4,096 lanes; about one leg in 70 of this batch has a
condition number above 100).  So the bar on those two outputs of a stance
leg is 1e-12 times 1 / sqrt(1 - a^2) at the largest unclamped argument a
of the IK's asin and acos, computed from step_plain's own new pose; on
every other output and leg it is 1e-12.  float32: per lane, the widest
gap of any output to the float64 plain version; at the 50th and 90th
percentile and the largest lane, the kernel's gap may be at most twice
the float32 plain version's own, since both round the same operations in
float32 and only their order inside matrix products and the
transcendentals' last bits differ.  The non-finite mask of every output
agrees exactly.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hector_torch import cuda, graph
from hector_torch import math as hm
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.control import MotorCommand
from hector_torch.kinematics import foot_position, hip_yaw_locations
from hector_torch.plant import srb
from hector_torch.swing import hip_width_offset

torch.set_num_threads(1)
CPU = torch.device('cpu')
SHIM = Path(__file__).resolve().parent / 'host_cuda'
F64_TOL = 1e-12
F32_FACTOR = 2.0
QUANTILES = (0.5, 0.9, 1.0)

# a config other than the default in every group the kernel reads
OTHER_CFG = dataclasses.replace(
    TCFG,
    plant=dataclasses.replace(
        TCFG.plant, dt=0.0008, mass=15.2, gravity=9.79, torque_limit=28.0,
        joint_vel_limit=18.0, joint_tracking_tau=0.025,
        swing_joint_inertia=0.03, contact_kp=2.5e4, contact_kd=420.0,
        trunk_radius=0.12, ground_mu=0.7, inertia_body=(0.6, 0.55, 0.08)),
    robot=dataclasses.replace(TCFG.robot, hip_yaw_x=-0.008, hip_yaw_y=-0.06,
                              hip_yaw_z=-0.12),
    swing=dataclasses.replace(TCFG.swing, hip_width_offset_x=-0.02,
                              hip_width_offset_y=-0.05),
    fk=dataclasses.replace(TCFG.fk, a_x=-0.017, l_thigh=0.23, l_toe=0.04),
    jac=dataclasses.replace(TCFG.jac, b_y_const=-0.003, l_calf=0.21),
    ik=dataclasses.replace(TCFG.ik, hip_x=-0.015, distance_horizontal=0.022,
                           l_link=0.225))

# (lane, what is non-finite): the lanes of a batch of at least 64 that carry
# a NaN or an inf
NONFINITE = ((3, 'position', 0, np.nan), (7, 'quat', 2, np.inf),
             (11, 'v_world', 2, -np.inf), (13, 'q', 7, np.nan),
             (17, 'qd', 3, np.inf), (19, 'wrench', 2, np.inf),
             (23, 'wrench', 10, np.nan), (29, 'kp', 4, np.nan),
             (31, 'q_des', 6, np.inf), (37, 'disturbance', 4, np.nan),
             (41, 'terrain_h', 0, np.inf), (43, 'omega_world', 1, np.nan),
             (47, 'foot_anchor', 5, np.inf), (53, 'kd', 8, -np.inf))


def _rot(rpy):
    r, p, y = rpy[:, 0], rpy[:, 1], rpy[:, 2]
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    rows = ([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr])
    return np.stack([np.stack(r, -1) for r in rows], -2)


def _quat(rpy):
    h = rpy * 0.5
    cr, cp, cy = np.cos(h[:, 0]), np.cos(h[:, 1]), np.cos(h[:, 2])
    sr, sp, sy = np.sin(h[:, 0]), np.sin(h[:, 1]), np.sin(h[:, 2])
    return np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy],
                    -1)


def batch(n, seed, cfg=TCFG, nonfinite=True):
    """A seeded batch of ``n`` lanes as float64 numpy arrays, each value a
    float32 number (so the float32 and float64 runs see the same inputs):
    a dict of the state, command, wrench, schedule, push and terrain."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.35, 0.35, (n, 2, 5))
    rpy = rng.uniform(-0.25, 0.25, (n, 3))
    rpy[: n // 8] = rng.uniform(-1.2, 1.2, (n // 8, 3))
    rot = _rot(rpy)
    q_t = torch.tensor(q)
    feet_b = (hip_yaw_locations(cfg, q_t) + foot_position(q_t, cfg)).numpy()
    feet_w = np.einsum('bij,blj->bli', rot, feet_b)
    # trunk height: the lower foot near the ground, some below it
    z = -feet_w[..., 2].min(-1) + rng.uniform(-0.01, 0.01, n)
    z[n // 8: n // 8 + n // 16] = rng.uniform(0.0, 0.09, n // 16)
    pos = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n), z],
                   -1)
    anchor = pos[:, None, :] + feet_w + rng.normal(0.0, 0.01, (n, 2, 3))
    anchor[..., 2] = rng.uniform(-0.005, 0.005, (n, 2))
    kp = rng.uniform(20.0, 80.0, (n, 2, 5)) * (rng.uniform(size=(n, 2, 1))
                                               > 0.25)
    wrench = np.concatenate([rng.normal(0.0, 40.0, (n, 2, 2)),
                             rng.uniform(0.0, 250.0, (n, 2, 1)),
                             rng.normal(0.0, 6.0, (n, 2, 3))], -1)
    wrench[: n // 4] *= 6.0          # beyond the joints' torque limit
    height = rng.choice([0.0, 0.0, 0.04, 0.12], n)
    length = rng.uniform(0.15, 0.45, n)
    length[::29] = 1e-4              # under the 1e-3 floor
    d = dict(
        position=pos, quat=_quat(rpy), v_world=rng.normal(0.0, 0.4, (n, 3)),
        omega_world=rng.normal(0.0, 0.8, (n, 3)), q=q,
        qd=rng.normal(0.0, 2.0, (n, 2, 5)), foot_anchor=anchor,
        contact=rng.uniform(size=(n, 2)) < 0.5,
        kp=kp, kd=rng.uniform(0.0, 4.0, (n, 2, 5)),
        q_des=q + rng.normal(0.0, 0.3, (n, 2, 5)),
        wrench=wrench, sched=rng.uniform(size=(n, 2)) < 0.6,
        disturbance=rng.normal(0.0, 40.0, (n, 6)),
        terrain_h=height, terrain_len=length)
    if nonfinite:
        for lane, key, k, val in NONFINITE:
            if lane < n:
                d[key].reshape(n, -1)[lane, k] = val
    return {k: v if v.dtype == bool
            else v.astype(np.float32).astype(np.float64)
            for k, v in d.items()}


def inputs(d, dtype, device, push=True, stairs=True):
    """(state, cmd, wrench, sched, disturbance, terrain) as tensors."""
    def t(x):
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool else dtype,
                            device=device)

    state = srb.PlantState(*[t(d[k]) for k in (
        'position', 'quat', 'v_world', 'omega_world', 'q', 'qd',
        'foot_anchor', 'contact')])
    zero = torch.zeros(d['kp'].shape, dtype=dtype, device=device)
    cmd = MotorCommand(tau=zero, q_des=t(d['q_des']), qd_des=zero,
                       kp=t(d['kp']), kd=t(d['kd']))
    return (state, cmd, t(d['wrench']), t(d['sched']),
            t(d['disturbance']) if push else None,
            (t(d['terrain_h']), t(d['terrain_len'])) if stairs else None)


def ik_condition(args, out, cfg=TCFG):
    """(B, 2): 1 / sqrt(1 - a^2) at the largest unclamped argument a of the
    stance IK's asin and acos, from step_plain's new pose ``out``; 1 on a
    leg out of contact or where it is not finite."""
    state, sched = args[0], args[3]
    rot = hm.quat_to_rot(out.quat)
    anchor_b = ((state.foot_anchor - out.position[:, None, :]) @ rot
                + hip_width_offset(cfg, out.position))
    ik = cfg.ik
    d = anchor_b - torch.tensor([ik.hip_x, 0.0, ik.hip_z],
                                dtype=anchor_b.dtype, device=anchor_b.device)
    dh = ik.distance_horizontal
    dist3 = d.norm(dim=-1)
    dist_yoz = d[..., 1:].norm(dim=-1)
    dist_vert = torch.sqrt(torch.clamp(dist_yoz ** 2 - dh ** 2,
                                       min=ik.eps_vertical))
    dist_xoz = torch.sqrt(torch.clamp(dist3 ** 2 - dh ** 2,
                                      min=ik.eps_vertical))
    side = torch.tensor([-1.0, 1.0], dtype=d.dtype, device=d.device)
    a = torch.stack([dist_xoz / (2.0 * ik.l_link), dist_vert / dist_xoz,
                     d[..., 1] / dist_yoz, dh * side / dist_yoz], -1)
    kappa = torch.where(a.abs() < 1.0, 1.0 / torch.sqrt(1.0 - a * a),
                        torch.ones_like(a)).amax(-1)
    kappa = torch.where(torch.isfinite(kappa) & (sched > 0), kappa,
                        torch.ones_like(kappa))
    return kappa


def f64_excess(got, want, args, cfg=TCFG):
    """The largest gap of the kernel's float64 output to step_plain's over
    its bar: 1e-12 of the output's size (max(|want|, 1) over the batch),
    times ik_condition on a stance leg's joint angles and rates.  At most
    1 where they agree."""
    kappa = ik_condition(args, want, cfg).cpu()
    out = 0.0
    for name, x, y in zip(srb.PlantState._fields, got, want):
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
            continue
        x, y = x.double().cpu(), y.double().cpu()
        ok = torch.isfinite(y)
        if not ok.any():
            continue
        bar = F64_TOL * max(float(y.abs()[ok].max()), 1.0)
        bar = torch.full_like(y, bar)
        if name in ('q', 'qd'):
            bar = bar * kappa[..., None]
        gap = torch.where(ok, (x - y).abs() / bar, torch.zeros_like(y))
        out = max(out, float(gap.max()))
    return out


def lane_gaps(a, ref):
    """(B,) the widest gap of any finite output entry of a lane."""
    cols = [(x.double().cpu() - y.double().cpu()).reshape(x.shape[0], -1)
            for x, y in zip(a, ref) if x.dtype != torch.bool]
    g = torch.cat(cols, 1).abs()
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g)).amax(1)


def nonfinite_masks_agree(a, b):
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            assert torch.equal(x.cpu(), y.cpu())
        else:
            assert torch.equal(torch.isfinite(x).cpu(),
                               torch.isfinite(y).cpu())


def quantiles(g):
    return [float(torch.quantile(g, q)) for q in QUANTILES]


def assert_f32_within(kern, plain32, ref64, finite):
    gk = lane_gaps(kern, ref64)[finite]
    gp = lane_gaps(plain32, ref64)[finite]
    for q, k, p in zip(QUANTILES, quantiles(gk), quantiles(gp)):
        assert k <= F32_FACTOR * p, (q, k, p)


def finite_lanes(state):
    q = state.q.reshape(state.q.shape[0], -1)
    return (torch.isfinite(state.position).all(1)
            & torch.isfinite(q).all(1)).cpu()


# -- CPU ------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('push,stairs', [(True, True), (False, False)])
def test_step_on_cpu_is_step_plain_and_launches_nothing(dtype, push, stairs):
    before = cuda.counts.plant_launches
    args = inputs(batch(64, seed=5), dtype, CPU, push, stairs)
    got = srb.step(*args)
    want = srb.step_plain(*args)
    assert cuda.counts.plant_launches == before
    for x, y in zip(got, want):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def test_step_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        srb.step_cuda(*inputs(batch(4, seed=1), torch.float32, CPU))


def test_plant_launches_is_a_graph_counter():
    names = [name for _, name in graph.kernel_counters()]
    assert (cuda.counts, 'plant_launches') in graph.kernel_counters()
    assert len(set(names)) == len(names)


# -- the host build of the kernel ---------------------------------------


def _host_source():
    """srb_plant.cu with the kernel launches (the plant step's and the
    tick's leg data's) rewritten for the stand-in."""
    src = cuda.SRB.source.read_text()
    src, n = re.subn(r'(\w+<\w+>)<<<(.+?)>>>\(',
                     lambda m: f'host_launch({m.group(1)}, {m.group(2)}, ',
                     src, flags=re.S)
    assert n == 2 and '<<<' not in src and 'asm' not in src
    return src


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build the host stand-in')
    out = tmp_path_factory.mktemp('srb_host')
    cpp = out / 'srb_host.cpp'
    cpp.write_text(_host_source())
    so = out / 'libsrb_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-pthread', f'-I{SHIM}', '-o', str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.srb_plant_step.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.srb_plant_step.restype = ctypes.c_int
    return lib


def host_step(lib, state, cmd, wrench, sched, disturbance=None, terrain=None,
              cfg=TCFG):
    args, prm, out, _sched = srb.launch_args(state, cmd, wrench, sched,
                                             disturbance, terrain, cfg)
    assert lib.srb_plant_step(int(out.position.dtype == torch.float64),
                              ctypes.byref(args), ctypes.byref(prm),
                              None) == 0
    return out


@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
@pytest.mark.parametrize('push,stairs', [(True, True), (False, False),
                                         (True, False)])
def test_host_kernel_float64_matches_plain(host_lib, cfg, push, stairs):
    args = inputs(batch(96, seed=11, cfg=cfg), torch.float64, CPU, push,
                  stairs)
    got = host_step(host_lib, *args, cfg=cfg)
    want = srb.step_plain(*args, cfg=cfg)
    nonfinite_masks_agree(got, want)
    assert f64_excess(got, want, args, cfg) <= 1.0


@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_host_kernel_float32_within_twice_plain(host_lib, cfg):
    d = batch(512, seed=23, cfg=cfg)
    ref = srb.step_plain(*inputs(d, torch.float64, CPU), cfg=cfg)
    args32 = inputs(d, torch.float32, CPU)
    kern = host_step(host_lib, *args32, cfg=cfg)
    plain = srb.step_plain(*args32, cfg=cfg)
    nonfinite_masks_agree(kern, plain)
    nonfinite_masks_agree(kern, ref)
    assert_f32_within(kern, plain, ref, finite_lanes(ref))


def test_host_kernel_takes_strided_and_broadcast_inputs(host_lib):
    """Inputs as the eager rollout hands them (a period's slice of the
    pushes, lane strides of a schedule) and broadcast ones give what
    contiguous copies give, bit for bit."""
    n, periods = 40, 3
    d = batch(n, seed=3, nonfinite=False)
    state, cmd, wrench, sched, push, terrain = inputs(d, torch.float64, CPU)
    pushes = torch.randn((n, periods, 6), dtype=torch.float64)
    heights = torch.rand((n, periods), dtype=torch.float64) * 0.1
    lengths = 0.2 + torch.rand((n, periods), dtype=torch.float64) * 0.2
    kd = torch.full((1, 1, 5), 3.0, dtype=torch.float64)
    cmd_b = cmd._replace(kd=kd)
    wrench_t = wrench.transpose(1, 2).contiguous().transpose(1, 2)
    got = host_step(host_lib, state, cmd_b, wrench_t, sched, pushes[:, 1],
                    (heights[:, 2], lengths[:, 2]))
    want = host_step(host_lib, state, cmd_b._replace(kd=kd.expand(n, 2, 5)
                                                     .contiguous()),
                     wrench, sched, pushes[:, 1].contiguous(),
                     (heights[:, 2].contiguous(), lengths[:, 2].contiguous()))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    args = (state, cmd_b, wrench, sched, pushes[:, 1],
            (heights[:, 2], lengths[:, 2]))
    assert f64_excess(got, srb.step_plain(*args), args) <= 1.0


def test_host_kernel_refuses_what_it_does_not_take(host_lib):
    state, cmd, wrench, sched, push, terrain = inputs(
        batch(8, seed=2), torch.float32, CPU)
    with pytest.raises(TypeError, match='float32'):
        srb.launch_args(state, cmd._replace(kp=cmd.kp.double()), wrench,
                        sched)
    with pytest.raises(ValueError, match='shape'):
        srb.launch_args(state, cmd, wrench[:, :, :5], sched)
    with pytest.raises(TypeError, match='float32 or float64'):
        srb.launch_args(state._replace(position=state.position.half()), cmd,
                        wrench, sched)


def test_host_kernel_float_schedule_is_its_positive_entries(host_lib):
    args = list(inputs(batch(16, seed=9), torch.float64, CPU))
    sched = args[3]
    args_f = list(args)
    args_f[3] = torch.where(sched, 0.5, -1.0).to(torch.float64)
    a, b = host_step(host_lib, *args), host_step(host_lib, *args_f)
    for x, y in zip(a, b):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')


@pytest.mark.card
@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
@pytest.mark.parametrize('push,stairs', [(True, True), (False, False)])
def test_card_kernel_float64_matches_plain(card, cfg, push, stairs):
    args = inputs(batch(4096, seed=101, cfg=cfg), torch.float64, card, push,
                  stairs)
    before = cuda.counts.plant_launches
    got = srb.step(*args, cfg=cfg)
    assert cuda.counts.plant_launches == before + 1
    want = srb.step_plain(*args, cfg=cfg)
    nonfinite_masks_agree(got, want)
    assert f64_excess(got, want, args, cfg) <= 1.0


@pytest.mark.card
@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_card_kernel_float32_within_twice_plain(card, cfg):
    d = batch(16384, seed=202, cfg=cfg)
    ref = srb.step_plain(*inputs(d, torch.float64, card), cfg=cfg)
    args32 = inputs(d, torch.float32, card)
    kern = srb.step(*args32, cfg=cfg)
    plain = srb.step_plain(*args32, cfg=cfg)
    nonfinite_masks_agree(kern, plain)
    nonfinite_masks_agree(kern, ref)
    assert_f32_within(kern, plain, ref, finite_lanes(ref))


def _rollout_inputs(n, periods, dtype, card, seed=7):
    cmd = TRT.walking_command(n, vx=0.4, dtype=dtype, device=card)
    g = torch.Generator(device='cpu').manual_seed(seed)
    push = torch.zeros((n, periods, 6), dtype=dtype)
    hit = torch.rand((n, periods), generator=g) < 0.01
    push[..., 0:2] = torch.where(hit[..., None],
                                 30.0 * torch.randn((n, periods, 2),
                                                    generator=g), 0.0)
    plant = srb.init_plant_state(n, TCFG, dtype=dtype, device=card)
    return plant, cmd, push.to(card)


@pytest.mark.card
def test_card_captured_rollout_launches_the_kernel(card, monkeypatch):
    """A captured 100-period rollout with pushes at 1,024 lanes under the
    production backend: 5 launches a period, at most 15 device nodes in
    ``period.plant`` a period, and the end state beside the same rollout on
    ``step_plain`` within the float32 rule, with a float64 rollout on
    ``step_plain`` as the reference (the stage solver, which takes both
    dtypes)."""
    n, periods = 1024, 100
    roll = TRT.make_rollout(periods, TCFG, with_disturbance=True)
    plant, cmd, push = _rollout_inputs(n, periods, torch.float32, card)
    before = cuda.counts.plant_launches
    carry0 = roll.init(plant)
    roll(carry0, plant, cmd, push)
    assert cuda.counts.plant_launches - before == 5 * periods
    cap, = roll.graphed.captures.values()
    table = graph.phase_table(cap.id)
    plant_nodes = 0
    for name, parent, first, stop in table['phases']:
        if name == 'period.plant' and parent == -1:
            plant_nodes += sum(1 for kind, _ in table['nodes'][first:stop]
                               if kind != 'other')
    assert plant_nodes <= 15          # the table is one period's
    assert plant_nodes >= 5

    cfg = dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, backend='riccati'))
    ends = {}
    for name, dtype, step in (('kernel', torch.float32, srb.step),
                              ('plain', torch.float32, srb.step_plain),
                              ('ref', torch.float64, srb.step_plain)):
        monkeypatch.setattr(srb, 'step', step)
        roll = TRT.make_rollout(periods, cfg, with_disturbance=True)
        plant, cmd, push = _rollout_inputs(n, periods, dtype, card)
        _, end, _ = roll(roll.init(plant), plant, cmd, push)
        ends[name] = end
    finite = finite_lanes(ends['ref'])
    assert finite.all()
    assert_f32_within(ends['kernel'], ends['plain'], ends['ref'], finite)
