"""The articulated plant's dynamics kernel (``hector_torch/csrc/wb_dynamics.cu``,
``wb_dynamics_kernel<T>``) against its plain version, ``rnea.dynamics`` on
CPU tensors: the trunk rotation from the quaternion, nu by concatenation,
then ``rnea.dynamics_plain``'s pass of 33 motions.

Three kinds of case, as for the tier-1 plant kernel
(tests/test_torch_plant_kernel.py):

- CPU: ``rnea.dynamics`` on CPU tensors is the plain pass bit for bit and
  launches nothing; the launch counter is a graph counter.
- Host build: g++ compiles the kernel's source against
  ``tests/host_cuda/cuda_runtime.h`` (a warp's threads as std::threads,
  ``__syncwarp`` a barrier) with ``-ffp-contract=off`` and runs it on CPU
  tensors through ``rnea.dynamics_launch_args``: the same argument packing,
  strides and constants as on the card.
- Card (marker ``card``): the kernel built by nvcc and launched by
  ``rnea.dynamics`` on CUDA tensors at 1,024 lanes, and a captured tier-2
  rollout.  Run where there is a card, without this directory's conftest
  (it imports JAX, which the card's machine lacks):

      python -m pytest --noconftest tests/test_torch_wb_dynamics_kernel.py -m card

The seeded states are standing, mid-stride, fallen and tilted (any trunk
attitude, the trunk near the ground) and with every joint at its limit at
the joint rate limit, with and without the body points, under the default
toe-box corners and under corners scaled and shifted by ContactConfig's
sensitivity axes.

Tolerances.  float64: the kernel takes the plain ops in their order (only
the order inside a 3x3 product, the library's sine and cosine, and on the
card the contraction of a product and a sum into one rounding differ), so
each output agrees to 1e-12 of its size (max(|want|, 1) over the batch;
measured some 1e-16 on the host build).  float32: per output and lane, the
widest gap to the float64 plain version; at the 50th and 90th percentile
and the widest lane the kernel's gap may be at most twice the float32 plain
version's own (the plant kernel's rule: both round the same operations in
float32).  A NaN in the state gives NaN where the plain pass gives it.
"""

import ctypes
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
from hector_torch.plant import rnea
from hector_torch.plant import whole_body as WB
from hector_torch.plant.model import TOE_BOX_Y_CENTER

torch.set_num_threads(1)
CPU = torch.device('cpu')
SHIM = Path(__file__).resolve().parent / 'host_cuda'
F64_TOL = 1e-12
F32_FACTOR = 2.0
QUANTILES = (0.5, 0.9, 1.0)
OUTPUTS = ('m', 'bias', 'pts', 'vels', 'jac')
KINDS = ('standing', 'stride', 'fallen', 'limits')
# the toe box 1.5 times as wide and at the URDF's outboard offset
SCALED = WB.ContactConfig(toe_halfwidth_scale=1.5,
                          toe_y_offset=TOE_BOX_Y_CENTER)


def states(n, seed, kind):
    """``n`` seeded lanes of one kind as float64 numpy arrays, each value a
    float32 number (so the float32 and float64 runs see the same inputs):
    position, quat, q, v_world, omega_world, qd."""
    rng = np.random.default_rng(seed)
    lim = np.asarray(TCFG.plant.joint_limit)
    if kind == 'standing':
        quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.02, (n, 4))
        pos = rng.normal([0.0, 0.0, 0.52], 0.01, (n, 3))
        q = rng.uniform(-0.15, 0.15, (n, 2, 5))
        v, w, qd = (rng.normal(0.0, s, sh) for s, sh in
                    ((0.05, (n, 3)), (0.1, (n, 3)), (0.3, (n, 2, 5))))
    elif kind == 'stride':
        quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.1, (n, 4))
        pos = rng.normal([0.0, 0.0, 0.5], 0.05, (n, 3))
        q = rng.uniform(-0.7, 0.7, (n, 2, 5))
        v, w, qd = (rng.normal(0.0, s, sh) for s, sh in
                    ((0.6, (n, 3)), (1.0, (n, 3)), (4.0, (n, 2, 5))))
    elif kind == 'fallen':
        quat = rng.normal(0.0, 1.0, (n, 4))
        pos = rng.normal([0.0, 0.0, 0.12], 0.03, (n, 3))
        q = rng.uniform(-1.7, 1.7, (n, 2, 5))
        v, w, qd = (rng.normal(0.0, s, sh) for s, sh in
                    ((3.0, (n, 3)), (10.0, (n, 3)), (10.0, (n, 2, 5))))
    else:
        quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.3, (n, 4))
        pos = rng.normal([0.0, 0.0, 0.4], 0.1, (n, 3))
        q = lim * rng.choice([-1.0, 1.0], (n, 2, 5))
        qd = TCFG.plant.joint_vel_limit * rng.choice([-1.0, 1.0], (n, 2, 5))
        v, w = rng.normal(0.0, 1.0, (n, 3)), rng.normal(0.0, 3.0, (n, 3))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return [x.astype(np.float32).astype(np.float64)
            for x in (pos, quat, q, v, w, qd)]


def mixed(n, seed):
    """A batch of every kind, a quarter each."""
    parts = [states(n // 4, seed + i, k) for i, k in enumerate(KINDS)]
    return [np.concatenate(xs) for xs in zip(*parts)]


def tensors(d, dtype, device=CPU):
    return [torch.tensor(x, dtype=dtype, device=device) for x in d]


def cps_of(ccfg, like):
    return WB._contact_offsets(ccfg, like)


def plain(pos, quat, q, v, w, qd, cps=None, include_body=True):
    """The plain pass as the parent commit's plant step ran it."""
    nu = torch.cat([v, w, qd.reshape(qd.shape[0], 10)], dim=-1)
    return rnea.dynamics_plain(pos, hm.quat_to_rot(quat), q, nu,
                               TCFG.plant.gravity, cps=cps,
                               include_body=include_body)


def assert_same(a, b):
    """Bit for bit, NaN where NaN."""
    for x, y in zip(a, b):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def f64_excess(got, want):
    """Per output, the largest gap over its bar, 1e-12 of the output's
    size (max(|want|, 1) over the finite entries): at most 1 where they
    agree."""
    out = {}
    for name, x, y in zip(OUTPUTS, got, want):
        x, y = x.cpu(), y.cpu()
        ok = torch.isfinite(y)
        bar = F64_TOL * max(float(y.abs()[ok].max()), 1.0)
        gap = torch.where(ok, (x - y).abs() / bar, torch.zeros_like(y))
        out[name] = float(gap.max())
    return out


def nonfinite_masks_agree(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.isfinite(x).cpu(), torch.isfinite(y).cpu())


def f32_ratios(kern, plain32, ref64):
    """Per output, the kernel's float32 gap to the float64 plain version
    over the float32 plain version's, at QUANTILES of the lanes' widest
    gaps."""
    out = {}
    for name, k, p, r in zip(OUTPUTS, kern, plain32, ref64):
        r = r.double().cpu()
        gk, gp = [(x.double().cpu() - r).reshape(r.shape[0], -1).abs()
                  .amax(1) for x in (k, p)]
        out[name] = [
            (lambda a, b: a / b if b > 0 else (0.0 if a == 0 else np.inf))(
                float(torch.quantile(gk, qq)), float(torch.quantile(gp, qq)))
            for qq in QUANTILES]
    return out


# -- CPU ------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('include_body', [True, False])
def test_dynamics_on_cpu_is_the_plain_pass_and_launches_nothing(
        dtype, include_body):
    before = cuda.counts.wb_dynamics_launches
    x = tensors(mixed(16, seed=5), dtype)
    cps = cps_of(SCALED, x[0])
    got = rnea.dynamics(*x, TCFG.plant.gravity, cps=cps,
                        include_body=include_body)
    assert cuda.counts.wb_dynamics_launches == before
    n_pts = 8 + (rnea.N_BODY_POINTS if include_body else 0)
    assert [tuple(t.shape) for t in got] == [
        (16, 16, 16), (16, 16), (16, n_pts, 3), (16, n_pts, 3),
        (16, n_pts, 3, 16)]
    assert_same(got, plain(*x, cps=cps, include_body=include_body))


def test_dynamics_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        rnea.dynamics_cuda(*tensors(mixed(4, seed=1), torch.float32),
                           TCFG.plant.gravity)


def test_wb_dynamics_launches_is_a_graph_counter():
    """In the registry the benchmark reads, and moved by a captured step
    once a call, over every run of the step."""
    names = [name for _, name in graph.kernel_counters()]
    assert (cuda.counts, 'wb_dynamics_launches') in graph.kernel_counters()
    assert len(set(names)) == len(names)

    def step(state, inputs, i):
        cuda.counts.add('wb_dynamics_launches')
        new = state + inputs.index_select(1, i).squeeze(1)
        return new, new

    steps = graph.StepGraph(step, 4)
    before = cuda.counts.wb_dynamics_launches
    final, _ = steps(torch.zeros((2, 3)), torch.ones((2, 4, 3)))
    assert cuda.counts.wb_dynamics_launches - before == 4
    steps(final, torch.ones((2, 4, 3)))
    assert cuda.counts.wb_dynamics_launches - before == 8


# -- the host build of the kernel ---------------------------------------


def _host_source():
    """wb_dynamics.cu with its kernel launch rewritten for the stand-in."""
    src = cuda.WB.source.read_text()
    src, n = re.subn(r'(\w+<\w+>)<<<(.+?)>>>\(',
                     lambda m: f'host_launch({m.group(1)}, {m.group(2)}, ',
                     src, flags=re.S)
    assert n == 1 and '<<<' not in src and 'asm' not in src
    return src


@pytest.fixture(scope='module')
def wb_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build the host stand-in')
    out = tmp_path_factory.mktemp('wb_host')
    cpp = out / 'wb_host.cpp'
    cpp.write_text(_host_source())
    so = out / 'libwb_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-pthread', f'-I{SHIM}', '-o', str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.wb_dynamics.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.wb_dynamics.restype = ctypes.c_int
    return lib


def host_dynamics(lib, pos, quat, q, v, w, qd, cps=None, include_body=True):
    args, prm, out = rnea.dynamics_launch_args(
        pos, quat, q, v, w, qd, TCFG.plant.gravity, cps, include_body)
    assert lib.wb_dynamics(int(pos.dtype == torch.float64),
                           ctypes.byref(args), ctypes.byref(prm), None) == 0
    return out


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('include_body,ccfg', [
    (True, WB.ContactConfig()), (True, SCALED), (False, WB.ContactConfig())],
    ids=['body', 'body-scaled', 'toes'])
def test_host_kernel_float64_matches_plain(wb_lib, kind, include_body, ccfg):
    x = tensors(states(24, seed=11 + KINDS.index(kind), kind=kind),
                torch.float64)
    cps = cps_of(ccfg, x[0])
    got = host_dynamics(wb_lib, *x, cps=cps, include_body=include_body)
    want = plain(*x, cps=cps, include_body=include_body)
    nonfinite_masks_agree(got, want)
    excess = f64_excess(got, want)
    assert all(e <= 1.0 for e in excess.values()), excess


@pytest.mark.parametrize('ccfg', [WB.ContactConfig(), SCALED],
                         ids=['default', 'scaled'])
def test_host_kernel_float32_within_twice_plain(wb_lib, ccfg):
    d = mixed(512, seed=23)
    x64, x32 = tensors(d, torch.float64), tensors(d, torch.float32)
    ref = plain(*x64, cps=cps_of(ccfg, x64[0]))
    cps = cps_of(ccfg, x32[0])
    kern = host_dynamics(wb_lib, *x32, cps=cps)
    nonfinite_masks_agree(kern, ref)
    ratios = f32_ratios(kern, plain(*x32, cps=cps), ref)
    assert all(r <= F32_FACTOR for rs in ratios.values() for r in rs), ratios


@pytest.mark.parametrize('what,index', [
    (0, (3, 0)), (1, (5, 2)), (2, (7, 1, 3)), (4, (9, 1)), (5, (11, 0, 4))],
    ids=['position', 'quat', 'q', 'omega', 'qd'])
def test_host_kernel_nan_lane_matches_plain(wb_lib, what, index):
    """A lane with a NaN in the trunk position, the quaternion, a joint
    angle, a trunk rate or a joint rate: NaN where the plain pass has it,
    the rest within the float64 bar."""
    x = tensors(mixed(16, seed=31), torch.float64)
    x[what][index] = float('nan')
    got, want = host_dynamics(wb_lib, *x), plain(*x)
    nonfinite_masks_agree(got, want)
    assert all(e <= 1.0 for e in f64_excess(got, want).values())
    assert not torch.isfinite(got[1][index[0]]).all()


def test_host_kernel_takes_strided_and_broadcast_inputs(wb_lib):
    """Inputs handed as views (a lane stride of a larger state, the legs
    and joints transposed in memory, one lane broadcast over the batch, the
    contact offsets transposed) give what contiguous copies give, bit for
    bit, and nothing of a view is written."""
    x = tensors(mixed(12, seed=3), torch.float64)
    cps = cps_of(SCALED, x[0])
    want = host_dynamics(wb_lib, *x, cps=cps)
    assert all(e <= 1.0 for e in f64_excess(want, plain(*x, cps=cps))
               .values())
    views = []
    for t in x:
        wide = torch.zeros((t.shape[0], 3) + t.shape[1:], dtype=t.dtype)
        wide[:, 1] = t
        views.append(wide[:, 1])
    views[2] = x[2].transpose(1, 2).contiguous().transpose(1, 2)
    views[5] = x[5].transpose(1, 2).contiguous().transpose(1, 2)
    cps_view = cps.t().contiguous().t()
    keep = [v.clone() for v in views]
    assert not any(v.is_contiguous() for v in views)
    assert_same(host_dynamics(wb_lib, *views, cps=cps_view), want)
    assert_same(views, keep)
    # one lane's state broadcast over eight lanes
    one = [t[4:5].expand((8,) + t.shape[1:]) for t in x]
    got = host_dynamics(wb_lib, *one, cps=cps)
    for a, b in zip(got, want):
        assert torch.equal(a, b[4:5].expand_as(a))


def test_dynamics_launch_args_refuse_what_the_kernel_does_not_take():
    x = tensors(mixed(8, seed=2), torch.float32)
    g = TCFG.plant.gravity
    for bad in (torch.float16, torch.int32):
        with pytest.raises(TypeError, match='float32 or float64'):
            rnea.dynamics_launch_args(*[t.to(bad) for t in x], g)
    mixed_dtype = list(x)
    mixed_dtype[3] = x[3].double()
    with pytest.raises(TypeError, match='v_world must be torch.float32'):
        rnea.dynamics_launch_args(*mixed_dtype, g)
    with pytest.raises(ValueError, match=r'position must be \(B, 3\)'):
        rnea.dynamics_launch_args(x[0][None], *x[1:], g)
    for k, shape in ((1, (8, 3)), (2, (8, 10)), (5, (8, 2, 6)), (4, (7, 3)),
                     (2, (2, 8, 2, 5))):
        bad = list(x)
        bad[k] = torch.zeros(shape)
        with pytest.raises(ValueError, match='has shape'):
            rnea.dynamics_launch_args(*bad, g)
    with pytest.raises(ValueError, match=r'cps has shape \(3, 3\)'):
        rnea.dynamics_launch_args(*x, g, cps=torch.zeros((3, 3)))
    with pytest.raises(TypeError, match='cps must be torch.float32'):
        rnea.dynamics_launch_args(*x, g, cps=torch.zeros((4, 3),
                                                         dtype=torch.float64))
    with pytest.raises(TypeError, match='quat must be a tensor'):
        rnea.dynamics_launch_args(x[0], x[1].numpy(), *x[2:], g)


def test_host_kernel_takes_an_empty_batch(wb_lib):
    x = [torch.zeros((0,) + t.shape[1:]) for t in
         tensors(mixed(4, seed=1), torch.float32)]
    out = host_dynamics(wb_lib, *x)
    assert [tuple(t.shape) for t in out] == [
        (0, 16, 16), (0, 16), (0, 18, 3), (0, 18, 3), (0, 18, 3, 16)]


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')


@pytest.mark.card
@pytest.mark.parametrize('include_body,ccfg', [
    (True, WB.ContactConfig()), (True, SCALED), (False, WB.ContactConfig())],
    ids=['body', 'body-scaled', 'toes'])
def test_card_kernel_matches_plain(card, include_body, ccfg):
    """The terms of 1,024 lanes of every kind, float64 and float32, one
    launch each, against the plain pass on the card."""
    d = mixed(1024, seed=101)
    x64 = tensors(d, torch.float64, card)
    cps = cps_of(ccfg, x64[0])
    before = cuda.counts.wb_dynamics_launches
    got = rnea.dynamics(*x64, TCFG.plant.gravity, cps=cps,
                        include_body=include_body)
    assert cuda.counts.wb_dynamics_launches == before + 1
    ref = plain(*x64, cps=cps, include_body=include_body)
    nonfinite_masks_agree(got, ref)
    excess = f64_excess(got, ref)
    assert all(e <= 1.0 for e in excess.values()), excess
    x32 = tensors(d, torch.float32, card)
    cps = cps_of(ccfg, x32[0])
    kern = rnea.dynamics(*x32, TCFG.plant.gravity, cps=cps,
                         include_body=include_body)
    assert cuda.counts.wb_dynamics_launches == before + 2
    nonfinite_masks_agree(kern, ref)
    ratios = f32_ratios(kern, plain(*x32, cps=cps,
                                    include_body=include_body), ref)
    assert all(r <= F32_FACTOR for rs in ratios.values() for r in rs), ratios


@pytest.mark.card
def test_card_captured_rollout_launches_the_kernel(card):
    """A captured 20-period tier-2 rollout at 1,024 lanes, half walking and
    half standing: 20 launches a period (5 ticks of 4 substeps), the
    plant's outputs finite and no 16x16 solve failed."""
    n, periods = 1024, 20
    roll = TRT.make_rollout_whole_body(periods, TCFG)
    plant = WB.init_whole_body_state(0.545, n, device=card)
    cmd = TRT.concat(TRT.walking_command(n // 2, vx=0.3, device=card),
                     TRT.standing_command(n - n // 2, device=card))
    failed_before = WB.solve_counts(card)[1]
    before = cuda.counts.wb_dynamics_launches
    carry = roll.init(plant)
    for _ in range(2):
        carry, plant, _ = roll(carry, plant, cmd)
    per_period = 4 * TCFG.mpc.mpc_cadence
    assert cuda.counts.wb_dynamics_launches - before == 2 * per_period * periods
    assert len(roll.graphed.captures) == 1
    for t in plant:
        if t.is_floating_point():
            assert torch.isfinite(t).all()
    assert WB.solve_counts(card)[1] == failed_before


@pytest.mark.parametrize('n_substeps', [4, 2])
def test_tier2_rollout_keeps_its_substeps(n_substeps):
    """The rollout names the substeps a tick it passes to WB.step: the
    dynamics launches a tick that a launch count on the card expects."""
    kw = {} if n_substeps == 4 else dict(n_substeps=n_substeps)
    assert TRT.make_rollout_whole_body(1, TCFG, **kw).n_substeps == n_substeps
