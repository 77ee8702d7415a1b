"""The tick's leg-data kernel (``hector_torch/csrc/srb_plant.cu``,
``tick_legs_kernel<T>``) against its plain version, the three lines of
``runtime.controller_tick`` it replaces (``kinematics.leg_data`` on CPU
tensors: ``leg_jacobians``' first output, ``foot_position`` and
``q + JOINT_OFFSETS``).

Three kinds of case, as for the plant kernel beside it:

- CPU: ``leg_data`` on CPU tensors is those lines bit for bit and launches
  nothing; the launch counter is a graph counter.
- Host build: g++ compiles the kernel's source against
  ``tests/host_cuda/cuda_runtime.h`` with ``-ffp-contract=off`` (nvcc's
  ``-fmad=false``) and runs it on CPU tensors through
  ``kinematics.legs_launch_args``: the same argument packing, strides and
  constants as on the card.
- Card (marker ``card``): the kernel built by nvcc and launched by
  ``leg_data`` on CUDA tensors, one tick's outputs and a captured
  100-period rollout.  Run where there is a card, without this
  directory's conftest (it imports JAX, which the card's machine lacks):

      python -m pytest --noconftest tests/test_torch_legs_kernel.py -m card

The seeded angles cover the joints' range and beyond (a tenth of the lanes
over +-pi), and lanes with NaN and inf in one joint each.

Tolerances.  float64: the kernel takes the plain ops in their order, so the
two agree to 1e-12 of each output's size (the rest is the library's sin and
cos; the chains are well conditioned).  float32: per lane, the widest gap of
any output to the float64 plain version; at the 50th and 90th percentile
and the widest lane the kernel's gap may be at most twice the float32 plain
version's own (the plant kernel's rule, tests/test_torch_plant_kernel.py:
both round the same operations in float32, and only the transcendentals'
last bits differ).  The non-finite mask of every output agrees exactly.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from hector_torch import constant, cuda, graph
from hector_torch import kinematics as K
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.config import JOINT_OFFSETS
from hector_torch.plant import srb

from .test_torch_plant_kernel import (F32_FACTOR, OTHER_CFG, QUANTILES,
                                      assert_f32_within, finite_lanes,
                                      host_lib, quantiles)

torch.set_num_threads(1)
F64_TOL = 1e-12

# (lane, leg, joint, value): the lanes of a batch of at least 64 that carry
# a NaN or an inf
NONFINITE = ((3, 0, 0, np.nan), (7, 1, 1, np.inf), (11, 0, 2, -np.inf),
             (13, 1, 3, np.nan), (17, 0, 4, np.inf), (19, 1, 0, -np.inf),
             (23, 0, 1, np.nan))


def angles(n, seed, nonfinite=True):
    """(n, 2, 5) seeded raw motor angles as float64 numpy, each a float32
    number (so the float32 and float64 runs see the same inputs)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.6, 0.6, (n, 2, 5))
    q[: n // 10] = rng.uniform(-4.0, 4.0, (n // 10, 2, 5))
    if nonfinite:
        for lane, leg, j, val in NONFINITE:
            if lane < n:
                q[lane, leg, j] = val
    return q.astype(np.float32).astype(np.float64)


def plain(q, cfg=TCFG):
    """The three lines of controller_tick, as the parent commit ran them."""
    j_fm, _ = K.leg_jacobians(q, cfg)
    offsets = constant('JOINT_OFFSETS', JOINT_OFFSETS, q)
    return j_fm, K.foot_position(q, cfg), q + offsets


@pytest.fixture(scope='module')
def legs_lib(host_lib):
    host_lib.tick_legs.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    host_lib.tick_legs.restype = ctypes.c_int
    return host_lib


def host_legs(lib, q, cfg=TCFG):
    args, prm, out = K.legs_launch_args(q, cfg)
    assert lib.tick_legs(int(q.dtype == torch.float64), ctypes.byref(args),
                         ctypes.byref(prm), None) == 0
    return out


def assert_same(a, b):
    """Bit for bit, NaN where NaN."""
    for x, y in zip(a, b):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def nonfinite_masks_agree(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.isfinite(x).cpu(), torch.isfinite(y).cpu())


def f64_excess(got, want):
    """The largest gap over its bar, 1e-12 of the output's size (max(|want|,
    1) over the finite entries): at most 1 where they agree."""
    out = 0.0
    for x, y in zip(got, want):
        x, y = x.cpu(), y.cpu()
        ok = torch.isfinite(y)
        bar = F64_TOL * max(float(y.abs()[ok].max()), 1.0)
        gap = torch.where(ok, (x - y).abs() / bar, torch.zeros_like(y))
        out = max(out, float(gap.max()))
    return out


def lane_gaps(a, ref):
    """(B,) the widest gap of any finite output entry of a lane."""
    cols = [(x.double().cpu() - y.double().cpu()).reshape(x.shape[0], -1)
            for x, y in zip(a, ref)]
    g = torch.cat(cols, 1).abs()
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g)).amax(1)


def f32_ratios(kern, plain32, ref64, q):
    """The kernel's float32 gap over the plain float32 path's, at
    QUANTILES of the lanes whose angles are finite."""
    finite = torch.isfinite(q.reshape(q.shape[0], -1)).all(1).cpu()
    gk = quantiles(lane_gaps(kern, ref64)[finite])
    gp = quantiles(lane_gaps(plain32, ref64)[finite])
    return [k / p if p > 0 else (0.0 if k == 0 else float('inf'))
            for k, p in zip(gk, gp)]


# -- CPU ------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_leg_data_on_cpu_is_the_tick_lines_and_launches_nothing(dtype, cfg):
    before = cuda.counts.legs_launches
    q = torch.tensor(angles(64, seed=5), dtype=dtype)
    got = K.leg_data(q, cfg)
    assert cuda.counts.legs_launches == before
    assert [tuple(x.shape) for x in got] == [(64, 2, 6, 5), (64, 2, 3),
                                             (64, 2, 5)]
    assert_same(got, plain(q, cfg))


def test_leg_data_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        K.leg_data_cuda(torch.zeros((4, 2, 5)))


def test_legs_launches_is_a_graph_counter():
    names = [name for _, name in graph.kernel_counters()]
    assert (cuda.counts, 'legs_launches') in graph.kernel_counters()
    assert len(set(names)) == len(names)


# -- the host build of the kernel ---------------------------------------


@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_host_kernel_float64_matches_plain(legs_lib, cfg):
    q = torch.tensor(angles(96, seed=11), dtype=torch.float64)
    got, want = host_legs(legs_lib, q, cfg), plain(q, cfg)
    nonfinite_masks_agree(got, want)
    assert f64_excess(got, want) <= 1.0
    # the offset-corrected angles are one add, the same in both
    assert_same(got[2:], want[2:])


@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_host_kernel_float32_within_twice_plain(legs_lib, cfg):
    d = angles(2048, seed=23)
    ref = plain(torch.tensor(d, dtype=torch.float64), cfg)
    q32 = torch.tensor(d, dtype=torch.float32)
    kern, plain32 = host_legs(legs_lib, q32, cfg), plain(q32, cfg)
    nonfinite_masks_agree(kern, plain32)
    nonfinite_masks_agree(kern, ref)
    ratios = f32_ratios(kern, plain32, ref, q32)
    assert all(r <= F32_FACTOR for r in ratios), dict(zip(QUANTILES, ratios))


def test_host_kernel_reads_strided_angles(legs_lib):
    """Angles handed as views (a lane stride of a larger state, legs and
    joints transposed in memory) give what a contiguous copy gives, bit
    for bit, and nothing of the view is written."""
    q = torch.tensor(angles(40, seed=3), dtype=torch.float64)
    wide = torch.zeros((40, 3, 2, 5), dtype=torch.float64)
    wide[:, 1] = q
    every_other = torch.zeros((80, 2, 5), dtype=torch.float64)
    every_other[::2] = q
    swapped = q.transpose(1, 2).contiguous().transpose(1, 2)
    want = host_legs(legs_lib, q)
    for view in (wide[:, 1], every_other[::2], swapped):
        assert not view.is_contiguous()
        keep = view.clone()
        assert_same(host_legs(legs_lib, view), want)
        assert torch.equal(torch.nan_to_num(view), torch.nan_to_num(keep))
    assert f64_excess(want, plain(q)) <= 1.0


def test_legs_launch_args_refuse_what_the_kernel_does_not_take():
    q = torch.zeros((8, 2, 5))
    with pytest.raises(TypeError, match='float32 or float64'):
        K.legs_launch_args(q.half())
    with pytest.raises(TypeError, match='float32 or float64'):
        K.legs_launch_args(q.to(torch.int32))
    for shape in ((8, 10), (8, 2, 6), (8, 3, 5), (1, 8, 2, 5)):
        with pytest.raises(ValueError, match=r'\(B, 2, 5\)'):
            K.legs_launch_args(torch.zeros(shape))
    with pytest.raises(TypeError, match='tensor'):
        K.legs_launch_args(q.numpy())


def test_host_kernel_takes_an_empty_batch(legs_lib):
    out = host_legs(legs_lib, torch.zeros((0, 2, 5)))
    assert [tuple(x.shape) for x in out] == [(0, 2, 6, 5), (0, 2, 3),
                                             (0, 2, 5)]


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')


@pytest.mark.card
@pytest.mark.parametrize('n', [1024, 32768])
@pytest.mark.parametrize('cfg', [TCFG, OTHER_CFG], ids=['default', 'other'])
def test_card_leg_data_matches_plain(card, n, cfg):
    """One tick's three outputs, float64 and float32, one launch each."""
    d = angles(n, seed=101 + n)
    q64 = torch.tensor(d, dtype=torch.float64, device=card)
    before = cuda.counts.legs_launches
    got = K.leg_data(q64, cfg)
    assert cuda.counts.legs_launches == before + 1
    ref = plain(q64, cfg)
    nonfinite_masks_agree(got, ref)
    assert f64_excess(got, ref) <= 1.0
    q32 = q64.float()
    kern, plain32 = K.leg_data(q32, cfg), plain(q32, cfg)
    assert cuda.counts.legs_launches == before + 2
    nonfinite_masks_agree(kern, plain32)
    nonfinite_masks_agree(kern, ref)
    ratios = f32_ratios(kern, plain32, ref, q32)
    assert all(r <= F32_FACTOR for r in ratios), dict(zip(QUANTILES, ratios))


@pytest.mark.card
def test_card_captured_rollout_launches_the_kernel(card):
    """A captured 100-period rollout at 1,024 lanes under the production
    backend: 5 launches a period and at most 10 device nodes in the
    period's five ``tick.legs`` rows."""
    n, periods = 1024, 100
    cmd = TRT.walking_command(n, vx=0.4, device=card)
    plant = srb.init_plant_state(n, TCFG, device=card)
    roll = TRT.make_rollout(periods, TCFG)
    before = cuda.counts.legs_launches
    roll(roll.init(plant), plant, cmd)
    assert cuda.counts.legs_launches - before == TCFG.mpc.mpc_cadence * periods
    cap, = roll.graphed.captures.values()
    table = graph.phase_table(cap.id)
    rows = [(first, stop) for name, _, first, stop in table['phases']
            if name == 'tick.legs']
    assert len(rows) == TCFG.mpc.mpc_cadence
    nodes = sum(1 for first, stop in rows
                for kind, _ in table['nodes'][first:stop] if kind != 'other')
    assert TCFG.mpc.mpc_cadence <= nodes <= 10


@pytest.mark.card
def test_card_rollout_beside_the_plain_leg_data(card, monkeypatch):
    """The same 100 periods at 1,024 lanes with the kernel's leg data, with
    the plain leg data in float32, and with the plain leg data in float64
    as the reference (the stage solver, which takes both dtypes): the end
    states within the float32 rule."""
    n, periods = 1024, 100
    cfg = dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, backend='riccati'))
    ends = {}
    for name, dtype, legs in (('kernel', torch.float32, K.leg_data),
                              ('plain', torch.float32, plain),
                              ('ref', torch.float64, plain)):
        monkeypatch.setattr(TRT, 'leg_data', legs)
        roll = TRT.make_rollout(periods, cfg)
        plant = srb.init_plant_state(n, TCFG, dtype=dtype, device=card)
        cmd = TRT.walking_command(n, vx=0.4, dtype=dtype, device=card)
        _, end, _ = roll(roll.init(plant), plant, cmd)
        ends[name] = end
    finite = finite_lanes(ends['ref'])
    assert finite.all()
    assert_f32_within(ends['kernel'], ends['plain'], ends['ref'], finite)
