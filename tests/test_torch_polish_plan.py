"""The qpOASES-parity deployment (``cardbench/configs/hector-h10-polish.json``):
the port's planning step with the active-set polish on, held to the plain
reference's certified optimum, and the polish's counters.

On the CPU, ``runtime.plan_step_fn`` runs the configuration's solver
settings under ``'riccati_pallas'``, so that CPU tensors take the kernel's
own algorithm (``fused_riccati.solve_parts_plain``), on a seeded draw of the
benchmark's planning lanes (``cardbench.yardstick.scenarios``), a quarter of
them standing.  ``cardbench.reference.tick.controller_tick`` solves
SolverMPC.cpp's condensed QP of each lane in float64 to a KKT certificate:
the optimum qpOASES returns.  No JAX here, so that the card tests run on a
machine without it:

    python -m pytest --noconftest tests/test_torch_polish_plan.py -m card
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from cardbench.reference import tick as R
from cardbench.reference.config import DEFAULT_CONFIG as REF_CONFIG
from cardbench.yardstick import compare, scenarios as S
from hector_torch import cuda, graph
from hector_torch import runtime as RT
from hector_torch.config import DEFAULT_CONFIG
from hector_torch.qp import fused_riccati as FR

CONFIG = json.loads((Path(__file__).resolve().parents[1] / 'cardbench'
                     / 'configs' / 'hector-h10-polish.json').read_text())
SEED = 2**31 + 2_021
BATCH = 64
P_STANDING = 0.25
# The configuration's guarantee and the project's north star: forces within
# 1e-3 N of qpOASES's optimum.  The polish lands within ~2e-4 N of it in
# float32 on the operating envelope (hector_torch/config.py SolverConfig,
# tests/test_qpoases_parity.py), so 1e-3 N holds on every lane in both
# dtypes with room for float32's rounding; the torques are J^T f of the same
# forces through leg Jacobians of norm under 1, so the same bar in N m.
TOL = 1e-3


def solver_cfg(**changes):
    """The configuration, its solver under ``'riccati_pallas'`` unless
    ``changes`` say otherwise."""
    cfg = compare.port_config(DEFAULT_CONFIG, CONFIG)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **{'backend': 'riccati_pallas', **changes}))


def lanes(dtype, device='cpu', batch=BATCH, seed=SEED):
    g = S.generator(seed, 0, device)
    carry, plant = S.moving_state(g, batch, dtype, device)
    cmd = S.commands(g, batch, P_STANDING, dtype, device)
    return carry, plant, cmd


@pytest.fixture(scope='module', params=[torch.float64, torch.float32],
                ids=['float64', 'float32'])
def planned(request):
    """(program's output with the polish, without it, the reference) on
    one draw of lanes in the parametrised dtype."""
    torch.set_num_threads(1)
    dtype = request.param
    carry, plant, cmd = lanes(dtype)
    cfg = solver_cfg()
    state = compare.port_state(carry, plant, cfg)
    pcmd = compare.port_command(cmd)
    out = RT.plan_step_fn(cfg)(*state, pcmd)
    off = RT.plan_step_fn(solver_cfg(polish_rounds=0))(*state, pcmd)
    ref_cfg = compare.port_config(REF_CONFIG, CONFIG)
    ref = R.controller_tick(*S.from_port(*state, torch.float64),
                            S.cast_tree(cmd, torch.float64), True, ref_cfg)
    return out, off, ref


def gaps(out, ref):
    """Each lane's widest wrench gap (N) and torque gap (N m)."""
    _, wrench, motor = out
    w = (wrench.double() - ref.wrench).abs().flatten(1).amax(1)
    t = (motor.tau.double() - ref.motor.tau).abs().flatten(1).amax(1)
    return w, t


def test_draw_holds_standing_lanes_and_certified_optima(planned):
    *_, ref = planned
    assert bool(ref.certified.all())
    _, _, cmd = lanes(torch.float64)
    standing = int((cmd.gait_durations[:, 0] == 10).sum())
    assert 8 <= standing <= BATCH - 8


def test_polished_plan_within_tolerance_of_the_optimum(planned):
    out, _, ref = planned
    w, t = gaps(out, ref)
    assert torch.isfinite(w).all() and torch.isfinite(t).all()
    assert float(w.max()) <= TOL, f'widest wrench gap {float(w.max())} N'
    assert float(t.max()) <= TOL, f'widest torque gap {float(t.max())} N m'


def test_polish_off_reads_wider(planned):
    """The 14-iteration interior point alone stops short of the optimum:
    the same lanes without the polish read at least ten times wider at the
    widest lane (float64: 8.5e-5 against 2.6e-8 N; float32: 8.0e-3 against
    1.0e-4 N), and in float32, the precision the card runs, they fail the
    bar.  So a run that skips the polish cannot pass the test above in
    float32, nor this one in either dtype."""
    out, off, ref = planned
    w_on, _ = gaps(out, ref)
    w_off, _ = gaps(off, ref)
    assert float(w_off.max()) > 10 * float(w_on.max())
    if out[1].dtype == torch.float32:
        assert float(w_off.max()) > TOL


def test_tick_equal(planned):
    (carry, _, _), (carry_off, _, _), ref = planned
    assert bool((carry.tick == ref.carry.tick).all())
    assert bool((carry_off.tick == ref.carry.tick).all())


def test_plain_version_moves_no_polish_counter():
    before = (cuda.counts.polish_launches, FR.polish_counts())
    carry, plant, cmd = lanes(torch.float32, batch=4)
    cfg = solver_cfg()
    RT.plan_step_fn(cfg)(*compare.port_state(carry, plant, cfg),
                         compare.port_command(cmd))
    assert (cuda.counts.polish_launches, FR.polish_counts()) == before


def test_only_the_kernel_with_polish_counts_lanes():
    """Both device counts are moved by lane 0 of a warp inside the
    polish's ``if constexpr``, once a lane, and read back by one entry
    point; ``<false>`` neither carries nor touches them."""
    src = (Path(FR.__file__).resolve().parents[1] / 'csrc'
           / 'fused_riccati_warp.cu').read_text()
    body = src[src.index('  if (lane == 0) {\n    if constexpr (!POLISH)'):]
    body = body[:body.index('\n  }\n')]
    assert ('    if constexpr (POLISH) {\n'
            '      atomicAdd(&g_polish_counts[0], 1ull);\n'
            '      if (!pol_ok) atomicAdd(&g_polish_counts[1], 1ull);\n'
            '    }') in body
    assert src.count('atomicAdd(&g_polish_counts') == 2


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')


def caught_qps(card, batch, seed=SEED, **changes):
    """The stage QPs of one eager planning step of the configuration on
    ``batch`` lanes of the benchmark's planning draw (10 % standing, as
    the mix plan-32k), caught at the fused solver's entry: (parts, solver
    settings, q_diag, r_diag)."""
    g = S.generator(seed, 0, card)
    carry, plant = S.moving_state(g, batch, torch.float32, card)
    cmd = S.commands(g, batch, 0.1, torch.float32, card)
    cfg = solver_cfg(**changes)
    caught = []
    solve = FR.solve_parts

    def catch(parts, scfg, q_diag, r_diag):
        caught.append((parts, scfg, q_diag, r_diag))
        return solve(parts, scfg, q_diag, r_diag)
    FR.solve_parts = catch
    try:
        RT.plan_step_fn(cfg)(*compare.port_state(carry, plant, cfg),
                             compare.port_command(cmd))
    finally:
        FR.solve_parts = solve
    (qps,) = caught
    return qps


@pytest.mark.card
def test_card_forced_rejection_counts_every_lane(card):
    """polish_tol = -1: the merit is never that small, so every lane keeps
    the interior point's iterate, and the kernel counts each of them."""
    parts, scfg, q_diag, r_diag = caught_qps(card, 4096)
    scfg = dataclasses.replace(scfg, polish_tol=-1.0)
    before = (*FR.polish_counts(card), cuda.counts.polish_launches)
    for _ in range(2):
        FR.solve_parts(parts, scfg, q_diag, r_diag)
    after = (*FR.polish_counts(card), cuda.counts.polish_launches)
    assert [a - b for a, b in zip(after, before)] == [2 * 4096, 2 * 4096, 2]


# The kernel in float32 may reject a lane that the plain version in float64
# accepts, where the round's merit lies near its 1e-5 threshold; chip_smoke.py
# lets the kernel and the plain version disagree on acceptance on up to 1 %
# of the lanes (POLISH_SAME_SET), and so does this margin.
REJECT_MARGIN = 0.01


@pytest.mark.card
def test_card_rejections_on_the_mix_within_the_plain_float64_ones(card):
    """On 32,768 lanes of the mix plan-32k the kernel rejects no more lanes
    than the plain version rejects in float64 on the same QPs, plus the
    margin; a lane is rejected by the plain version where its answer is
    the forced-rejection answer bit for bit."""
    batch = 32768
    parts, scfg, q_diag, r_diag = caught_qps(card, batch)
    before = FR.polish_counts(card)
    FR.solve_parts(parts, scfg, q_diag, r_diag)
    after = FR.polish_counts(card)
    assert after[0] - before[0] == batch
    kernel = after[1] - before[1]
    parts64 = type(parts)(*[t.double() for t in parts])
    sol = FR.solve_parts_plain(parts64, scfg, q_diag, r_diag)
    forced = FR.solve_parts_plain(
        parts64, dataclasses.replace(scfg, polish_tol=-1.0), q_diag, r_diag)
    plain = int((sol.u == forced.u).all(1).sum())
    print(f'rejected of {batch}: kernel {kernel}, plain float64 {plain}')
    assert kernel <= plain + REJECT_MARGIN * batch


@pytest.mark.card
def test_card_replayed_step_carries_the_polish_counters(card):
    """A captured planning step replayed: the kernel's count of lanes
    polished moves by the batch at every replay, and with every lane forced
    to reject, its count of rejections by the same; the launch counter
    leaves the capture's warm-up out, the kernel's counts do not."""
    batch, n_steps, calls = 1024, 3, 2
    g = S.generator(SEED, 0, card)
    carry, plant = S.moving_state(g, batch, torch.float32, card)
    cmd = compare.port_command(S.commands(g, batch, 0.1, torch.float32,
                                          card))
    cfg = solver_cfg(backend='auto', polish_tol=-1.0)
    plan = RT.plan_step_fn(cfg)

    def step(state, cmd, i):
        carry, wrench, _ = plan(*state, cmd)
        return (carry, state[1]), wrench

    steps = graph.StepGraph(step, n_steps)
    state = compare.port_state(carry, plant, cfg)
    steps(state, cmd)   # captures; its warm-up launches the kernel
    assert len(steps.captures) == 1
    before = (*FR.polish_counts(card), cuda.counts.polish_launches)
    for _ in range(calls):
        steps(state, cmd)
    after = (*FR.polish_counts(card), cuda.counts.polish_launches)
    replays = n_steps * calls
    assert [a - b for a, b in zip(after, before)] == [
        replays * batch, replays * batch, replays]
    assert len(steps.captures) == 1
