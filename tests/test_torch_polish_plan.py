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

The kernel's re-solves on saved factors are also checked here on the CPU:
g++ builds ``csrc/fused_riccati_warp.cu`` against
``tests/host_cuda/cuda_runtime.h`` (a warp's lanes as std::threads, its
shuffles and votes through a shared buffer) twice, as it is and with every
polish step forced to a full sweep, and the wrapper's own launch, sent to
the host build, must give the same bits from both.
"""

import ctypes
import dataclasses
import importlib.util
import json
import shutil
import subprocess
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

SHIM = Path(__file__).resolve().parent / 'host_cuda'
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


def kernel_source():
    return (Path(FR.__file__).resolve().parents[1] / 'csrc'
            / 'fused_riccati_warp.cu').read_text()


def test_only_the_kernel_with_polish_counts_lanes():
    """Both device counts are moved by lane 0 of a warp inside the
    polish's ``if constexpr``, once a lane, and read back by one entry
    point; ``<false>`` neither carries nor touches them."""
    src = kernel_source()
    body = src[src.index('  if (lane == 0) {\n    if constexpr (!POLISH)'):]
    body = body[:body.index('\n  }\n')]
    assert ('    if constexpr (POLISH) {\n'
            '      atomicAdd(&g_polish_counts[0], 1ull);\n'
            '      if (!pol_ok) atomicAdd(&g_polish_counts[1], 1ull);\n'
            '    }') in body
    assert src.count('atomicAdd(&g_polish_counts') == 2


def test_only_the_kernel_with_polish_counts_steps():
    """The counts of polish steps and re-solves sit in their own device
    array beside the lane counts, moved once a warp by lane 0 inside the
    polish's ``if constexpr`` and read back by their own entry point; the
    re-solve itself, and every write of the scratch, only <true> compiles."""
    src = kernel_source()
    assert src.count('atomicAdd(&g_polish_steps') == 2
    body = src[src.index('  if (lane == 0) {\n    if constexpr (!POLISH)'):]
    body = body[:body.index('\n  }\n')]
    assert ('    if constexpr (POLISH) {  // every warp runs all n_pol polish '
            'steps\n'
            '      atomicAdd(&g_polish_steps[0], '
            'static_cast<unsigned long long>(n_pol));\n'
            '      atomicAdd(&g_polish_steps[1], '
            'static_cast<unsigned long long>(act >> A_COUNT));\n'
            '    }') in body
    assert 'cudaMemcpyFromSymbol(out, g_polish_steps' in src
    # the sweep reads and writes the scratch only in <true>: each use of
    # fk sits in a block that opens with if constexpr (POLISH), or in the
    # else branch that only <true> compiles; its other tests of the sweep
    # fold to true in <false>'s front end
    newton = src[src.index('__device__ void newton_dir('):]
    newton = newton[:newton.index('\n}\n')]
    assert newton.count('fk + ') == 4
    assert newton.count('if constexpr (POLISH)') == 4
    assert '} else if constexpr (POLISH) {' in newton
    assert ('#define MATRIX_HALF (!POLISH || warp_sweep[threadIdx.x >> 5] '
            '!= SWEEP_RESOLVE)') in newton
    # the kernel passes the <false> launch no scratch
    assert 'batch, *params, nullptr, st);' in src


def test_wrapper_allocates_the_scratch_for_the_polish_only(monkeypatch):
    """polish_rounds > 0: FACTOR_FLOATS floats a scenario of scratch
    (the kernel's FACTOR_FLOATS), whose pointer goes after the parameters;
    polish_rounds = 0: a null pointer there, and nothing allocated."""
    src = kernel_source()
    assert 'constexpr int FACTOR_STAGE = NU * NU + NX * NU;' in src
    assert 'constexpr int FACTOR_FLOATS = H * FACTOR_STAGE;' in src
    assert FR.FACTOR_FLOATS == FR.H * (FR.NU * FR.NU + FR.NX * FR.NU) == 3000
    parts, scfg, q_diag, r_diag = caught_qps(torch.device('cpu'), 3)
    launched = []

    class Stub:
        def launch(self, entry, device, *args, counted=()):
            launched.append((entry, args, counted))

    allocated = []
    empty = torch.empty

    def spy(*shape, **kw):
        allocated.append(tuple(shape[0] if len(shape) == 1 else shape))
        return empty(*shape, **kw)
    monkeypatch.setattr(FR, 'check_parts', lambda parts: None)
    monkeypatch.setattr(FR, 'FUSED', Stub())
    monkeypatch.setattr(FR.torch, 'empty', spy)
    FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)
    FR.solve_parts_cuda(parts, dataclasses.replace(scfg, polish_rounds=0),
                        q_diag, r_diag)
    (e1, a1, c1), (e2, a2, c2) = launched
    assert e1 == e2 == 'fused_riccati_warp_solve'
    assert (c1, c2) == (('polish_launches',), ('launches',))
    assert len(a1) == len(a2) == 14
    assert isinstance(a1[13], int) and a1[13] != 0 and a2[13] is None
    assert allocated.count((3, FR.FACTOR_FLOATS)) == 1
    assert len(allocated) == 5


def test_polish_reuse_metric_reads_the_step_counters(monkeypatch):
    """The benchmark's polish_reuse.plan: 100 x re-solved / polish steps, as
    the kernel counts them (32,768 lanes x 8 rounds x 4 steps, of which
    every round's last three and the first of 7 rounds in 8 re-solved);
    None with no counts, or with no such function (the parent's program)."""
    path = (Path(__file__).resolve().parents[1] / 'cardbench' / 'metrics'
            / 'polish_reuse.plan.py')
    spec = importlib.util.spec_from_file_location('polish_reuse_plan', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    steps, resolved = 32768 * 8 * 4, 32768 * (8 * 3 + 7)
    monkeypatch.setattr(FR, 'polish_step_counts', lambda: (steps, resolved))
    assert mod.read(None) == pytest.approx(96.875)
    monkeypatch.setattr(FR, 'polish_step_counts', lambda: (0, 0))
    assert mod.read(None) is None
    monkeypatch.delattr(FR, 'polish_step_counts')
    assert mod.read(None) is None


# -- the kernel built for the host (g++ and tests/host_cuda) ---------------


def host_source(resolve=True):
    """The kernel's source for the host stand-in: its launch as a call of
    host_launch; with ``resolve=False`` the saved factors never trusted, so
    every polish step a full sweep."""
    src = kernel_source()
    launch = ('fused_riccati_warp_kernel<POLISH><<<grid, THREADS, '
              'FR_EXTRA_SMEM, stream>>>(')
    assert src.count(launch) == 1
    src = src.replace(launch, 'host_launch(fused_riccati_warp_kernel<POLISH>, '
                      'grid, THREADS, FR_EXTRA_SMEM, stream, ')
    if not resolve:
        same = 'act = fin ? (act | A_SAME) : (act & ~A_SAME);'
        assert src.count(same) == 1
        src = src.replace(same, 'act &= ~A_SAME;')
    assert '<<<' not in src and 'asm' not in src
    return src


@pytest.fixture(scope='module')
def host_libs(tmp_path_factory):
    """The kernel built with g++ for the host, with its re-solves and
    without: {'resolve': lib, 'full': lib}."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build the host stand-in')
    out = tmp_path_factory.mktemp('fused_host')
    libs = {}
    for name in ('resolve', 'full'):
        cpp = out / f'fused_{name}.cpp'
        cpp.write_text(host_source(name == 'resolve'))
        so = out / f'libfused_{name}.so'
        subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off',
                        '-shared', '-fPIC', '-pthread', f'-I{SHIM}', '-o',
                        str(so), str(cpp)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for entry, (argtypes, restype) in cuda.FUSED.entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        libs[name] = lib
    return libs


def host_solve(monkeypatch, lib, parts, scfg, q_diag, r_diag):
    """``solve_parts_cuda`` on CPU tensors, its launch run by the host
    build: (solution, the change in (polish steps, re-solves))."""
    class HostFused:
        def launch(self, entry, device, *args, counted=()):
            assert getattr(lib, entry)(*args, None) == 0

    def steps():
        out = (ctypes.c_ulonglong * 2)()
        assert lib.fused_riccati_warp_polish_steps(out) == 0
        return out[0], out[1]
    with monkeypatch.context() as m:
        m.setattr(FR, 'check_parts', lambda parts: None)
        m.setattr(FR, 'FUSED', HostFused())
        before = steps()
        sol = FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)
        after = steps()
    return sol, (after[0] - before[0], after[1] - before[1])


HOST_BATCH = 5      # three blocks, the third with one warp


@pytest.fixture(scope='module')
def host_qps():
    torch.set_num_threads(1)
    return caught_qps(torch.device('cpu'), HOST_BATCH, seed=SEED + 7)


# the configuration; one solve a round; one polish step; every lane
# rejected; and the interior point cut to 6 iterations, where the first
# active sets are rough and change at round ends (on these lanes they do
# not under the configuration's 14)
@pytest.mark.parametrize('rounds,iters,changes', [
    (8, 4, {}), (2, 1, {}), (1, 1, {}), (2, 4, {'polish_tol': -1.0}),
    (8, 4, {'iterations': 6})],
    ids=['config', 'one-iter', 'one-step', 'rejected', 'short-ip'])
def test_host_resolves_are_the_full_sweeps_bit_for_bit(
        monkeypatch, host_libs, host_qps, rounds, iters, changes):
    """Every output of the kernel that re-solves on saved factors is the
    bits of the one that runs every polish step's full sweep; each counts
    rounds x iters polish steps a lane, the first re-solves at least
    iters - 1 of each round's, the second none."""
    parts, scfg, q_diag, r_diag = host_qps
    scfg = dataclasses.replace(scfg, polish_rounds=rounds,
                               polish_iters=iters, **changes)
    sol_r, (steps_r, re_r) = host_solve(monkeypatch, host_libs['resolve'],
                                        parts, scfg, q_diag, r_diag)
    sol_f, (steps_f, re_f) = host_solve(monkeypatch, host_libs['full'],
                                        parts, scfg, q_diag, r_diag)
    assert torch.isfinite(sol_r.u).all()
    for a, b in zip(sol_r, sol_f):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert steps_r == steps_f == HOST_BATCH * rounds * iters
    assert re_f == 0
    assert HOST_BATCH * rounds * (iters - 1) <= re_r < steps_r
    if rounds * iters == 1:
        assert re_r == 0


def test_host_polish_holds_to_the_plain_version(monkeypatch, host_libs,
                                                host_qps):
    """The host build against the plain version in float32 on the same QPs,
    at the card's bar (chip_smoke.KERNEL_TOL) on every lane."""
    parts, scfg, q_diag, r_diag = host_qps
    sol, _ = host_solve(monkeypatch, host_libs['resolve'], parts, scfg,
                        q_diag, r_diag)
    plain = FR.solve_parts_plain(parts, scfg, q_diag, r_diag)
    assert float((sol.u - plain.u).abs().max()) <= 2e-4


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


@pytest.mark.card
def test_card_polish_steps_counted_and_resolved_on_the_mix(card):
    """On 32,768 lanes of the mix plan-32k the kernel counts every lane's
    rounds x iters polish steps, and re-solves at least iters - 1 of each
    round's on the factors of its first."""
    batch = 32768
    parts, scfg, q_diag, r_diag = caught_qps(card, batch)
    before = FR.polish_step_counts(card)
    FR.solve_parts(parts, scfg, q_diag, r_diag)
    after = FR.polish_step_counts(card)
    steps, resolved = after[0] - before[0], after[1] - before[1]
    print(f're-solved {resolved} of {steps} polish steps '
          f'({100 * resolved / steps:.3f} %)')
    assert steps == batch * scfg.polish_rounds * scfg.polish_iters
    assert (batch * scfg.polish_rounds * (scfg.polish_iters - 1)
            <= resolved < steps)


@pytest.mark.card
def test_card_one_polish_step_resolves_nothing(card):
    batch = 4096
    parts, scfg, q_diag, r_diag = caught_qps(card, batch, polish_rounds=1,
                                             polish_iters=1)
    before = FR.polish_step_counts(card)
    FR.solve_parts(parts, scfg, q_diag, r_diag)
    after = FR.polish_step_counts(card)
    assert (after[0] - before[0], after[1] - before[1]) == (batch, 0)


@pytest.mark.card
@pytest.mark.parametrize('iters', [1, 4])
def test_card_polish_holds_to_the_plain_version(card, iters):
    """chip_smoke.hold_polish with polish_iters 1 and 4 on the 4,096
    closed-loop QPs chip_smoke.py holds the polish to: as configured and
    with every lane forced to reject (polish_tol = -1), lanes both sides
    accept and every rejected lane within 2e-4 N of the plain version."""
    import chip_smoke as CS
    _, scfg, q_diag, r_diag = caught_qps(card, 32, polish_iters=iters)
    parts = CS.scenario_parts(4096, 8, card)
    CS.hold_polish((FR.solve_parts_cuda, parts, q_diag, r_diag),
                   (FR.solve_parts_plain, parts, q_diag, r_diag), scfg,
                   f'polish_iters={iters}')


@pytest.mark.card
@pytest.mark.parametrize('changes', [{'polish_iters': 1}, {},
                                     {'polish_tol': -1.0}],
                         ids=['one-iter', 'config', 'rejected'])
def test_card_polish_on_the_mix_shows_the_known_faults(card, changes):
    """The same hold on 4,096 lanes of the mix plan-32k fails, for this
    kernel as for one that runs every polish step's full sweep.

    As configured (ROADMAP C.8), the round's merit takes the primal
    violation and the multipliers' signs but no dual residual, so an
    iterate that has not converged passes it, and the float32 kernel and
    the plain version keep different iterates.  With every lane forced to
    reject (ROADMAP C.7), the kernel's interior point without freeze is
    wrong on a lane where both plain versions agree.  Readings on an H100
    at SEED, against the plain version in float32 (float64 in brackets):
    one-iter, lanes both accept up to 17.5 N apart (the kernel 10.0 N and
    the plain float32 version 7.5 N from float64); config, one lane
    0.0128 N apart, every lane both accept within 1.8e-4 N (the kernel
    4e-5 N from float64 there); rejected, 0.744 N (the kernel 0.745 N from
    float64, the plain float32 version 1.4e-4 N).  The test expects the
    hold to raise, so the faults stay in view; once they are repaired it
    fails, and the mix joins test_card_polish_holds_to_the_plain_version."""
    import chip_smoke as CS
    parts, scfg, q_diag, r_diag = caught_qps(card, 4096, **changes)
    with pytest.raises(RuntimeError, match=' N > '):
        CS.hold_polish((FR.solve_parts_cuda, parts, q_diag, r_diag),
                       (FR.solve_parts_plain, parts, q_diag, r_diag), scfg,
                       f'mix, {changes}')


@pytest.fixture(scope='module')
def full_sweep_lib(tmp_path_factory):
    """The kernel built on the card with the saved factors never trusted
    (every polish step a full sweep), as host_source(resolve=False)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    same = 'act = fin ? (act | A_SAME) : (act & ~A_SAME);'
    src = kernel_source()
    assert src.count(same) == 1
    path = tmp_path_factory.mktemp('fused_full') / cuda.FUSED.source.name
    path.write_text(src.replace(same, 'act &= ~A_SAME;'))
    entries = {k: v for k, v in cuda.FUSED.entries.items()
               if k != cuda.FUSED.error_string}
    return cuda.Library(path, cuda.FUSED.flags, cuda.FUSED.error_string,
                        entries).load()


@pytest.mark.card
@pytest.mark.parametrize('changes', [{}, {'polish_iters': 1},
                                     {'polish_tol': -1.0},
                                     {'iterations': 6}],
                         ids=['config', 'one-iter', 'rejected', 'short-ip'])
def test_card_resolves_are_the_full_sweeps_bit_for_bit(card, full_sweep_lib,
                                                       changes):
    """On 32,768 lanes of the mix, every output of the kernel is the bits
    of the build that runs every polish step's full sweep."""
    parts, scfg, q_diag, r_diag = caught_qps(card, 32768, **changes)
    got = FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)
    installed, cuda.FUSED.handle = cuda.FUSED.handle, full_sweep_lib
    try:
        want = FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)
    finally:
        cuda.FUSED.handle = installed
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
