"""The port's counterpart of ``jax.jit`` over the loops
(``hector_torch/graph.py``): no host round trip in a tick, and the
static-buffer runner that the card captures as a CUDA graph, run here on
CPU tensors.

On the CPU nothing is captured: each replay runs the captured region
eagerly on the static buffers, so these tests hold the buffer logic, the
chaining, the per-step input slots and the clones out.  The card holds the
graph itself bit for bit against its eager run (``chip_smoke.py``, phase
``graph``).  The JAX-parity tests of the rollouts under
``'riccati_pallas'`` (tests/test_torch_slice.py, test_torch_robustness.py,
test_torch_estimation.py), under the stage solver ``'riccati'``
(test_torch_slice.py, and every rollout of the CPU's default ``'auto'``),
under the dense backends (test_torch_dense.py) and the bench chain
(test_torch_bench.py) run through the runner too.
"""

import collections
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hector_torch import bench, graph, prng
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.plant import srb as TSRB
from hector_torch.plant import whole_body as TWB

torch.set_num_threads(1)
CPU = torch.device('cpu')
B = 2
# the fused solver (its plain version here), what the card captures; two
# interior-point iterations are enough to run every op of the loop body
# once more than the first
FS = dataclasses.replace(TCFG, solver=dataclasses.replace(
    TCFG.solver, backend='riccati_pallas'))
FS_SHORT = dataclasses.replace(FS, solver=dataclasses.replace(
    FS.solver, iterations=2))
# the dense interior point, likewise (on CPU tensors 'dense_auto' runs the
# Cholesky kernels' plain versions through their wrappers)
DENSE_SHORT = dataclasses.replace(TCFG, solver=dataclasses.replace(
    TCFG.solver, backend='dense_auto', iterations=2))
# the Mehrotra stage solver, likewise (batched torch.linalg calls)
STAGE_SHORT = dataclasses.replace(TCFG, solver=dataclasses.replace(
    TCFG.solver, backend='riccati', iterations=2))
# ops that wait on the device or copy from the host: a Python value made a
# tensor (torch.tensor), a tensor read as a Python value, a truth test, a
# data-dependent shape
HOST_OPS = ('lift_fresh', '_local_scalar_dense', 'is_nonzero', 'nonzero')


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _keys(batch):
    return prng.fold_in(prng.PRNGKey(7, CPU), torch.arange(batch))


def _schedule(cmd, n, modes):
    cmd_t = TRT.ScenarioCommand(*[
        f[:, None].expand(f.shape[:1] + (n,) + f.shape[1:]).clone()
        for f in cmd])
    return cmd_t, torch.tensor([modes] * cmd.vx.shape[0], dtype=torch.int32)


def _push(batch, n, dtype):
    gen = torch.Generator().manual_seed(3)
    return 20.0 * torch.randn((batch, n, 6), generator=gen, dtype=dtype)


def _period_call(kind, cfg):
    """A one-period rollout call of the given kind, as a thunk."""
    cmd = TRT.walking_command(B, vx=0.5, device=CPU)
    if kind == 'whole_body':
        roll = TRT.make_rollout_whole_body(1, cfg)
        plant = TWB.init_whole_body_state(0.545, B, device=CPU)
        carry = roll.init(plant)
        return lambda: roll(carry, plant, cmd)
    plant = TSRB.init_plant_state(B, cfg, device=CPU)
    if kind == 'pushed+scheduled':
        roll = TRT.make_rollout(1, cfg, with_disturbance=True,
                                with_schedule=True)
        carry = roll.init(plant)
        push, sched = _push(B, 1, torch.float32), _schedule(cmd, 1, [0])
        return lambda: roll(carry, plant, cmd, push, sched)
    roll = TRT.make_rollout(1, cfg, estimator=kind)
    carry = roll.init(plant, _keys(B))
    return lambda: roll(carry, plant, cmd)


PLAN_CFGS = {'plan_step': FS_SHORT,
             'plan_step_polish': dataclasses.replace(
                 FS_SHORT, solver=dataclasses.replace(
                     FS_SHORT.solver, polish_rounds=1, polish_iters=1)),
             'plan_step_dense': DENSE_SHORT,
             'plan_step_stage': STAGE_SHORT,
             'plan_step_stage_polish': dataclasses.replace(
                 STAGE_SHORT, solver=dataclasses.replace(
                     STAGE_SHORT.solver, polish_rounds=1, polish_iters=1))}
PERIOD_CFGS = {'dense': DENSE_SHORT, 'stage': STAGE_SHORT}


@pytest.mark.parametrize('kind', ['cheater', 'filtered', 'kf',
                                  'pushed+scheduled', 'whole_body', 'dense',
                                  'stage', 'plan_step', 'plan_step_polish',
                                  'plan_step_dense', 'plan_step_stage',
                                  'plan_step_stage_polish'])
def test_a_warm_period_makes_no_host_round_trip(kind):
    """A warmed-up MPC period (a tier-1 rollout of each estimator kind, one
    with a push and a schedule, a tier-2 rollout, one on the dense interior
    point, one on the stage solver) and a planning step (with and without
    the polish, on the dense interior point, and on the stage solver with
    and without its polish) dispatch no op that copies from the host or
    waits on the device: what a CUDA graph cannot hold."""
    if kind in PLAN_CFGS:
        carry, plant, cmd = bench.initial_state(B, device=CPU)
        plan = TRT.plan_step_fn(PLAN_CFGS[kind])

        def call():
            return plan(carry, plant, cmd)
    elif kind in PERIOD_CFGS:
        call = _period_call('cheater', PERIOD_CFGS[kind])
    else:
        call = _period_call(kind, FS_SHORT)
    call()
    with OpCount() as count:
        call()
    assert sum(count.ops.values()) > 500
    assert {op: count.ops[op] for op in HOST_OPS} == dict.fromkeys(
        HOST_OPS, 0)


FORMS = {'plain': (False, False), 'pushed': (True, False),
         'scheduled': (False, True), 'both': (True, True)}


def _form_args(flags, cmd, n, dtype):
    args = [cmd]
    if flags[0]:
        args.append(_push(B, n, dtype))
    if flags[1]:
        args.append(_schedule(cmd, n, [TRT.MODE_CMD_NONE, 0, 1][:n]))
    return args


def _assert_bit_equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('form', list(FORMS))
def test_b_runner_is_the_eager_loop_bit_for_bit(form, dtype):
    """Each call form of make_rollout through the runner equals its eager
    loop of periods (``rollout.eager``), bit for bit, twice over (the
    second call reuses the first call's buffers)."""
    n = 3
    plant = TSRB.init_plant_state(B, FS, dtype=dtype, device=CPU)
    roll = TRT.make_rollout(n, FS, with_disturbance=FORMS[form][0],
                            with_schedule=FORMS[form][1], estimator='kf')
    carry = roll.init(plant, _keys(B))
    cmd = TRT.walking_command(B, vx=0.5, dtype=dtype, device=CPU)
    args = _form_args(FORMS[form], cmd, n, dtype)
    want = roll.eager(carry, plant, *args)
    _assert_bit_equal(roll(carry, plant, *args), want)
    _assert_bit_equal(roll(carry, plant, *args), want)
    assert len(roll.graphed.captures) == 1


def test_b_whole_body_runner_is_the_eager_loop_bit_for_bit():
    """The tier-2 rollout with a push and a schedule, likewise."""
    n = 2
    plant = TWB.init_whole_body_state(0.545, B, device=CPU)
    roll = TRT.make_rollout_whole_body(n, FS, with_disturbance=True,
                                       with_schedule=True)
    carry = roll.init(plant)
    cmd = TRT.walking_command(B, vx=0.5, device=CPU)
    args = _form_args((True, True), cmd, n, torch.float32)
    _assert_bit_equal(roll(carry, plant, *args),
                      roll.eager(carry, plant, *args))


def _chain_bit_for_bit(cfg, dtype, n):
    """bench.make_chain of plan_step_fn(cfg) against the chain as a Python
    loop of the same planning step, n steps."""
    carry, plant, cmd = bench.initial_state(B, dtype, CPU)
    plan = TRT.plan_step_fn(cfg)
    key = prng.PRNGKey(4, CPU)
    got = bench.make_chain(plan, n)(key, carry, plant, cmd)
    noise = 1e-6 * prng.uniform(key, plant.position.shape,
                                plant.position.dtype)
    p = plant._replace(position=plant.position + noise)
    c = carry
    for _ in range(n):
        c, wrench, _ = plan(c, p, cmd)
        p = p._replace(position=p.position + 1e-9 * wrench[:, 0, :3])
    _assert_bit_equal(got, (p.position.sum() + c.planner.f_ff.sum(), c, p))


def test_b_bench_chain_is_the_eager_chain_bit_for_bit():
    """bench.make_chain (the chained step through the runner) equals the
    chain as a Python loop of plan_step_fn."""
    _chain_bit_for_bit(FS, torch.float64, 3)


def _runner_bit_for_bit(cfg, dtype):
    """A rollout with a push and a schedule through the runner equals its
    eager loop of periods (twice over, one capture), and bench.make_chain
    equals the Python chain, bit for bit."""
    n = 2
    plant = TSRB.init_plant_state(B, cfg, dtype=dtype, device=CPU)
    roll = TRT.make_rollout(n, cfg, with_disturbance=True,
                            with_schedule=True)
    carry = roll.init(plant)
    cmd = TRT.walking_command(B, vx=0.5, dtype=dtype, device=CPU)
    args = _form_args((True, True), cmd, n, dtype)
    want = roll.eager(carry, plant, *args)
    _assert_bit_equal(roll(carry, plant, *args), want)
    _assert_bit_equal(roll(carry, plant, *args), want)
    assert len(roll.graphed.captures) == 1
    _chain_bit_for_bit(cfg, dtype, 2)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('backend', ['xla', 'pallas_interpret',
                                     'dense_auto'])
def test_b_dense_runner_is_the_eager_loop_bit_for_bit(backend, dtype):
    """The dense interior point through the runner (_runner_bit_for_bit),
    under each dense backend (the plain versions of the Cholesky kernels
    under 'dense_auto' on CPU tensors)."""
    _runner_bit_for_bit(dataclasses.replace(
        DENSE_SHORT, solver=dataclasses.replace(DENSE_SHORT.solver,
                                                backend=backend)), dtype)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_b_stage_runner_is_the_eager_loop_bit_for_bit(dtype):
    """The Mehrotra stage solver 'riccati' through the runner
    (_runner_bit_for_bit)."""
    _runner_bit_for_bit(STAGE_SHORT, dtype)


def test_c_outputs_do_not_alias_the_buffers():
    """What a call returns is the caller's: a second call, from another
    state, changes nothing the first returned, and no returned tensor
    shares memory with the runner's buffers."""
    n = 2
    roll = TRT.make_rollout(n, FS_SHORT)
    plant = TSRB.init_plant_state(B, FS, device=CPU)
    carry = roll.init(plant)
    cmd = TRT.walking_command(B, vx=0.5, device=CPU)
    args = graph.tree_map(torch.clone, (carry, plant, cmd))
    first = roll(carry, plant, cmd)
    held = graph.tree_map(torch.clone, first)
    roll(first[0], first[1], TRT.standing_command(B, device=CPU))
    _assert_bit_equal(first, held)
    (cap,) = roll.graphed.captures.values()
    buffers = {t.untyped_storage().data_ptr() for t in graph.leaves(
        (cap.state, cap.inputs, cap.outs))}
    assert not buffers & {t.untyped_storage().data_ptr()
                          for t in graph.leaves(first)}
    # nor does the runner write to its arguments
    _assert_bit_equal((carry, plant, cmd), args)


def _counting_step(ns):
    """A step that bumps ``ns.count`` once a call, as a kernel wrapper
    counts its launches: state' = state + inputs[i], out = state'."""
    def step(state, inputs, i):
        ns.count += 1
        new = state + inputs.index_select(1, i).squeeze(1)
        return new, new
    return step


def test_d_captures_are_kept_apart():
    """One capture per batch size, per dtype and per device: the key is
    every argument's shape, dtype and device."""
    ns = types.SimpleNamespace(count=0)
    steps = graph.StepGraph(_counting_step(ns), 3, counters=[(ns, 'count')])
    for batch, dtype, device in ((2, torch.float32, 'cpu'),
                                 (5, torch.float32, 'cpu'),
                                 (2, torch.float64, 'cpu'),
                                 (2, torch.float32, 'meta'),
                                 (2, torch.float32, 'cpu')):
        x = torch.zeros((batch, 4), dtype=dtype, device=device)
        steps(x, torch.ones((batch, 3, 4), dtype=dtype, device=device))
    keys = list(steps.captures)
    assert len(keys) == 4
    assert {k[0][1] for k in keys} == {torch.float32, torch.float64}
    assert {k[0][2].type for k in keys} == {'cpu', 'meta'}
    assert {k[0][0][0] for k in keys} == {2, 5}
    # a rollout keeps its own captures the same way
    roll = TRT.make_rollout(1, FS_SHORT)
    for batch, dtype in ((2, torch.float32), (3, torch.float32),
                         (2, torch.float64)):
        plant = TSRB.init_plant_state(batch, FS, dtype=dtype, device=CPU)
        roll(roll.init(plant), plant,
             TRT.walking_command(batch, dtype=dtype, device=CPU))
    assert len(roll.graphed.captures) == 3


def test_e_launches_are_counted_per_replay():
    """A counter bumped inside the captured step reads n after a run of n
    steps and 2n after two, and the stacked outputs hold every step."""
    ns = types.SimpleNamespace(count=0)
    steps = graph.StepGraph(_counting_step(ns), 4, counters=[(ns, 'count')])
    x = torch.zeros((2, 3))
    inputs = torch.arange(24.0).reshape(2, 4, 3)
    final, outs = steps(x, inputs)
    assert ns.count == 4
    torch.testing.assert_close(outs, inputs.cumsum(1), rtol=0, atol=0)
    torch.testing.assert_close(final, inputs.sum(1), rtol=0, atol=0)
    steps(final, inputs)
    assert ns.count == 8


def test_eager_backends_keep_the_loop(monkeypatch):
    """The one backend outside runtime.GRAPH_BACKENDS, 'qpoases' (a host
    solve a lane), runs the eager loop by rule: its rollout makes no
    capture (here with a stand-in for the library that plans zeros).  The
    stage solver 'riccati' is in the rule: its rollout makes one capture
    per batch size, dtype and device."""
    from hector_torch import mpc as TM
    from hector_torch.qp import ref_check
    assert set(TRT.GRAPH_BACKENDS) == set(TM.BACKENDS) - {'auto', 'qpoases'}
    assert 'riccati' in TRT.GRAPH_BACKENDS
    roll = TRT.make_rollout(1, STAGE_SHORT)
    for batch in (B, B, B + 1):
        plant = TSRB.init_plant_state(batch, STAGE_SHORT, device=CPU)
        roll(roll.init(plant), plant, TRT.walking_command(batch, device=CPU))
    assert len(roll.graphed.captures) == 2
    monkeypatch.setattr(ref_check, 'qpoases_available', lambda: True)
    monkeypatch.setattr(ref_check, 'qpoases_solve_dense',
                        lambda h, g, *args, **kw: np.zeros(len(g)))
    cfg = dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, backend='qpoases'))
    roll = TRT.make_rollout(1, cfg)
    plant = TSRB.init_plant_state(B, cfg, device=CPU)
    _, _, diags = roll(roll.init(plant), plant,
                       TRT.walking_command(B, device=CPU))
    assert not roll.graphed.captures
    assert torch.equal(diags['wrench'], torch.zeros_like(diags['wrench']))
