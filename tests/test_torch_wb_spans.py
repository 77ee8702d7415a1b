"""The articulated plant's spans and its count of failed solves
(``hector_torch/plant/whole_body.py``): the four ``wb.*`` rows a substep
inside each ``period.plant`` of a tier-2 period's phase table, which
together hold every node of the plant; ``solve_counts()`` on a lane made
singular and on a sound batch; and the step's outputs, which neither the
spans nor the count move by a bit (they add no arithmetic: the step
without them is the step as it was before them).

On the CPU a recorder whose "nodes" are the dispatched ops stands in for
the graph (as tests/test_torch_spans.py does).  The card test holds a
captured period's table to a traced replay and its rows' device time to
the period's; it runs without this directory's conftest, which imports
JAX (the card's machine has none):

    python -m pytest --noconftest tests/test_torch_wb_spans.py -m card
"""

import torch
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.control import MotorCommand
from hector_torch.io import profiling
from hector_torch.plant import rnea
from hector_torch.plant import whole_body as TWB

torch.set_num_threads(1)
CPU = torch.device('cpu')
WB_ROWS = ('wb.dynamics', 'wb.contact', 'wb.solve', 'wb.integrate')


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _rollout(batch, device, cfg=TCFG):
    roll = TRT.make_rollout_whole_body(1, cfg, with_disturbance=True)
    wb = TWB.init_whole_body_state(0.545, batch, device=device)
    carry = roll.init(wb)
    cmd = TRT.walking_command(batch, vx=0.4, device=device)
    push = torch.zeros((batch, 1, 6), device=device)
    push[::3, 0, 0] = 30.0
    return roll, (carry, wb), {'cmd': cmd, 'disturbance': push}


def _check_rows(rows, n_nodes):
    """The period's rows: five ticks and plant steps, the quarantine,
    graph.body; in each plant step the tick's set-up rows and four
    substeps' wb.* rows, which hold all of its nodes."""
    top = [r for r in rows if r[1] == -1]
    assert [r[0] for r in top] == (['period.tick', 'period.plant'] * 5
                                   + ['period.quarantine', 'graph.body'])
    for i, r in enumerate(rows):
        if r[0] != 'period.plant':
            continue
        kids = [k for k in rows if k[1] == i]
        assert [k[0] for k in kids] == (['wb.dynamics', 'wb.solve']
                                        + list(WB_ROWS) * 4)
        assert kids[0][2] == r[2] and kids[-1][3] == r[3]
        for a, b in zip(kids, kids[1:]):
            assert a[3] == b[2]
        assert all(k[3] > k[2] for k in kids)
    assert not [g for g in rows if g[1] >= 0 and rows[g[1]][0] in WB_ROWS]
    claimed = sum(r[3] - r[2] for r in top)
    assert 0 <= n_nodes - claimed < 100


def test_period_phase_table_holds_the_plant_in_its_spans():
    roll, state, inputs = _rollout(2, CPU)
    roll(*state, inputs['cmd'], inputs['disturbance'])
    cap, = roll.graphed.captures.values()
    cap.load(state, inputs)
    with OpCount() as count:
        rec = profiling.Recorder(lambda: count.n)
        with profiling.recording(rec):
            cap._body()
    _check_rows(rec.table(), count.n)


def _state(batch=8, height=0.545):
    g = torch.Generator().manual_seed(3)
    s = TWB.init_whole_body_state(height, batch, dtype=torch.float64,
                                  device=CPU)
    return s._replace(
        v_world=0.3 * torch.randn((batch, 3), generator=g,
                                  dtype=torch.float64),
        q=0.2 * torch.randn((batch, 2, 5), generator=g, dtype=torch.float64))


def _motor(batch=8, kp=30.0):
    z = torch.zeros((batch, 2, 5), dtype=torch.float64)
    return MotorCommand(tau=z + 1.0, q_des=z, qd_des=z, kp=z + kp,
                        kd=z + 1.0)


def test_solve_counts_see_a_singular_lane_and_none_on_a_sound_batch(
        monkeypatch):
    batch = 8
    before = TWB.solve_counts('cpu')
    TWB.step(_state(batch), _motor(batch), TCFG)
    solves, failed = TWB.solve_counts('cpu')
    assert (solves - before[0], failed - before[1]) == (4 * batch, 0)

    # lane 3 in the air, its mass matrix made the negative of what the
    # step adds to it (the servo's dt A and the 1e-6): its implicit matrix
    # is exactly zero
    dt = TCFG.plant.dt
    cmd = _motor(batch, kp=0.0)
    a_imp = (cmd.kd + TCFG.plant.joint_damping).reshape(batch, 10)[3]
    dynamics = rnea.dynamics

    def singular(*args, **kwargs):
        m, *rest = dynamics(*args, **kwargs)
        m = m.clone()
        m[3] = -torch.diag(torch.cat([torch.zeros(6, dtype=m.dtype),
                                      dt * a_imp]))
        m[3] -= 1e-6 * torch.eye(16, dtype=m.dtype)
        return (m, *rest)

    monkeypatch.setattr(rnea, 'dynamics', singular)
    state = _state(batch)
    state.position[3, 2] = 1.5
    TWB.step(state, cmd, TCFG, n_substeps=1)
    after = TWB.solve_counts('cpu')
    assert (after[0] - solves, after[1] - failed) == (batch, 1)


def _outputs(fn):
    s = fn()
    return [t.clone() for t in s]


def test_step_is_bit_for_bit_without_its_spans_and_count(monkeypatch):
    """The step recorded (spans open rows), profiled (spans are ranges) and
    plain give the same bits, and so does the step with its count taken
    out: the instrumentation moves no output."""
    state, cmd = _state(), _motor()
    push = torch.linspace(-20.0, 20.0, 48, dtype=torch.float64).reshape(8,
                                                                        6)

    def run():
        s = state
        for _ in range(3):
            s = TWB.step(s, cmd, TCFG, disturbance=push)
        return s

    plain = _outputs(run)
    with OpCount() as count:
        with profiling.recording(profiling.Recorder(lambda: count.n)):
            recorded = _outputs(run)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = _outputs(run)
    monkeypatch.setattr(TWB, '_count_solves', lambda info: None)
    uncounted = _outputs(run)
    for other in (recorded, profiled, uncounted):
        assert all(torch.equal(a, b) for a, b in zip(plain, other))
    assert plain[7][:, :TWB.N_TOE].any()


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')


@pytest.mark.card
def test_captured_period_rows_sum_to_a_traced_replay(card):
    """A tier-2 period captured at 256 lanes: one traced replay matches its
    table node by node; the wb.* rows sum to each period.plant's device
    time, and the top-level rows and the caller's nodes to the replay's;
    the count of solves moves by 20 lane-solves a lane a replay, none
    failed."""
    from cardbench.yardstick import spans as S
    from cardbench.yardstick import trace as T
    roll, state, inputs = _rollout(256, card)
    roll(*state, inputs['cmd'], inputs['disturbance'])
    cap, = roll.graphed.captures.values()
    table = S.phase_table(cap.id)
    _check_rows(table['phases'], len(table['nodes']))
    cap.load(state, inputs)
    before = TWB.solve_counts()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cap.replay()
        torch.cuda.synchronize()
    after = TWB.solve_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (256 * 20, 0)
    events, hosts = T.device_events(prof), T.host_events(prof)
    rep, = S.replays(events, hosts)
    plant = rep.phase_us('period.plant')
    rows = sum(rep.phase_us(name) for name in WB_ROWS)
    assert plant > 0 and abs(rows - plant) < 100.0      # us
    top = sum(rep.us.get(k, 0.0) for name, parent, first, stop
              in table['phases'] if parent == -1
              for k in range(first, stop))
    claimed = {k for _, parent, first, stop in table['phases']
               if parent == -1 for k in range(first, stop)}
    caller = sum(us for k, us in rep.us.items() if k not in claimed)
    assert abs(top + caller - sum(rep.us.values())) < 1e-6
