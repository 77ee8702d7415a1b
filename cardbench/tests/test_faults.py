"""A run with its timed path broken underneath comes out not correct: for
each fault a one-card cell can have, on each traffic kind, the harness
past its look for a card, at a tiny size on the CPU (the port's plain
versions).  The unbroken run comes out correct."""

import pytest
import torch

from cardbench import run as CR

SMALL = dict(batch=16, periods=4, trace_units=1)
CELLS = {'plan': 'plan-fused-32k', 'loop': 'loop-fused-1k'}


@pytest.fixture
def small(monkeypatch):
    from cardbench.traffic import loop, plan
    monkeypatch.setattr(plan, 'CHECK_STEPS', 2)
    monkeypatch.setattr(loop, 'CHECK_BATCHES', 2)
    spec = CR.cell_spec

    def shrunk(w):
        b, e, c, cfg, mix = spec(w)
        return b, e, c, cfg, {k: SMALL.get(k, v) for k, v in mix.items()}
    monkeypatch.setattr(CR, 'cell_spec', shrunk)


def run(cell):
    return CR.run(cell, 2**31 + 99, 0.0, 0, device='cpu')


def unchanged_state(monkeypatch, kind):
    """A step that returns its state unchanged."""
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    if kind == 'plan':
        plan = RT.plan_step_fn

        def stuck(cfg=None):
            step = plan(cfg)

            def fn(carry, plant, cmd):
                _, wrench, motor = step(carry, plant, cmd)
                return carry, wrench, motor
            return fn
        monkeypatch.setattr(RT, 'plan_step_fn', stuck)
    else:
        monkeypatch.setattr(srb, 'step', lambda state, *a, **k: state)


def _first_half(new, old):
    """``new`` on the first half of the lanes, ``old`` on the rest."""
    if isinstance(new, tuple):
        return type(new)(*[_first_half(a, b) for a, b in zip(new, old)])
    n = new.shape[0] // 2
    return torch.cat([new[:n], old[n:]])


def half_batch(monkeypatch, kind):
    """Half of the batch left out: the second half of the lanes keeps its
    state (and, in a planning step, returns zero forces and torques)."""
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    if kind == 'plan':
        plan = RT.plan_step_fn

        def half_plan(cfg=None):
            step = plan(cfg)

            def fn(carry, plant, cmd):
                c, w, m = step(carry, plant, cmd)
                zeros = torch.zeros_like
                return (_first_half(c, carry), _first_half(w, zeros(w)),
                        type(m)(*[_first_half(x, zeros(x)) for x in m]))
            return fn
        monkeypatch.setattr(RT, 'plan_step_fn', half_plan)
    else:
        step = srb.step
        monkeypatch.setattr(srb, 'step', lambda state, *a, **k:
                            _first_half(step(state, *a, **k), state))


def altered_answer(monkeypatch, kind):
    """An answer altered where it is produced: the solver's forces 5 %
    larger on every lane."""
    from hector_torch import mpc as M
    solve = M.solve

    def altered(problem, cfg=None):
        sol = solve(problem, cfg)
        return sol._replace(u=sol.u * 1.05)
    monkeypatch.setattr(M, 'solve', altered)


FAULTS = {'unchanged_state': unchanged_state, 'half_batch': half_batch,
          'altered_answer': altered_answer}


@pytest.mark.parametrize('kind', sorted(CELLS))
def test_unbroken_run_is_correct(small, kind):
    r = run(CELLS[kind])
    assert r['correct'], r['checks']
    assert r['failed'] == 0 and r['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('kind', sorted(CELLS))
def test_fault_is_not_correct(small, monkeypatch, kind, fault):
    FAULTS[fault](monkeypatch, kind)
    r = run(CELLS[kind])
    assert not r['correct'], r['checks']
