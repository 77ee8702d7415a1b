"""The traffic generators are deterministic in the seed, and differ
between seeds."""

import torch

from cardbench.yardstick import scenarios as S

BIG = 2**31 + 12_345


def draw(seed, stream=0, batch=256):
    g = S.generator(seed, stream, 'cpu')
    carry, plant = S.moving_state(g, batch, torch.float32, 'cpu')
    cmd = S.commands(g, batch, 0.1, torch.float32, 'cpu')
    push = S.pushes(g, batch, 20, 30.0, 0.05, torch.float32, 'cpu')
    return [carry, plant, cmd, push]


def flat(tree):
    if isinstance(tree, tuple) or isinstance(tree, list):
        return [t for x in tree for t in flat(x)]
    return [tree]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def test_same_seed_same_inputs():
    assert same(draw(BIG), draw(BIG))


def test_other_seed_or_stream_other_inputs():
    assert not same(draw(BIG), draw(BIG + 1))
    assert not same(draw(BIG), draw(BIG, stream=1))


def test_draws_keep_to_the_envelope():
    carry, plant, cmd, push = draw(BIG, batch=4096)
    assert cmd.vx.abs().max() <= 0.75 and cmd.vy.abs().max() <= 0.25
    assert cmd.yaw_rate.abs().max() <= 1.5
    standing = cmd.gait_durations[:, 0] == 10
    assert 0.07 < standing.float().mean() < 0.13
    assert (cmd.vx[standing] == 0).all()
    assert (cmd.terrain_step_height == 0).all()
    assert 0 <= int(carry.tick.min()) and int(carry.tick.max()) < 400
    norms = torch.linalg.vector_norm(push[..., :3], dim=-1)
    pushed = norms > 0
    assert torch.allclose(norms[pushed], torch.tensor(30.0), rtol=1e-4)
    assert plant.v_world[:, 0].abs().max() <= 0.75


def test_plan_and_loop_traffic_inputs_repeat():
    from hector_torch.config import DEFAULT_CONFIG
    from cardbench.reference.config import DEFAULT_CONFIG as REF
    from cardbench.traffic import loop, plan
    mix = {'batch': 8, 'p_standing': 0.1, 'trace_units': 1}
    dev = [torch.device('cpu')]
    a = plan.Traffic(mix, DEFAULT_CONFIG, REF, BIG, dev)
    b = plan.Traffic(mix, DEFAULT_CONFIG, REF, BIG, dev)
    assert same([a.state0, a.cmd], [b.state0, b.cmd])
    lmix = dict(mix, periods=4, p_push=0.5, push_n=30.0)
    la = loop.Traffic(lmix, DEFAULT_CONFIG, REF, BIG, dev)
    lb = loop.Traffic(lmix, DEFAULT_CONFIG, REF, BIG, dev)
    assert same(la.inputs(3), lb.inputs(3))
    assert not same(la.inputs(3), la.inputs(4))
