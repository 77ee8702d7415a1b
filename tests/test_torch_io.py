"""The port's IO layer and world presets against the JAX package:
``prng.uniform``, ``io/scenarios``, ``worlds``, ``io/metrics``,
``io/checkpoint``, ``io/trajectory`` and ``io/profiling``.

Scenario draws are bit for bit JAX's for the same key (the masks drawn in
float64, JAX's default float under the tests' ``jax_enable_x64``); the
pushes' directions come from ``prng.normal``, which agrees with JAX's to a
few ulps (tests/test_torch_prng.py), so their values carry that bar.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import worlds as JW
from hector.config import DEFAULT_CONFIG as JCFG
from hector.io import profiling as JPF
from hector.io import scenarios as JSC
from hector.io import trajectory as JTRAJ
from hector.io.metrics import summarize_rollout as j_summarize

from hector_torch import parallel as PAR
from hector_torch import prng
from hector_torch import runtime as TRT
from hector_torch import worlds as TW
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.io import checkpoint as CKPT
from hector_torch.io import profiling as TPF
from hector_torch.io import scenarios as TSC
from hector_torch.io import trajectory as TTRAJ
from hector_torch.io.metrics import MetricsLogger, summarize_rollout
from hector_torch.plant import whole_body as WB

torch.set_num_threads(1)
CPU = torch.device('cpu')
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
# pushes: 30 N wrenches from normals a few ulps from JAX's (float32: ~3
# ulps at 30 N; float64: measured 4e-14)
PUSH_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize('jdtype,tdtype', DTYPES)
@pytest.mark.parametrize('bounds,shape', [((0.0, 1.0), (1000,)),
                                          ((-0.75, 0.75), (7, 13, 3)),
                                          ((0.01, 0.04), (257,)),
                                          ((-1e-3, 2e-7), (64, 5)),
                                          ((1e5, 1e5 + 3.3), (33,))])
def test_uniform_is_jax_bit_for_bit(jdtype, tdtype, bounds, shape):
    """jax.random.uniform's mantissa draw, its fused multiply-add (XLA
    contracts floats * span + min) and its clamp, for several keys."""
    for seed in (0, 7, 2**40 + 3):
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jdtype,
                                  *bounds)
        got = prng.uniform(prng.PRNGKey(seed, CPU), shape, tdtype, *bounds)
        assert got.dtype == tdtype and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fma_is_correctly_rounded():
    """prng.fma against exact rational arithmetic, on random operands and
    on products that land on ties."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    for np_t, bits in ((np.float32, 24), (np.float64, 53)):
        a = np.concatenate([rng.uniform(-2, 2, 500),
                            np.full(20, 1 + 3 * 2.0 ** (1 - bits))]).astype(np_t)
        b = np.concatenate([rng.uniform(-2, 2, 500),
                            np.full(20, 1 + 2.0 ** (1 - bits))]).astype(np_t)
        c = np.concatenate([rng.uniform(-2, 2, 500),
                            -rng.integers(0, 3, 20) * 2.0 ** (2 - bits)]
                           ).astype(np_t)
        got = prng.fma(*[torch.from_numpy(x) for x in (a, b, c)]).numpy()
        for x, y, z, g in zip(a, b, c, got):
            exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
            err = abs(Fraction(float(g)) - exact)
            for nb in (np.nextafter(g, np_t(np.inf)),
                       np.nextafter(g, np_t(-np.inf))):
                d = abs(Fraction(float(nb)) - exact)
                assert err < d or (err == d and
                                   int(g.view(f'u{g.nbytes}')) % 2 == 0)


@pytest.mark.parametrize('jdtype,tdtype', DTYPES)
def test_random_commands_are_jax_bit_for_bit(jdtype, tdtype):
    for seed, p_stairs in ((0, 0.0), (3, 0.3)):
        want = JSC.random_commands(jax.random.PRNGKey(seed), 256,
                                   p_stairs=p_stairs, dtype=jdtype)
        got = TSC.random_commands(prng.PRNGKey(seed, CPU), 256,
                                  p_stairs=p_stairs, dtype=tdtype,
                                  mask_dtype=torch.float64)
        for name, w, g in zip(want._fields, want, got):
            assert g.dtype == tdtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    # the envelope and the standing lanes (tests/test_io.py:18-26)
    standing = got.gait_durations[:, 0] == 10.0
    assert standing.any() and torch.all(got.vx[standing] == 0)
    assert got.vx.abs().max() <= 0.75 and got.yaw_rate.abs().max() <= 1.5


@pytest.mark.parametrize('jdtype,tdtype', DTYPES)
def test_disturbance_schedule_matches_jax(jdtype, tdtype):
    """The push mask bit for bit, the wrenches within the normals' bar."""
    for seed in (1, 5):
        want = np.asarray(JSC.disturbance_schedule(
            jax.random.PRNGKey(seed), 64, 50, p_push=0.05, dtype=jdtype))
        got = TSC.disturbance_schedule(prng.PRNGKey(seed, CPU), 64, 50,
                                       p_push=0.05, dtype=tdtype,
                                       mask_dtype=torch.float64)
        assert got.shape == (64, 50, 6) and got.dtype == tdtype
        np.testing.assert_array_equal(got.numpy() != 0, want != 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PUSH_TOL[tdtype])
    frac = float((got.abs().sum(-1) > 0).double().mean())
    assert 0.01 < frac < 0.1


def test_worlds_match_jax():
    assert set(TW.WORLDS) == set(JW.WORLDS)
    for name in JW.WORLDS:
        j, t = JW.WORLDS[name], TW.WORLDS[name]
        assert (t.name, t.gravity, t.spawn_z, t.description) == \
            (j.name, j.gravity, j.spawn_z, j.description)
        assert (t.terrain.step_height, t.terrain.step_length) == \
            (j.terrain.step_height, j.terrain.step_length)
        cfg_t, _ = TW.apply(name, TCFG)
        cfg_j, _ = JW.apply(name, JCFG)
        assert cfg_t.plant.gravity == cfg_j.plant.gravity
        assert cfg_t.mpc.gravity == 9.81
    assert TW.STAIRS_REFERENCE_GEOMETRY.step_height == 0.15
    with pytest.raises(KeyError):
        TW.get('moon')


def test_metrics_logger_and_summary(tmp_path):
    path = str(tmp_path / 'm.jsonl')
    logger = MetricsLogger(path)
    rec = logger.log(0, {'a': torch.tensor(1.5), 'b': np.float32(2.0)},
                     note='x', batch=4)
    logger.log(1, {'a': 2.0})
    logger.close()
    lines = open(path).read().strip().split('\n')
    assert len(lines) == 2
    assert json.loads(lines[0]) == rec
    assert rec['a'] == 1.5 and rec['batch'] == 4.0 and rec['note'] == 'x'
    # summarize_rollout reduces over (B, n_periods): JAX's on the flattened
    # lanes gives the same numbers
    rng = np.random.default_rng(0)
    diags = dict(height=rng.uniform(0.4, 0.6, (3, 5)),
                 fallen=rng.uniform(size=(3, 5)) < 0.2,
                 qp_mu=rng.uniform(size=(3, 5)),
                 qp_r_dual=rng.uniform(size=(3, 5)))
    got = summarize_rollout({k: torch.from_numpy(v) for k, v in diags.items()})
    want = j_summarize({k: v.reshape(-1) for k, v in diags.items()})
    assert got == pytest.approx(want, rel=1e-15, abs=0)


def _tree_equal(a, b):
    if isinstance(a, tuple):
        return all(_tree_equal(x, y) for x, y in zip(a, b, strict=True))
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def _zeros_like(tree):
    if isinstance(tree, tuple):
        return type(tree)(*map(_zeros_like, tree))
    return torch.zeros_like(tree)


def test_checkpoint_roundtrip_keeps_three_and_resumes(tmp_path):
    """tests/test_io.py:66-78 on the port: a batch round-trips bit for bit
    onto the template's device and dtypes, the newest step is restored by
    default, three steps are kept, and a missing checkpoint raises."""
    path = str(tmp_path / 'ckpt')
    with pytest.raises(FileNotFoundError):
        CKPT.restore(path, PAR.make_batch(4, device=CPU))
    carry, plant, cmd = PAR.make_batch(4, device=CPU, seed=3)
    roll = TRT.make_rollout(3, TCFG)
    carry, plant, _ = roll(carry, plant, cmd)
    for step in (1, 2, 7, 9):
        CKPT.save(path, step, carry, plant, cmd, extra={'seed': 3})
    assert CKPT.steps(path) == [2, 7, 9]
    step, restored = CKPT.restore(path, PAR.make_batch(4, device=CPU))
    assert step == 9 and restored['extra'] == {'seed': 3}
    assert _tree_equal(restored['carry'], carry)
    assert _tree_equal(restored['plant'], plant)
    assert _tree_equal(restored['cmd'], cmd)
    assert CKPT.restore(path, (carry, plant, cmd), step=7)[0] == 7
    # restored tensors take the template's dtype
    t64 = PAR.make_batch(4, device=CPU)
    t64 = (t64[0], t64[1]._replace(position=t64[1].position.double()),
           t64[2])
    _, r64 = CKPT.restore(path, t64)
    assert r64['plant'].position.dtype == torch.float64
    assert torch.equal(r64['plant'].position, plant.position.double())
    # resuming from the checkpoint continues the run bit for bit
    c1, p1, _ = roll(carry, plant, cmd)
    c2, p2, _ = roll(restored['carry'], restored['plant'], restored['cmd'])
    assert _tree_equal(c1, c2) and _tree_equal(p1, p2)


def test_checkpoint_roundtrip_whole_body(tmp_path):
    """tests/test_io.py:126 on the port: a mid-walk tier-2 state and its
    carry round-trip exactly, and 5 periods resumed from the checkpoint
    equal 5 periods run straight on, bit for bit."""
    roll = TRT.make_rollout_whole_body(5, TCFG)
    plant = WB.init_whole_body_state(0.545, 1, device=CPU)
    carry = roll.init(plant)
    cmd = TRT.walking_command(1, vx=0.3, device=CPU)
    carry, plant, _ = roll(carry, plant, cmd)
    path = str(tmp_path / 'ckpt_wb')
    CKPT.save(path, 3, carry, plant, cmd)
    zeros = tuple(_zeros_like(t) for t in (carry, plant, cmd))
    step, restored = CKPT.restore(path, zeros)
    assert step == 3
    assert _tree_equal(restored['plant'], plant)
    assert _tree_equal(restored['carry'], carry)
    c1, p1, d1 = roll(carry, plant, cmd)
    c2, p2, d2 = roll(restored['carry'], restored['plant'], restored['cmd'])
    assert _tree_equal(p1, p2) and _tree_equal(c1, c2)
    assert not d2['fallen'].any()


def _table_csv(tmp_path, n=60, vx=0.3):
    t = np.arange(n) * 0.005
    states = np.zeros((n, 12))
    states[:, 3] = vx * t
    states[:, 5] = 0.55
    states[:, 9] = vx
    states[:, 2] = 0.1 * t            # a slow yaw, so the rotation matters
    path = str(tmp_path / 'walk.csv')
    JTRAJ.write_csv(path, t, states)
    return path, t, states


def test_trajectory_table_and_schedule_match_jax(tmp_path):
    path, t, states = _table_csv(tmp_path)
    tj = JTRAJ.TrajectoryTable.from_csv(path)
    tt = TTRAJ.TrajectoryTable.from_csv(path, device=CPU)
    assert tt.data.dtype == torch.float64
    probe = np.concatenate([[-1.0, 0.0, 0.0025, 0.005, 0.1234, 99.0],
                            t, t + 1e-9])
    np.testing.assert_array_equal(tt.row_at(probe).numpy(),
                                  np.asarray(tj.row_at(jnp.asarray(probe))))
    np.testing.assert_array_equal(tt.state_at(0.505).numpy(),
                                  np.asarray(tj.state_at(jnp.asarray(0.505))))
    cmd_j, mode_j = JTRAJ.command_schedule(tj, 40, 0.005)
    cmd_t, mode_t = TTRAJ.command_schedule(tt, 40, 0.005)
    for name, a, b in zip(cmd_j._fields, cmd_j, cmd_t):
        assert b.dtype == torch.float32 and b.shape[0] == 1, name
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a),
                                      err_msg=name)
    np.testing.assert_array_equal(mode_t[0].numpy(), np.asarray(mode_j))
    # a one-row table stays a table (the reference's example.csv)
    one = str(tmp_path / 'one.csv')
    JTRAJ.write_csv(one, t[:1], states[:1])
    assert TTRAJ.TrajectoryTable.from_csv(one, CPU).data.shape == (1, 34)
    with pytest.raises(ValueError):
        TTRAJ.TrajectoryTable(np.zeros((3, 5)), CPU)


def test_closed_loop_replay_matches_jax(tmp_path):
    """The replay's report against JAX's on the same table (float32
    rollouts on both sides; the report rounds to 1e-4, so a value may sit
    one rounding unit apart)."""
    path, _, _ = _table_csv(tmp_path, n=40)
    rep_j, diags_j = JTRAJ.closed_loop_replay(
        JTRAJ.TrajectoryTable.from_csv(path))
    rep_t, diags_t = TTRAJ.closed_loop_replay(
        TTRAJ.TrajectoryTable.from_csv(path, CPU))
    assert set(rep_t) == set(rep_j)
    for k in ('rows', 'periods', 'seconds', 'fallen'):
        assert rep_t[k] == rep_j[k], k
    for k in ('pos_err_mean', 'pos_err_final', 'pos_err_max',
              'height_err_mean'):
        assert abs(rep_t[k] - rep_j[k]) <= 1.0001e-4, k
    np.testing.assert_allclose(diags_t['height'].numpy(),
                               np.asarray(diags_j['height']), atol=1e-5)


def test_profiling_timer_and_cost_model():
    timer = TPF.StepTimer()
    x = torch.arange(8.0)
    with timer.phase('square', x * x):
        y = x * x
    out = timer.time_fn('sum', torch.sum, y)
    assert float(out) == float((x * x).sum())
    s = timer.summary()
    assert set(s) == {'square', 'sum'}
    assert s['sum']['count'] == 1 and s['sum']['mean_ms'] >= 0
    for it in (14, 28):
        assert TPF.riccati_kernel_cost(it) == TPF.KernelCost(
            *JPF.riccati_kernel_cost(it).__dict__.values())
    rep = TPF.roofline_report(measured_solves_per_s=3.0e6)
    assert rep['binding_resource'] == 'compute(FP32)'
    assert rep['hbm_peak_gbps'] == 3350.0 and rep['fp32_peak_tflops'] == 67.0
    assert 0 < rep['fraction_of_speed_of_light'] < 1
    assert 'speed_of_light_compute_published' in rep
    assert 'not measured' in rep['note'] and rep['card'] == 'NVIDIA H100 SXM'
    assert 'measured on' in TPF.roofline_report(
        3.0e6, peaks_measured=True)['note']
    j = JPF.roofline_report(measured_solves_per_s=3.0e6)
    assert rep['bytes_per_solve'] == j['bytes_per_solve']
    assert rep['flops_per_solve'] == j['flops_per_solve']


def test_profiling_trace_writes_chrome_trace(tmp_path):
    with TPF.trace(str(tmp_path)) as prof:
        torch.ones(16).cumsum(0)
    assert (tmp_path / 'trace.json').stat().st_size > 0
    assert len(prof.key_averages()) > 0
