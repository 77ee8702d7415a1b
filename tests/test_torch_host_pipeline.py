"""The port's host pipeline (``hector_torch/io/host_pipeline.py``) against
``hector/io/host_pipeline.py``: both build ``native/scenario_gen.cpp`` with
the same g++ flags, so the rows are bit for bit the same.  The stream's
pinned buffers, side stream and events serve the card (chip_smoke.py's
``cli`` phase); here its CPU path is held to the same order and rows.
"""

import numpy as np
import pytest
import torch

from hector.io import host_pipeline as JHP

from hector_torch import parallel as PAR
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.io import host_pipeline as HP

torch.set_num_threads(1)
CPU = torch.device('cpu')


@pytest.mark.parametrize('seed,params', [
    (7, {}), (3 + (5 << 32), dict(p_stairs=0.2)),
    (2**64 - 1, dict(p_standing=0.5, max_step_height=0.06))])
def test_rows_are_jax_bit_for_bit(seed, params):
    got = HP.generate_host(seed, 512, **params)
    want = JHP.generate_host(seed, 512, **params)
    assert got.dtype == np.float32 and got.shape == (512, HP.N_COLS)
    np.testing.assert_array_equal(got, want)


def test_rows_envelope_and_shard_equivalence():
    """tests/test_host_pipeline.py on the port: determinism, the teleop
    envelope, and row i depending only on (seed, i)."""
    a = HP.generate_host(seed=7, batch=512)
    np.testing.assert_array_equal(a, HP.generate_host(seed=7, batch=512))
    assert np.abs(a - HP.generate_host(seed=8, batch=512)).max() > 0
    assert a[:, 0].min() >= -0.75 and a[:, 0].max() <= 0.75
    assert a[:, 1].min() >= -0.25 and a[:, 1].max() <= 0.25
    assert a[:, 2].min() >= -1.5 and a[:, 2].max() <= 1.5
    standing = a[:, 7] == 10.0
    assert standing.mean() > 0.02 and np.all(a[standing][:, 0:3] == 0.0)
    full = HP.generate_host(seed=3, batch=512)
    np.testing.assert_array_equal(
        full[256:], HP.generate_host(seed=3, batch=256, row_begin=256))
    out = np.empty((64, HP.N_COLS), np.float32)
    assert HP.generate_host(3, 64, out=out) is out
    with pytest.raises(ValueError, match='contiguous'):
        HP.generate_host(3, 64, out=np.empty((64, HP.N_COLS), np.float64))


def test_rows_to_command_matches_jax_layout():
    rows = HP.generate_host(seed=0, batch=64)
    got = HP.rows_to_command(rows)
    want = JHP.rows_to_command(rows)
    assert isinstance(got, TRT.ScenarioCommand)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got.gait_offsets.shape == (64, 2)


def test_stream_order_determinism_and_shards():
    """Step k of a stream is generate_host(seed + (k << 32)), for any
    number of steps taken; with a mesh each shard holds its contiguous
    rows; two streams of one seed agree."""
    stream = HP.ScenarioStream(batch=16, seed=1, p_stairs=0.2, device=CPU)
    cmds = [next(stream) for _ in range(4)]
    stream.close()
    for k, cmd in enumerate(cmds):
        rows = HP.generate_host(1 + (k << 32), 16, p_stairs=0.2)
        assert torch.equal(cmd.vx, torch.from_numpy(rows[:, 0]))
        assert torch.equal(cmd.gait_durations,
                           torch.from_numpy(rows[:, 7:9]))
    assert float((cmds[0].vx - cmds[1].vx).abs().max()) > 0
    mesh = PAR.data_mesh(4, device=CPU)
    sharded = HP.ScenarioStream(batch=16, seed=1, mesh=mesh, p_stairs=0.2)
    for k in range(2):
        shards = next(sharded)
        assert len(shards) == 4 and shards[2].vx.shape == (4,)
        assert torch.equal(PAR.gather(shards).vx, cmds[k].vx)
    sharded.close()
    with pytest.raises(ValueError, match='evenly'):
        HP.ScenarioStream(batch=10, mesh=mesh)


def test_stream_feeds_the_sharded_rollout():
    mesh = PAR.data_mesh(2, device=CPU)
    stream = HP.ScenarioStream(batch=4, seed=2, mesh=mesh)
    carry, plant, _ = PAR.make_batch(4, cfg=TCFG, mesh=mesh)
    roll = PAR.make_sharded_rollout(2, mesh, TCFG)
    _, _, metrics = roll(carry, plant, next(stream))
    stream.close()
    assert np.isfinite(float(metrics['mean_height']))
