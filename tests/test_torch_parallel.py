"""The port's data-parallel layer (``hector_torch/parallel.py``) against
``hector/parallel.py``.

The JAX tests run an 8-device virtual CPU mesh (tests/conftest.py); the
port's CPU mesh is the one CPU device listed once a shard.  Both packages
run their default float32 batches under the default solver, which is the
Mehrotra stage solver on a CPU in both.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import parallel as JPAR
from hector.config import DEFAULT_CONFIG as JCFG
from hector.plant import srb as JSRB

from hector_torch import parallel as PAR
from hector_torch import runtime as TRT
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.plant import srb as TSRB

from .test_torch_slice import todict

torch.set_num_threads(1)
CPU = torch.device('cpu')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a sharded float32 rollout against the unsharded one
# (tests/test_parallel.py:31-50 holds JAX's to 1e-6)
SHARD_TOL = 1e-6
# the sharded metrics against JAX's, float32 closed loops of two packages
# over 10 periods: the mean height within 1e-5 m and the worst
# complementarity (~1e-6) within 1 % (its last digits follow the float32
# Mehrotra iterates); fallen counts equal
HEIGHT_TOL = 1e-5
MU_RTOL = 1e-2


# each lane's true gyro bias is a draw of prng.normal, a few float32 ulps
# from jax.random.normal (tests/test_torch_prng.py): 4 ulps of ~6e-3
NORMAL_TOL = {'.est.gyro_bias': 2e-9}


def _assert_tree(jtree, ttree, exact=True, tol=0.0, path=''):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            sub = f'{path}.{k}'
            _assert_tree(jtree[k], ttree[k], sub not in NORMAL_TOL and exact,
                         NORMAL_TOL.get(sub, tol), sub)
        return
    j, t = np.asarray(jtree), np.asarray(ttree)
    if j.dtype == np.uint32:        # a key's words: int64 in the port
        j = j.astype(np.int64)
    assert j.shape == t.shape and j.dtype == t.dtype, (path, j.dtype,
                                                       t.dtype)
    if exact:
        np.testing.assert_array_equal(t, j, err_msg=path)
    else:
        np.testing.assert_allclose(t, j, atol=tol, rtol=0, err_msg=path)


def test_make_batch_matches_jax():
    """The batch's carry (per-lane noise keys fold_in(PRNGKey(seed), i)
    included; the gyro biases drawn with them within the normals' bar) and
    plant bit for bit; the default commands' speeds (a
    linspace over [-0.75, 0.75], which XLA and torch round differently in
    the last bits) within 1e-7 m/s."""
    for batch, seed in ((8, 0), (13, 5)):
        c_j, p_j, k_j = JPAR.make_batch(batch, cfg=JCFG, seed=seed)
        c_t, p_t, k_t = PAR.make_batch(batch, cfg=TCFG, seed=seed,
                                       device=CPU)
        _assert_tree(todict(c_j), todict(c_t))
        _assert_tree(todict(p_j), todict(p_t))
        cmd_j, cmd_t = todict(k_j), todict(k_t)
        vx_j, vx_t = cmd_j.pop('vx'), cmd_t.pop('vx')
        _assert_tree(cmd_j, cmd_t)
        np.testing.assert_allclose(vx_t, vx_j, atol=1e-7, rtol=0)


def test_nominal_joint_angles_match_jax():
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        got = TSRB.nominal_joint_angles(3, td, CPU)
        want = JSRB.nominal_joint_angles(jd)
        assert got.shape == (3, 2, 5) and got.dtype == td
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(want, (3, 2, 5)))


def test_mesh_and_shards():
    mesh = PAR.data_mesh(4, device=CPU)
    assert mesh == (CPU,) * 4 and PAR.data_mesh(device=CPU) == (CPU,)
    assert PAR.multihost(device=CPU) == (CPU,)
    _, plant, _ = PAR.make_batch(8, device=CPU)
    shards = PAR.shard_batch(plant, mesh)
    assert len(shards) == 4 and shards[1].position.shape == (2, 3)
    assert torch.equal(PAR.gather(shards).position, plant.position)
    with pytest.raises(ValueError, match='evenly'):
        PAR.shard_batch(plant, PAR.data_mesh(3, device=CPU))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        PAR.data_mesh()


def test_make_batch_builds_this_process_slice(monkeypatch):
    """Rank 1 of 2 processes on a two-device mesh builds lanes 4..7 of the
    global 8-lane batch, split over its mesh: bit for bit the one-process
    batch's lanes (carry with its noise keys, plant, cmd), and cmd_fn
    sees the global lane indices."""
    whole = PAR.make_batch(8, device=CPU)
    monkeypatch.setattr(PAR, '_process_index', lambda: (1, 2))
    mesh = PAR.data_mesh(2, device=CPU)
    part = PAR.make_batch(8, mesh=mesh)
    for w, shards in zip(whole, part, strict=True):
        assert len(shards) == 2 and PAR._leaves(shards[0])[0].shape[0] == 2
        _assert_tree(todict(TRT.concat(*shards)),
                     todict(PAR._map(lambda x: x[4:8], w)))
    seen = []

    def cmd_fn(lanes):
        seen.append(lanes.tolist())
        return TRT.walking_command(lanes.shape[0], device=CPU)

    PAR.make_batch(8, cmd_fn=cmd_fn, mesh=mesh)
    assert seen == [[4, 5, 6, 7]]


@pytest.mark.parametrize('rank_world, batch, n_devices',
                         [((0, 2), 6, 2), ((2, 3), 8, 1), ((1, 2), 4, 4)])
def test_make_batch_raises_when_the_batch_does_not_split(
        monkeypatch, rank_world, batch, n_devices):
    """The global batch must split evenly over the processes and their
    devices, as P('data') requires."""
    monkeypatch.setattr(PAR, '_process_index', lambda: rank_world)
    with pytest.raises(ValueError, match='evenly'):
        PAR.make_batch(batch, mesh=PAR.data_mesh(n_devices, device=CPU))


def test_sharded_equals_unsharded():
    """Sharding must not change results (pure data parallelism): four
    shards against the whole batch at 1e-6 (tests/test_parallel.py:31-50),
    and one shard bit for bit."""
    carry, plant, cmd = PAR.make_batch(8, device=CPU)
    c1, p1, d1 = TRT.make_rollout(10, TCFG)(carry, plant, cmd)
    for n_dev in (4, 1):
        mesh = PAR.data_mesh(n_dev, device=CPU)
        roll = PAR.make_sharded_rollout(10, mesh, TCFG)
        c2, p2, metrics = roll(*(PAR.shard_batch(t, mesh)
                                 for t in (carry, plant, cmd)))
        c2, p2 = PAR.gather(c2), PAR.gather(p2)
        if n_dev == 1:
            assert all(torch.equal(a, b) for a, b in zip(p1, p2))
        np.testing.assert_allclose(p2.position.numpy(), p1.position.numpy(),
                                   atol=SHARD_TOL, rtol=0)
        assert torch.equal(c2.mode, c1.mode)
        h = d1['height'].float()
        assert float(metrics['mean_height']) == pytest.approx(
            float(h.sum() / h.numel()), rel=1e-6)
        assert float(metrics['fallen_count']) == float(d1['fallen'].sum())
        assert float(metrics['qp_mu_max']) == float(d1['qp_mu'].max())


def test_sharded_metrics_match_jax():
    """The three global scalars of a 16-lane, 10-period sharded rollout:
    JAX on its 8-device mesh, the port on a 4-shard CPU mesh."""
    mesh_j = JPAR.data_mesh()
    c, p, k = JPAR.make_batch(16, cfg=JCFG, mesh=mesh_j)
    _, _, m_j = JPAR.make_sharded_rollout(10, mesh_j, JCFG)(c, p, k)
    mesh_t = PAR.data_mesh(4, device=CPU)
    c, p, k = PAR.make_batch(16, cfg=TCFG, mesh=mesh_t)
    _, _, m_t = PAR.make_sharded_rollout(10, mesh_t, TCFG)(c, p, k)
    assert set(m_t) == set(m_j)
    assert float(m_t['fallen_count']) == float(m_j['fallen_count']) == 0.0
    assert abs(float(m_t['mean_height'])
               - float(m_j['mean_height'])) < HEIGHT_TOL
    assert float(m_t['qp_mu_max']) == pytest.approx(
        float(m_j['qp_mu_max']), rel=MU_RTOL)
    assert 0.4 < float(m_t['mean_height']) < 0.6
    assert all(v.dtype == torch.float32 and v.dim() == 0
               for v in m_t.values())


def test_all_reduce_in_a_one_process_group(tmp_path):
    """With a torch.distributed group initialised (gloo, world size 1,
    file:// rendezvous: no network), the metrics go through all_reduce
    and come out as without a group."""
    import torch.distributed as dist
    mesh = PAR.data_mesh(2, device=CPU)
    batch = PAR.make_batch(4, mesh=mesh)
    roll = PAR.make_sharded_rollout(3, mesh, TCFG)
    _, _, alone = roll(*batch)
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/rdv',
                            world_size=1, rank=0)
    try:
        _, _, grouped = roll(*batch)
    finally:
        dist.destroy_process_group()
    assert {k: float(v) for k, v in grouped.items()} == \
        {k: float(v) for k, v in alone.items()}


WORKER = r'''
import sys
import torch
sys.path.insert(0, sys.argv[3])
torch.set_num_threads(1)
from hector_torch import parallel as PAR
rank = int(sys.argv[1])
mesh = PAR.multihost(f"file://{sys.argv[2]}", num_processes=2,
                     process_id=rank, device="cpu")
c, p, k = PAR.make_batch(8, device="cpu")
part = lambda t: PAR.shard_batch(t, PAR.data_mesh(2, device="cpu"))[rank]
_, _, m = PAR.make_sharded_rollout(3, mesh)(*([part(t)] for t in (c, p, k)))
print("METRICS", *[repr(float(m[x])) for x in sorted(m)], flush=True)
'''

# each process builds its own slice of the global batch (no hand slicing)
GLOBAL_WORKER = r'''
import sys
import torch
sys.path.insert(0, sys.argv[3])
torch.set_num_threads(1)
from hector_torch import parallel as PAR
rank = int(sys.argv[1])
mesh = PAR.multihost(f"file://{sys.argv[2]}", num_processes=2,
                     process_id=rank, device="cpu")
c, p, k = PAR.make_batch(8, mesh=mesh)
print("LANES", *[s.position.shape[0] for s in p], flush=True)
_, _, m = PAR.make_sharded_rollout(3, mesh)(c, p, k)
print("METRICS", *[repr(float(m[x])) for x in sorted(m)], flush=True)
'''


def _two_processes(worker, tmp_path):
    # the outputs of two gloo processes running ``worker`` (file://
    # rendezvous: no network)
    procs = [subprocess.Popen(
        [sys.executable, '-c', worker, str(r), str(tmp_path / 'rdv'), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return [o for o, _ in outs]


def _line(out, tag):
    return [l for l in out.splitlines() if l.startswith(tag)][0]


def _assert_whole_batch_metrics(line):
    c, p, k = PAR.make_batch(8, device=CPU)
    _, _, m = PAR.make_sharded_rollout(3, (CPU,), TCFG)((c,), (p,), (k,))
    want = [float(m[x]) for x in sorted(m)]
    got = [float(v) for v in line.split()[1:]]
    # (fallen_count, mean_height, qp_mu_max): the height sum is added in
    # another order across two processes
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == pytest.approx(want[1], rel=1e-6)


@pytest.mark.slow
def test_two_process_gloo_reduction(tmp_path):
    """Two processes, each rolling out half the batch (gloo, file://
    rendezvous): each reports the metrics of the whole batch."""
    lines = [_line(o, 'METRICS') for o in _two_processes(WORKER, tmp_path)]
    assert lines[0] == lines[1]
    _assert_whole_batch_metrics(lines[0])


@pytest.mark.slow
def test_two_process_global_batch(tmp_path):
    """make_batch(8, mesh=multihost(...)) in each of two processes: each
    holds only its 4 lanes of the global batch, and both report the
    metrics of one process's 8-lane run."""
    outs = _two_processes(GLOBAL_WORKER, tmp_path)
    assert [_line(o, 'LANES') for o in outs] == ['LANES 4'] * 2
    lines = [_line(o, 'METRICS') for o in outs]
    assert lines[0] == lines[1]
    _assert_whole_batch_metrics(lines[0])
