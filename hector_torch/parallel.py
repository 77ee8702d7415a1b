"""Scenario data parallelism: a mesh of devices, the scenario batch split
over it, and the metrics reduced across it (port of ``hector/parallel.py``).

The reference is single-process and single-robot (SURVEY.md §2.4); scale
comes from splitting the scenario batch over devices:

- a mesh is an ordered tuple of devices; :func:`shard_batch` splits a
  batch-first tree into contiguous chunks, one per device, as JAX's
  ``P('data')`` lays a batch over a ``('data',)`` mesh;
- each device runs ``runtime.make_rollout`` on its own chunk (on the card,
  the fused Riccati kernel once a period); per-scenario state never
  crosses a device;
- only three scalars do: the mean height, the fallen count and the worst
  complementarity, combined across the mesh and, in a multi-process run
  (:func:`multihost`: one card a process, each holding its slice of the
  global batch), ``all_reduce``d across processes (SUM, SUM, MAX).

A sharded tree is a tuple of per-device trees (:func:`gather` joins them).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from . import prng, resolve_device
from . import runtime as RT
from .graph import leaves as _leaves, tree_map as _map
from .config import HectorConfig, DEFAULT_CONFIG
from .plant import srb

Mesh = Tuple[torch.device, ...]


def data_mesh(n_devices: Optional[int] = None, device='cuda') -> Mesh:
    """The devices of the mesh, in order: the first ``n_devices`` cards
    (all of them by default) for 'cuda'; for 'cpu', ``n_devices`` (default
    1) entries of the one CPU device, so that a CPU run can split its
    batch as a run over several cards would."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return (dev,) * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 0 < n <= count:
        raise ValueError(f'{n} devices asked for, {count} present')
    return tuple(torch.device('cuda', i) for i in range(n))


def multihost(coordinator: Optional[str] = None, num_processes: int = 1,
              process_id: int = 0, device='cuda') -> Mesh:
    """Join a multi-process run, then build this process's mesh.

    With more than one process, or a ``coordinator`` (an init method such
    as 'tcp://host:port' or 'file:///path') given, this initialises the
    default ``torch.distributed`` group as rank ``process_id`` of
    ``num_processes``, and the mesh is this process's own device: on the
    card one card, ``LOCAL_RANK`` when the launcher sets it, else
    ``process_id`` modulo the cards present, made the current device and
    handed to NCCL (which takes one rank a card); on the CPU the one CPU
    device, under gloo.  :func:`make_batch` then builds only this
    process's slice of the global batch, and the sharded rollout's metrics
    are reduced across the processes.  Without either it is
    :func:`data_mesh`, every card of the process."""
    if num_processes <= 1 and coordinator is None:
        return data_mesh(device=device)
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == 'cuda':
        index = int(os.environ.get('LOCAL_RANK',
                                   process_id % torch.cuda.device_count()))
        dev = torch.device('cuda', index)
        torch.cuda.set_device(dev)
        dist.init_process_group('nccl', init_method=coordinator,
                                world_size=num_processes, rank=process_id,
                                device_id=dev)
    else:
        dist.init_process_group('gloo', init_method=coordinator,
                                world_size=num_processes, rank=process_id)
    return (dev,)


def shard_batch(tree, mesh: Sequence[torch.device]):
    """Split a batch-first tree (a NamedTuple of (B, ...) tensors, nested
    allowed) into ``len(mesh)`` contiguous chunks, chunk i on ``mesh[i]``.
    The batch must divide evenly, as for ``P('data')``."""
    bsz = _leaves(tree)[0].shape[0]
    if bsz % len(mesh):
        raise ValueError(f'batch {bsz} does not split evenly over '
                         f'{len(mesh)} devices')
    size = bsz // len(mesh)
    return tuple(_map(lambda x: x[i * size:(i + 1) * size].to(dev), tree)
                 for i, dev in enumerate(mesh))


def gather(shards):
    """The per-device trees of a sharded tree joined along the batch axis,
    on the first shard's device."""
    device = _leaves(shards[0])[0].device
    return RT.concat(*[_map(lambda x: x.to(device), s) for s in shards])


def make_batch(batch: int, cmd_fn=None, cfg: HectorConfig = DEFAULT_CONFIG,
               mesh: Optional[Sequence[torch.device]] = None, seed: int = 0,
               device='cuda'):
    """(carry, plant, cmd) for ``batch`` scenarios, on ``device``, or split
    over ``mesh`` (then each is a tuple of per-device trees).

    In a multi-process run (a ``torch.distributed`` group initialised, as
    :func:`multihost` does) with a mesh given, ``batch`` is the global
    batch: rank r of P builds only lanes [r B/P, (r+1) B/P) and splits them
    over its mesh, so the lanes lie over every process's devices as JAX's
    ``P('data')`` lays them over a global mesh.  ``batch`` must then split
    evenly over the processes and their devices.

    cmd_fn: global lane indices (n,) -> a batched ScenarioCommand; the
    default walks forward at speeds spread over the teleop envelope
    (FSMState_Walking.cpp:30, vx in [-0.75, 0.75] over the global batch).
    Each lane's estimator noise stream is keyed
    ``fold_in(PRNGKey(seed), lane)`` by its global index."""
    dev = mesh[0] if mesh is not None else resolve_device(device)
    rank, world = _process_index() if mesh is not None else (0, 1)
    if mesh is not None and batch % (world * len(mesh)):
        raise ValueError(f'batch {batch} does not split evenly over {world} '
                         f'processes of {len(mesh)} devices')
    size = batch // world
    plant = srb.init_plant_state(size, cfg, device=dev)
    lanes = torch.arange(rank * size, (rank + 1) * size, device=dev)
    carry = RT.init_controller_carry(
        plant, cfg, key=prng.fold_in(prng.PRNGKey(seed, dev), lanes))
    if cmd_fn is None:
        vx = torch.linspace(-0.75, 0.75, batch, dtype=torch.float64,
                            device=dev)

        def cmd_fn(i):
            cmd = RT.walking_command(i.shape[0], device=dev)
            return cmd._replace(vx=vx[i].to(cmd.vx.dtype))

    cmd = cmd_fn(lanes)
    if mesh is not None:
        carry, plant, cmd = (shard_batch(t, mesh)
                             for t in (carry, plant, cmd))
    return carry, plant, cmd


def _process_index():
    """(rank, world size) of this process in the default torch.distributed
    group, (0, 1) when none is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_metrics(diags):
    """The three global scalars of one rollout's diagnostics (every axis):
    (sum of heights, number of heights, fallen count) to add and the
    largest complementarity to take the max of, as float32 tensors on the
    diagnostics' device."""
    height = diags['height'].to(torch.float32)
    total = height.sum()
    sums = torch.stack([total, torch.full_like(total, height.numel()),
                        diags['fallen'].to(torch.float32).sum()])
    return sums, diags['qp_mu'].to(torch.float32).max()


def make_sharded_rollout(n_periods: int, mesh: Sequence[torch.device],
                         cfg: HectorConfig = DEFAULT_CONFIG):
    """The closed-loop rollout over a mesh and its metric reduction.

    Returns rollout(carry, plant, cmd) -> (carry', plant', metrics) over
    sharded trees (make_batch(mesh=...), shard_batch): each device runs
    ``runtime.make_rollout`` on its shard (the fused kernel on the card),
    the shards one after another from this thread, and only the scalar
    metrics cross devices: mean_height (sum of heights over their
    number), fallen_count (a sum) and qp_mu_max (a max), 0-d float32
    tensors on ``mesh[0]``, reduced over every process of an initialised
    ``torch.distributed`` group too.  On a one-device mesh the state is
    bit for bit that of make_rollout on the whole batch.

    In a multi-process run each process holds only its slice of the
    global lanes (make_batch under :func:`multihost`) on its own mesh, the
    returned state is that slice, and the metrics, reduced from ``mesh[0]``
    (the process's own card), are those of the whole global batch in
    every process.

    Each card's rollout is its own capture, one CUDA graph launch a period
    from this thread (runtime.make_rollout), so the cards run at once: on
    four H100s the same total batch took 0.81x and 0.50x one card's time
    at 4,096 and 32,768 lanes, a host thread a card 0.88x and 0.51x
    (profile_mesh.py; 3.3-3.8x and 21-22x while the period ran eagerly)."""
    roll = RT.make_rollout(n_periods, cfg)
    home = mesh[0]

    def rollout(carry, plant, cmd):
        outs, sums, mu = [], [], []
        for c, p, k in zip(carry, plant, cmd, strict=True):
            c, p, diags = roll(c, p, k)
            s, m = _shard_metrics(diags)
            outs.append((c, p))
            sums.append(s.to(home))
            mu.append(m.to(home))
        sums = torch.stack(sums).sum(0)
        mu = torch.stack(mu).max()
        sums, mu = _all_reduce(sums, mu)
        metrics = dict(mean_height=sums[0] / sums[1], fallen_count=sums[2],
                       qp_mu_max=mu)
        carry, plant = (tuple(x) for x in zip(*outs))
        return carry, plant, metrics

    return rollout


def _all_reduce(sums, mu):
    """sums (SUM) and mu (MAX) over the processes of the default
    torch.distributed group, when one is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(mu, op=dist.ReduceOp.MAX)
    return sums, mu
