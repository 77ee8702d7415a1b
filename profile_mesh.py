"""The CLI's `batch` over several cards against one card.

    python3 profile_mesh.py [--batch 4096 32768] [--seconds 0.05]

Runs the path of `python -m hector_torch batch` (parallel.make_batch,
io/scenarios.random_commands, parallel.make_sharded_rollout) at the same
total batch three ways: the port's sharded rollout on a mesh of one card
and on a mesh of every card (one host thread issues every card's ops, the
shards one after another); and, on every card, each shard from a host
thread of its own (defined here, not in the port).  Each way runs once to
warm up, then twice in turns (A B C C B A), each run timed from a
synchronised start to a synchronised end; state set-up is not timed.
Prints one JSON line a run (wall seconds, simulated seconds per wall
second, the fused kernel's launches, the metrics), the card's name and
power limit, and {"ok": true, ...} last.

Checks, each fatal: the fused kernel launched once a period on each card
of the mesh and nothing else; the two ways over every card give the same
state bit for bit (the same shards on the same cards); against one card
the fallen counts are equal, the mean height within 1e-5 m and the worst
complementarity within 1 % (the bars tests/test_torch_cli.py holds the
CLI to).  Needs two or more CUDA devices; ``--device cpu`` rehearses the
script on a mesh of four CPU entries.  Imports nothing of JAX or of
hector/.
"""

import argparse
import contextlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as CS

HEIGHT_TOL = 1e-5
MU_RTOL = 1e-2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, nargs='+', default=[4096, 32768])
    ap.add_argument('--seconds', type=float, default=0.05)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    cuda = args.device == 'cuda'
    if cuda and torch.cuda.device_count() < 2:
        print('profile_mesh: needs two or more CUDA devices', file=sys.stderr)
        sys.exit(1)
    from hector_torch import parallel as PAR
    from hector_torch import prng
    from hector_torch import runtime as RT
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.io import scenarios as SC
    from hector_torch.qp import fused_riccati as FR
    from hector_torch.qp import chol as CH

    card = CS.card_line() if cuda else 'cpu'
    one = PAR.data_mesh(1, device=args.device)
    every = PAR.data_mesh(None if cuda else 4, device=args.device)
    n_periods = int(args.seconds / (CFG.mpc.dt * CFG.mpc.mpc_cadence))
    roll = RT.make_rollout(n_periods, CFG)

    def a_thread_each(carry, plant, cmd):
        """Each shard from a host thread of its own, the metrics reduced
        as the port's sharded rollout reduces them."""
        def run_shard(shard):
            c, p, k = shard
            with torch.cuda.device(p.position.device) if cuda else \
                    contextlib.nullcontext():
                c, p, d = roll(c, p, k)
                return c, p, *PAR._shard_metrics(d)

        with ThreadPoolExecutor(len(carry)) as pool:
            outs = list(pool.map(run_shard, zip(carry, plant, cmd)))
        sums = torch.stack([o[2].to(every[0]) for o in outs]).sum(0)
        mu = torch.stack([o[3].to(every[0]) for o in outs]).max()
        return (tuple(o[0] for o in outs), tuple(o[1] for o in outs),
                dict(mean_height=sums[0] / sums[1], fallen_count=sums[2],
                     qp_mu_max=mu))

    ways = {'one card': (one, PAR.make_sharded_rollout(n_periods, one, CFG)),
            'every card': (every,
                           PAR.make_sharded_rollout(n_periods, every, CFG)),
            'every card, a thread each': (every, a_thread_each)}

    def sync(mesh):
        if cuda:
            for d in set(mesh):
                torch.cuda.synchronize(d)

    def run(name, batch):
        mesh, fn = ways[name]
        key = prng.PRNGKey(0, mesh[0])
        carry, plant, _ = PAR.make_batch(batch, cfg=CFG, mesh=mesh)
        cmd = PAR.shard_batch(SC.random_commands(key, batch), mesh)
        sync(mesh)
        FR.launches = FR.polish_launches = 0
        CH.factor_launches = CH.solve_launches = 0
        t0 = time.perf_counter()
        carry, plant, metrics = fn(carry, plant, cmd)
        sync(mesh)
        sec = time.perf_counter() - t0
        launches = FR.launches
        others = FR.polish_launches + CH.factor_launches + CH.solve_launches
        metrics = {k: float(v) for k, v in metrics.items()}
        CS.emit(dict(way=name, batch=batch, devices=len(mesh),
                     periods=n_periods, seconds=sec,
                     sim_s_per_wall_s=n_periods * CFG.mpc.dt
                     * CFG.mpc.mpc_cadence / sec, launches=launches,
                     other_launches=others, metrics=metrics, card=card))
        if cuda and (launches != n_periods * len(mesh) or others):
            raise RuntimeError(f'{name}: {launches} <false> launches and '
                               f'{others} others, not {n_periods} a card')
        return PAR.gather(plant), metrics, sec

    turns = list(ways) + list(ways)[::-1]
    for batch in args.batch:
        for name in ways:
            run(name, batch)                                  # warm-up
        results = {}
        for name in turns:
            results.setdefault(name, []).append(run(name, batch))
        ref_plant, ref = results['one card'][0][:2]
        a, b = (results[n][0][0] for n in list(ways)[1:])
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f'{batch} lanes: the two ways over every '
                               f'card part')
        d_pos = float((a.position.to(ref_plant.position.device)
                       - ref_plant.position).abs().max())
        secs = {n: [r[2] for r in results[n]] for n in ways}
        CS.emit(dict(batch=batch, seconds=secs,
                     vs_one_card={n: min(s) / min(secs['one card'])
                                  for n, s in secs.items()},
                     max_abs_position_vs_one_card=d_pos, card=card))
        for name in ways:
            m = results[name][0][1]
            if not (m['fallen_count'] == ref['fallen_count']
                    and abs(m['mean_height'] - ref['mean_height'])
                    <= HEIGHT_TOL
                    and abs(m['qp_mu_max'] / ref['qp_mu_max'] - 1.0)
                    <= MU_RTOL):
                raise RuntimeError(f'{batch} lanes, {name}: {m} against '
                                   f'one card {ref}')
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu' if cuda else 'cpu',
        'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
        'count': torch.cuda.device_count() if cuda else 0}}))


if __name__ == '__main__':
    main()
