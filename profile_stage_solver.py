"""Where the time of a planning step under the stage solver goes on the card.

    python3 profile_stage_solver.py

Planning steps with ``backend='riccati'`` (hector_torch/qp/riccati.py,
batched PyTorch ops) at 4,096 closed-loop lanes, the shape of
chip_smoke.py's ``riccati`` phase, chained 8 at a time through
bench.make_chain (captured as a CUDA graph, replayed), one JSON line each:

  step           the captured chain and the eager chain, timed with CUDA
                 events, in turns with the same chains under the one
                 alternative measured (``alternative``: JAX's cho_solve as
                 two batched triangular solves, L and then L^T, for the gain
                 K and for the feed-forward, in place of the path's L^-1
                 formed once a factor and applied as two batched products);
                 how far the alternative's forces move from the path's;
  by_device_time the ops with the most device time in a torch.profiler
                 trace of the captured chain's replays (CPU and CUDA
                 activities), a step; ``traced``: the device time, the
                 traced span and the card's idle share in it, a step;
  call           each batched 12x12 call of the Riccati sweep alone at the
                 step's shapes, eager (``eager_ms``: what the host's
                 dispatch costs, a wait included) and replayed from a CUDA
                 graph of 20 calls (``graph_ms``: the device's time), with
                 how often a step makes it (``per_step``) and what it is
                 (``role``): on the path, the alternative's, or no longer
                 on the path (the two torch.cholesky_solve rows, which read
                 a status on the host at every call and so cannot be
                 captured, stand here so that one run shows what their
                 removal saved).

Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import contextlib
import json
import subprocess
import sys

import torch

BATCH = 4096
CHAIN = 8
TURNS = ('path', 'alternative', 'alternative', 'path')
TOP = 12


def emit(obj):
    print(json.dumps(obj), flush=True)


def triangular_cho_solve(ell, rhs):
    """The alternative's cho_solve, JAX's: (L L^T)^-1 rhs by a forward and
    a back substitution."""
    y = torch.linalg.solve_triangular(ell, rhs, upper=False)
    return torch.linalg.solve_triangular(ell.transpose(-1, -2), y,
                                         upper=True)


@contextlib.contextmanager
def variant(name):
    """The stage solver as the path runs it ('path': riccati._factor's
    L^-1 and riccati._cho_solve's products) or with JAX's two triangular
    solves on L in place ('alternative')."""
    from hector_torch.qp import riccati as R
    saved = R._factor, R._cho_solve
    if name == 'alternative':
        R._factor, R._cho_solve = R._cholesky, triangular_cho_solve
    try:
        yield
    finally:
        R._factor, R._cho_solve = saved


def graph_ms(fn, reps=20):
    """Milliseconds a call of fn() takes on the device: reps calls
    captured as one CUDA graph, replayed between two CUDA events after one
    replay not timed."""
    import chip_smoke as cs
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    return cs.cuda_timed(g.replay)[0] / reps


def main():
    if not torch.cuda.is_available():
        print('profile_stage_solver: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hector_torch import bench
    from hector_torch import runtime as RT
    from hector_torch.config import DEFAULT_CONFIG as CFG

    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    carry, plant, cmd = cs.scenarios(BATCH, 11, dev)
    cfg = cs.with_solver(CFG, backend='riccati')
    plan = RT.plan_step_fn(cfg)

    # ---- the step, captured and eager, the path and the alternative in
    # turns ----
    chains, finals = {}, {}
    for name in ('path', 'alternative'):
        with variant(name):
            chains[name] = bench.make_chain(plan, CHAIN).steps
            (c, _), _ = chains[name]((carry, plant), cmd)   # capture
            cs.chain(plan, carry, plant, cmd, 1)            # eager warm-up
        finals[name] = c.planner.f_ff
    ms = {(name, how): [] for name in chains for how in ('graph', 'eager')}
    for name in TURNS:
        with variant(name):
            ms[name, 'graph'].append(cs.cuda_timed(
                lambda: chains[name]((carry, plant), cmd))[0] / CHAIN)
            ms[name, 'eager'].append(cs.cuda_timed(
                lambda: cs.chain(plan, carry, plant, cmd, CHAIN))[0] / CHAIN)
    nodes = {name: cs.graph_nodes(chains[name])[0] for name in chains}
    for name in chains:
        emit(dict(phase='step', variant=name, batch=BATCH, chain=CHAIN,
                  ms_per_step=min(ms[name, 'graph']),
                  ms_per_step_turns=ms[name, 'graph'],
                  eager_ms_per_step=min(ms[name, 'eager']),
                  eager_ms_per_step_turns=ms[name, 'eager'],
                  graph_nodes=nodes[name],
                  capture_seconds=cs.capture_seconds(chains[name]),
                  max_abs_f_ff_vs_path=float(
                      (finals[name] - finals['path']).abs().max()),
                  f_ff_scale=float(finals['path'].abs().max()), card=card))

    # ---- a trace of the captured chain's replays ----
    run = chains['path']
    run((carry, plant), cmd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run((carry, plant), cmd)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return (getattr(e, 'self_device_time_total', None)
                or getattr(e, 'self_cuda_time_total', 0.0))

    for e in sorted(events, key=device_us, reverse=True)[:TOP]:
        if device_us(e) > 0:
            emit(dict(phase='by_device_time', name=e.key,
                      calls_per_step=e.count / CHAIN,
                      device_us_per_step=device_us(e) / CHAIN))
    device = cs.device_events(prof)
    idle, span = cs.idle_share(device) if device else (None, 0.0)
    emit(dict(phase='traced', steps=CHAIN,
              device_us_per_step=sum(d for _, _, d in device) / CHAIN,
              span_us_per_step=span / CHAIN, idle_share=idle,
              device_events_per_step=len(device) / CHAIN,
              device_time_seen=bool(device), card=card))

    # ---- the sweep's batched calls alone, at the step's shapes ----
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((BATCH, 12, 12), generator=gen, device=dev)
    re = x @ x.transpose(1, 2) + torch.eye(12, device=dev)
    ell = torch.linalg.cholesky(re)
    ell_t = ell.transpose(-1, -2)
    g = torch.randn((BATCH, 12, 13), generator=gen, device=dev)
    p = torch.randn((BATCH, 13, 13), generator=gen, device=dev)
    beta = g[..., :1].contiguous()
    from hector_torch.qp import riccati as R
    linv = R._factor(re)
    # a step: the start's backward sweep and one an iteration, each with a
    # linear sweep; one more linear sweep an iteration (Mehrotra)
    it, h = CFG.solver.iterations, CFG.mpc.horizon
    factors, solves = (it + 1) * h, (2 * it + 1) * h
    path, alt, gone = 'on the path', 'the alternative', 'no longer on the path'
    calls = {
        'cholesky_ex': (path, factors, lambda: torch.linalg.cholesky_ex(re)),
        'inverse_of_L': (path, factors, lambda: R._factor(re)),
        'cho_solve_13_columns': (path, factors,
                                 lambda: R._cho_solve(linv, g)),
        'cho_solve_1_column': (path, solves,
                               lambda: R._cho_solve(linv, beta)),
        'matmul_12x13_13x13': (path, None, lambda: g @ p),
        'triangular_cho_solve_13_columns': (
            alt, factors, lambda: triangular_cho_solve(ell, g)),
        'triangular_cho_solve_1_column': (
            alt, solves, lambda: triangular_cho_solve(ell, beta)),
        'solve_triangular_lower_13_columns': (
            alt, factors,
            lambda: torch.linalg.solve_triangular(ell, g, upper=False)),
        'solve_triangular_upper_13_columns': (
            alt, factors,
            lambda: torch.linalg.solve_triangular(ell_t, g, upper=True)),
        'solve_triangular_lower_1_column': (
            alt, solves,
            lambda: torch.linalg.solve_triangular(ell, beta, upper=False)),
        'solve_triangular_upper_1_column': (
            alt, solves,
            lambda: torch.linalg.solve_triangular(ell_t, beta, upper=True)),
        'cholesky_solve_13_columns': (gone, factors,
                                      lambda: torch.cholesky_solve(g, ell)),
        'cholesky_solve_1_column': (gone, solves,
                                    lambda: torch.cholesky_solve(beta, ell)),
    }
    for name, (role, per_step, fn) in calls.items():
        eager_ms = cs.cuda_ms(fn, 20)
        dev_ms = None if role == gone else graph_ms(fn)
        emit(dict(phase='call', name=name, role=role, batch=BATCH,
                  eager_ms=eager_ms, graph_ms=dev_ms, per_step=per_step,
                  eager_ms_per_step=None if per_step is None
                  else eager_ms * per_step,
                  graph_ms_per_step=None if per_step is None or dev_ms is None
                  else dev_ms * per_step, card=card))
    print(card, flush=True)


if __name__ == '__main__':
    main()
