"""Where the time of a planning step under the stage solver goes on the card.

    python3 profile_stage_solver.py

One planning step with ``backend='riccati'`` (hector_torch/qp/riccati.py,
batched PyTorch ops) at 4,096 closed-loop lanes, the shape of
chip_smoke.py's ``riccati`` phase: the step timed with CUDA events, then
traced with torch.profiler (CPU and CUDA activities), printing the ops with
the most device time and the most host time, one JSON line each; then the
two batched 12x12 linear-algebra calls of the Riccati sweep alone, timed
with CUDA events.  Needs one CUDA device.
"""

import json
import subprocess
import sys

import torch

BATCH = 4096
TOP = 12


def main():
    if not torch.cuda.is_available():
        print('profile_stage_solver: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hector_torch import runtime as RT
    from hector_torch.config import DEFAULT_CONFIG as CFG

    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    carry, plant, cmd = cs.scenarios(BATCH, 11, dev)
    plan = RT.plan_step_fn(cs.with_solver(CFG, backend='riccati'))
    step_ms = cs.cuda_ms(lambda: plan(carry, plant, cmd), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plan(carry, plant, cmd)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e, self_only=False):
        pre = 'self_' if self_only else ''
        return (getattr(e, f'{pre}device_time_total', None)
                or getattr(e, f'{pre}cuda_time_total', 0.0))

    total_device = sum(device_us(e, True) for e in events)
    total_host = sum(e.self_cpu_time_total for e in events)
    rows = sorted(events, key=device_us, reverse=True)[:TOP]
    print(json.dumps(dict(phase='step', batch=BATCH, ms=step_ms,
                          ops=sum(e.count for e in events),
                          card=card)), flush=True)
    for e in rows:
        print(json.dumps(dict(phase='by_device_time', name=e.key,
                              calls=e.count, device_us=device_us(e),
                              cpu_us=e.cpu_time_total)), flush=True)
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:TOP]:
        print(json.dumps(dict(phase='by_host_time', name=e.key,
                              calls=e.count,
                              self_cpu_us=e.self_cpu_time_total,
                              device_us=device_us(e))), flush=True)
    print(json.dumps(dict(phase='traced', device_us=total_device,
                          host_us=total_host,
                          device_time_seen=total_device > 0)), flush=True)

    # the Riccati sweep's two library calls alone, at the step's shapes
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((BATCH, 12, 12), generator=gen, device=dev)
    re = x @ x.transpose(1, 2) + torch.eye(12, device=dev)
    ell = torch.linalg.cholesky(re)
    g = torch.randn((BATCH, 12, 13), generator=gen, device=dev)
    p = torch.randn((BATCH, 13, 13), generator=gen, device=dev)
    beta = g[..., :1].contiguous()
    calls = {
        'cholesky_ex': lambda: torch.linalg.cholesky_ex(re),
        'cholesky_solve_13_columns': lambda: torch.cholesky_solve(g, ell),
        'cholesky_solve_1_column': lambda: torch.cholesky_solve(beta, ell),
        'matmul_12x13_13x13': lambda: g @ p}
    for name, fn in calls.items():
        print(json.dumps(dict(phase='call', name=name, batch=BATCH,
                              ms=cs.cuda_ms(fn, 20), card=card)), flush=True)
    print(card, flush=True)


if __name__ == '__main__':
    main()
