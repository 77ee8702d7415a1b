"""The benchmark of the PyTorch + CUDA port (``hector_torch``) on the card.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell once, from the root of a checkout: it loads and warms up
(set-up), measures for ``--seconds``, checks what the timed path produced
against the plain reference (cardbench/reference/), and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` in a traced run, and ``checks`` (each compared number beside
its limit), which the same numbers on the last lines of standard error
repeat.  With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from a torch.profiler trace of
a few units after the window.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<mix>.json``, the mix's kind in ``traffic/<kind>.py``, and each
per-layer metric that BENCHMARK.json gives the cell in
``metrics/<metric>.py``.

No card, or fewer than the cell asks for: exit 2, no result.  JAX, jaxlib,
flax or the JAX package ``hector`` loaded in this process: exit 3, no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset(('jax', 'jaxlib', 'flax', 'hector'))

# the kernel caches of anything the run builds, at fixed paths inside the
# checkout (the port builds its own CUDA sources into hector_torch/_build/)
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = str(ROOT / '.cardbench_cache' / _sub)

import torch  # noqa: E402


class NoCard(RuntimeError):
    pass


def load_json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """The top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole (``hector_torch`` is not ``hector``)."""
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def cell_spec(workload):
    """(BENCHMARK.json, its entry for the cell, the cell's file, its
    configuration, its traffic mix)."""
    bench = load_json(ROOT / 'BENCHMARK.json')
    entry, = [w for w in bench['workloads'] if w['name'] == workload]
    cell = load_json(HERE / 'workloads' / f'{workload}.json')
    for key in ('config', 'traffic', 'chips'):
        if cell[key] != entry[key]:
            raise ValueError(f'{workload}: {key} is {cell[key]!r} in its '
                             f'file, {entry[key]!r} in BENCHMARK.json')
    config = load_json(HERE / 'configs' / f"{cell['config']}.json")
    mix = load_json(HERE / 'traffic' / f"{cell['traffic']}.json")
    return bench, entry, cell, config, mix


def cell_metrics(bench, workload, end_to_end):
    """The cell's end-to-end metrics (those it reports, of
    ``end_to_end``, the names its traffic kind measures) and per-layer
    metrics, as BENCHMARK.json lists them."""
    def listed(m):
        return 'workloads' not in m or workload in m['workloads']

    e2e = [m for m in bench['end_to_end'] if listed(m)
           and (m['name'] == 'setup_s' or m['name'] in end_to_end)]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (workload in m['workloads'] if 'workloads' in m
                 else m['moves'] in names)]
    return e2e, layer


def load_metric(name):
    spec = importlib.util.spec_from_file_location(
        f'cardbench_metric_{name}', HERE / 'metrics' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line(fields='name,power.limit'):
    """What nvidia-smi reads of the cards: by default the name and power
    limit."""
    try:
        return subprocess.run(
            ['nvidia-smi', f'--query-gpu={fields}', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not readable'


class TraceContext:
    """What a per-layer metric reads: the traced units' device and host
    events (yardstick/trace.py), their number, the window's unprofiled wall
    time a unit (a traced unit's where a kind traces the window's own
    units, as the planning kind does), the port's launch counters over the
    traced units, and the traffic's work counts."""

    def __init__(self, events, hosts, units, unit_wall_s, launches, work,
                 chips):
        self.events, self.hosts, self.units = events, hosts, units
        self.unit_wall_s, self.launches, self.work = (unit_wall_s, launches,
                                                      work)
        self.chips = chips


def trace_units(traffic, n, devices, window_unit_s):
    """Profile ``n`` units after the window: (TraceContext, busy seconds,
    the traced span's wall seconds)."""
    from hector_torch import graph
    from .yardstick import compare, trace as T
    counters = graph.kernel_counters()
    run = traffic.traced(n)
    compare.sync(devices)
    before = [getattr(o, a) for o, a in counters]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if devices[0].type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        compare.sync(devices)
        span = time.perf_counter() - t0
    launches = {a: (getattr(o, a) - b) / n
                for (o, a), b in zip(counters, before)}
    events, hosts = T.device_events(prof), T.host_events(prof)
    ctx = TraceContext(events, hosts, n, window_unit_s, launches,
                       traffic.work(), len(devices))
    busy = T.busy_us(events) * 1e-6 / len(devices)
    return ctx, busy, span


def cell_parts(workload, device='cuda'):
    """What a run of the cell builds on: (BENCHMARK.json, the cell's file,
    its traffic mix, the port's config, the reference's config, the
    traffic kind's module, the devices)."""
    from .yardstick import compare
    import hector_torch  # noqa: F401  (sets TF32 off, as the port runs)
    from hector_torch.config import DEFAULT_CONFIG
    from .reference.config import DEFAULT_CONFIG as REF_DEFAULT
    bench, _, cell, config, mix = cell_spec(workload)
    cfg = compare.port_config(DEFAULT_CONFIG, config)
    ref_cfg = compare.port_config(REF_DEFAULT, config)
    kind = importlib.import_module(f'.traffic.{mix["kind"]}', __package__)
    if device == 'cuda':
        devices = [torch.device('cuda', i) for i in range(cell['chips'])]
    else:
        devices = [torch.device(device)] * cell['chips']
    return bench, cell, mix, cfg, ref_cfg, kind, devices


def run(workload, seed, seconds, trace, device='cuda', log=sys.stderr):
    """One run of a cell: the result line's object (checks last).  On
    ``device='cpu'`` (the tests) nothing asks for a card and the window
    drives the port's plain versions."""
    from .yardstick import compare, trace as T
    chips = cell_spec(workload)[2]['chips']
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise NoCard('no CUDA device is available')
        if torch.cuda.device_count() < chips:
            raise NoCard(f'{chips} cards asked for, '
                         f'{torch.cuda.device_count()} present')
        print(f'card: {card_line()}', file=log, flush=True)
    bench, cell, mix, cfg, ref_cfg, kind, devices = cell_parts(workload,
                                                               device)
    e2e, layer = cell_metrics(bench, workload, kind.END_TO_END)

    traffic = kind.Traffic(mix, cfg, ref_cfg, seed, devices)
    traffic.warm()
    compare.sync(devices)
    setup_s = time.perf_counter() - T_START

    def device_allocs():
        return sum(torch.cuda.memory_stats(d).get('num_device_alloc', 0)
                   for d in devices) if device == 'cuda' else 0

    allocs = device_allocs()
    latencies, work = [], 0.0
    t0 = time.perf_counter()
    while True:
        dt, w = traffic.unit()
        latencies.append(dt)
        work += w
        if time.perf_counter() - t0 >= seconds:
            break
    compare.sync(devices)
    window_s = time.perf_counter() - t0
    attempted, failed = traffic.attempted(work), traffic.failed()
    cuts = (statistics.quantiles(latencies, n=100, method='inclusive')
            if len(latencies) > 1 else latencies * 99)
    print(f'window: {len(latencies)} units in {window_s:.4f} s; unit '
          f'seconds min {min(latencies):.5f} p50 {cuts[49]:.5f} p90 '
          f'{cuts[89]:.5f} p95 {cuts[94]:.5f} p99 {cuts[98]:.5f} max '
          f'{max(latencies):.5f}; the first '
          f'{[round(x, 4) for x in latencies[:12]]}; device allocations '
          f'{device_allocs() - allocs}', file=log)
    if device == 'cuda':
        print('card after the window (sm clock, memory clock, power, '
              'temperature, throttle reasons): ' + card_line(
                  'clocks.sm,clocks.mem,power.draw,temperature.gpu,'
                  'clocks_throttle_reasons.active'), file=log, flush=True)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if device == 'cuda' else 0)

    dev_info = {'platform': 'gpu' if device == 'cuda' else device,
                'kind': (torch.cuda.get_device_name(devices[0])
                         if device == 'cuda' else device),
                'count': chips, 'memory_peak_bytes': peak}
    metrics, breakdown = {}, None
    if trace:
        ctx, busy, span = trace_units(traffic, mix['trace_units'], devices,
                                      window_s / len(latencies))
        for m in layer:
            value = load_metric(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        dev_info.update(busy_s=busy, window_s=span)
        per_unit = {}
        for piece, attr in T.COUNTED.items():
            if ctx.launches.get(attr):
                per_unit[piece] = ctx.launches[attr]
        breakdown = {
            'device_ops': T.top_ops(ctx.events, per_unit, ctx.units),
            'idle_gaps': T.idle_gaps(ctx.events, ctx.hosts)}
    else:
        measured = kind.Traffic.end_to_end(latencies, work, window_s)
        measured['setup_s'] = (setup_s, 's')
        for m in e2e:
            value, unit = measured[m['name']]
            metrics[m['name']] = {'value': value, 'unit': unit}

    traffic.release()
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = traffic.check()
    limits = cell['limits']
    correct = all(values[k] <= limits[k] for k in limits)
    print(f'check: {time.perf_counter() - t_check:.1f} s; every number '
          f'read: {json.dumps(values)}', file=log, flush=True)
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = {k: {'value': values[k], 'limit': limits[k]}
                        for k in sorted(limits)}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, args.trace)
    except NoCard as e:
        print(f'cardbench: {e}; the benchmark runs on the card only',
              file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f'cardbench: this process loaded {", ".join(found)}; the '
              f'benchmark measures hector_torch without JAX',
              file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
