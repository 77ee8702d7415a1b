"""Reduction of a torch.profiler trace to what the per-layer metrics and
the breakdown read.

``device_events`` and the union in ``busy_us`` are frozen from
chip_smoke.py (``device_events``, ``idle_share``) at commit dc0bcd9; the
idle share is read against the wall time of the same units run
unprofiled, as chip_smoke.py's ``unprofiled_idle_share`` does, since the
profiled span carries the profiler's own cost.
"""

from __future__ import annotations

import math

import torch

# the port's hand-written kernels, by a piece of their (mangled or
# demangled) names; everything else on the device is a small op of
# PyTorch or of a library
FUSED_FALSE = ('fused_riccati_warp_kernelILb0E',
               'fused_riccati_warp_kernel<false>')
FUSED_TRUE = ('fused_riccati_warp_kernelILb1E',
              'fused_riccati_warp_kernel<true>')
CHOL = ('chol_factor', 'chol_solve')
PORT_KERNELS = FUSED_FALSE + FUSED_TRUE + CHOL


def device_events(prof):
    """The device activities (kernels, copies, fills) of a torch.profiler
    run, as (name, start us, duration us)."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.start,
                        evt.time_range.end - evt.time_range.start))
    return out


def host_events(prof):
    """The host activities of a torch.profiler run, as (name, start us,
    duration us)."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            out.append((evt.name, evt.time_range.start,
                        evt.time_range.end - evt.time_range.start))
    return out


def matches(name, pieces):
    return any(p in name for p in pieces)


def device_us(events, pieces=None, exclude=None):
    """Summed duration (us) of the events whose name holds one of
    ``pieces`` (all when None) and none of ``exclude``."""
    return sum(d for n, _, d in events
               if (pieces is None or matches(n, pieces))
               and (exclude is None or not matches(n, exclude)))


def _spans(events):
    return sorted((t0, t0 + d) for _, t0, d in events)


def busy_us(events):
    """The time (us) in which some device activity runs: the union of the
    events' spans."""
    busy, end = 0.0, -math.inf
    for t0, t1 in _spans(events):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def idle_gaps(events, hosts, top=10):
    """The longest stretches in which no device activity runs, between the
    first start and the last end, each named by the host activity that
    overlaps it most (the shortest such among equals): [(name, seconds)]."""
    gaps, end = [], -math.inf
    for t0, t1 in _spans(events):
        if t0 > end > -math.inf:
            gaps.append((end, t0))
        end = max(end, t1)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        best, key = 'no host activity', None
        for name, h0, d in hosts:
            overlap = min(g1, h0 + d) - max(g0, h0)
            if overlap <= 0:
                continue
            k = (overlap, -d)
            if key is None or k > key:
                best, key = name, k
        out.append([f'host: {best}', (g1 - g0) * 1e-6])
    return out


def top_ops(events, launches=None, units=1, top=10):
    """The device ops that took most time, summed by name: [(name with its
    launches a unit, seconds)]; ``launches`` maps a piece of a kernel's
    name to its launches a unit by the port's counters, for the kernels
    that have one, else the trace's own count is given."""
    by_name, count = {}, {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0.0) + d
        count[name] = count.get(name, 0) + 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = []
    for name, us in ranked:
        per_unit = count[name] / units
        label = f'{per_unit:g} a unit in the trace'
        for piece, n in (launches or {}).items():
            if piece in name:
                label = f'{n:g} a unit by counter'
        out.append([f'{name[:150]} ({label})', us * 1e-6])
    return out


# a piece of each port kernel's name -> the port's launch counter of it
# (graph.kernel_counters)
COUNTED = {
    'fused_riccati_warp_kernelILb0E': 'launches',
    'fused_riccati_warp_kernel<false>': 'launches',
    'fused_riccati_warp_kernelILb1E': 'polish_launches',
    'fused_riccati_warp_kernel<true>': 'polish_launches',
    'chol_factor_kernel': 'factor_launches',
    'chol_factor_cluster_kernel': 'factor_cluster_launches',
    'chol_factor_smem_kernel': 'factor_shared_launches',
    'chol_solve_kernel': 'solve_launches',
    'chol_solve_stream_kernel': 'solve_stream_launches',
    'chol_solve_smem_kernel': 'solve_shared_launches',
}


def per_unit_ms(ctx, pieces=None, exclude=None):
    """Device milliseconds a traced unit in the events named by
    ``pieces`` (all when None) and not by ``exclude``; None when no such
    event ran."""
    if pieces is not None and not any(matches(n, pieces)
                                      for n, _, _ in ctx.events):
        return None
    if not ctx.events:
        return None
    return device_us(ctx.events, pieces, exclude) / 1e3 / ctx.units


def idle_percent(ctx):
    """100 x (1 - the union of device activity a unit / the unprofiled
    wall time a unit), over the chips; None without device events."""
    if not ctx.events:
        return None
    busy_s = busy_us(ctx.events) * 1e-6 / ctx.units / ctx.chips
    return 100.0 * (1.0 - busy_s / ctx.unit_wall_s)
