"""Profiling hooks: step timers, device traces, kernel roofline accounting
(port of ``hector/io/profiling.py``).

The reference's instrumentation is a CLOCK_MONOTONIC Timer printed in the
hot loops (include/common/Utilities/Timer.h:15-48 around the QP solve at
SolverMPC.cpp:699,717).  Here: a phase timer that synchronises the devices
its outputs live on (on an asynchronous runtime, wall-clocking an
unsynchronised launch measures the enqueue), ``torch.profiler`` traces for
kernel-level views, and the JAX package's analytic bytes/FLOPs model of the
fused Riccati kernel for speed-of-light reports against the H100's
published peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch


def synchronize(tree) -> None:
    """Wait for the work behind every CUDA tensor in ``tree`` (tensors,
    tuples, lists, dicts): one synchronisation per device."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Step timing


class StepTimer:
    """Named-phase wall timer with device synchronisation.

    Every phase's end synchronises the devices of its outputs, so its time
    includes their device work:

        timer = StepTimer()
        with timer.phase("plan", out):
            ...
        out = timer.time_fn("plan", plan, carry, plant, cmd)
        timer.summary()  # {"plan": {"mean_ms": ..., "count": ...}, ...}
    """

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *sync_on):
        t0 = time.perf_counter()
        yield
        synchronize(sync_on)
        self._samples.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, synchronise on its outputs, record; returns the
        outputs."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        self._samples.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: dict(mean_ms=1e3 * float(np.mean(s)),
                       p50_ms=1e3 * float(np.median(s)),
                       max_ms=1e3 * float(np.max(s)),
                       count=len(s))
            for name, s in self._samples.items()
        }


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    when a card is present); writes ``logdir/trace.json``, a Chrome trace.
    Yields the profiler (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


# ---------------------------------------------------------------------------
# Roofline model of the fused Riccati interior-point kernel
# (hector/qp/pallas_riccati.py; here csrc/fused_riccati_warp.cu).  Counts
# are analytic, from the kernel's algorithm structure; dims from the Hector
# QP family (SolverMPC.cpp): h=10 stages, nx=13, nu=12, nc=16 rows/stage.


@dataclasses.dataclass(frozen=True)
class KernelCost:
    bytes_per_solve: float     # HBM traffic (problem read + solution write)
    flops_per_solve: float     # f32 flops
    arithmetic_intensity: float


def riccati_kernel_cost(iterations: int = 14, h: int = 10, nx: int = 13,
                        nu: int = 12, nc: int = 16) -> KernelCost:
    """Per-scenario cost of one fused interior-point solve.

    HBM bytes: the solve runs out of on-chip memory; traffic is one
    problem-data read (StageQPData: structure blocks s69 (54) + b69 (54) +
    scalars (~8) + C rows (nc*nu sparse -> 40 stored) + per-stage
    masks/bounds h*(nu + 2*nc) + x0 (nx) + xd (h*nx)) and one solution
    write (h*nu + diagnostics 3), float32.

    FLOPs (per interior-point iteration, per scenario, counted from the
    kernel's stage loops):
      - residual/rollout passes: ~4 sweeps of h stages of A x (+~60 madds
        sparse) and B u (~72 madds) and C u / C^T y (~80 madds sparse)
      - backward Riccati sweep: per stage, form Re (nu^2 * nx madds
        structure-reduced ~ nu^2*6), Cholesky nu^3/3, two triangular solves
        nu^3 (W formation dominates: nu^2 * nx), W^T W rank-nx update nu^2*nx
      - forward rollout + line search + iterate updates: ~h*(nc*8 + nu*6)
    The dominant stage term is ~(nu^3/3 + 2*nu^2*nx + nu^2*6) ~ 2700 madds
    -> ~5400 flops/stage; plus ~1500 flops/stage of sweeps/updates.
    """
    problem_floats = (54 + 54 + 8 + 40 + h * (nu + 2 * nc) + nx + h * nx)
    solution_floats = h * nu + 3
    bytes_per_solve = 4.0 * (problem_floats + solution_floats)

    stage_factor = (nu ** 3 / 3 + 2 * nu ** 2 * nx + 6 * nu ** 2) * 2
    sweep_flops = (60 + 72 + 80) * 2 * 4          # 4 passes/iter, madds*2
    misc = (nc * 8 + nu * 6) * 2
    flops_per_iter = h * (stage_factor + sweep_flops + misc)
    flops = float(iterations * flops_per_iter)
    return KernelCost(
        bytes_per_solve=bytes_per_solve,
        flops_per_solve=flops,
        arithmetic_intensity=flops / bytes_per_solve)


# NVIDIA H100 SXM, published peaks (data sheet, dense, at the 700 W limit):
# HBM3 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.  Published,
# not measured; a card set below 700 W reaches less.
H100_CARD = 'NVIDIA H100 SXM'
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0


def roofline_report(measured_solves_per_s: float,
                    iterations: int = 14,
                    hbm_gbps: float = H100_HBM_GBPS,
                    fp32_tflops: float = H100_FP32_TFLOPS,
                    peaks_measured: bool = False) -> dict:
    """Speed-of-light comparison for the fused solve kernel on the H100.

    peaks_measured=True marks hbm_gbps / fp32_tflops as measured on the
    card rather than the published peaks above; the emitted key names and
    note say which."""
    cost = riccati_kernel_cost(iterations)
    sol_bw = hbm_gbps * 1e9 / cost.bytes_per_solve
    sol_compute = fp32_tflops * 1e12 / cost.flops_per_solve
    bound = 'compute(FP32)' if sol_compute < sol_bw else 'bandwidth(HBM)'
    sol = min(sol_bw, sol_compute)
    compute_key = ('speed_of_light_compute_measured' if peaks_measured
                   else 'speed_of_light_compute_published')
    rep = dict(
        measured_solves_per_s=measured_solves_per_s,
        bytes_per_solve=cost.bytes_per_solve,
        flops_per_solve=cost.flops_per_solve,
        arithmetic_intensity=round(cost.arithmetic_intensity, 1),
        speed_of_light_bandwidth=sol_bw,
        binding_resource=bound,
        fraction_of_speed_of_light=measured_solves_per_s / sol,
        achieved_hbm_gbps=measured_solves_per_s * cost.bytes_per_solve / 1e9,
        achieved_fp32_tflops=measured_solves_per_s * cost.flops_per_solve
        / 1e12,
        fp32_peak_tflops=fp32_tflops,
        hbm_peak_gbps=hbm_gbps,
        card=H100_CARD,
        note=('peaks measured on this card; the tensor cores are idle by '
              'design (per-lane matrices share no operands)'
              if peaks_measured else
              'peaks as published for the H100 SXM, not measured; the '
              'tensor cores are idle by design (per-lane matrices share no '
              'operands)'))
    rep[compute_key] = sol_compute
    return rep
