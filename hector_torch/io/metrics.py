"""Structured run metrics and host-side logging (port of
``hector/io/metrics.py``).

Replaces the reference's printf-in-the-hot-loop observability (solve times
at SolverMPC.cpp:717, trajectory dumps at ConvexMPCLocomotion.cpp:400-404)
with metrics reduced on the device (parallel.make_sharded_rollout), fetched
to the host once per rollout chunk and appended to a JSONL log, and a step
timer after the reference's Timer (include/common/Utilities/Timer.h).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch


def _host(v):
    """A tensor, array or number as a Python float; anything else as it
    is (what the JSON record holds)."""
    if isinstance(v, torch.Tensor):
        return float(v.detach().cpu())
    if hasattr(v, 'shape') or isinstance(v, (int, float, np.floating)):
        return float(np.asarray(v))
    return v


class MetricsLogger:
    """Append-only JSONL metrics log; one line per rollout chunk."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, 'a') if path else None
        self.history = []

    def log(self, step: int, metrics: dict, **extra) -> dict:
        rec = {'step': step, 't': time.time()}
        for k, v in {**metrics, **extra}.items():
            rec[k] = _host(v)
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + '\n')
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()


class StepTimer:
    """Wall-clock timer (the Timer.h analog); the caller synchronises the
    device around a timed region (io.profiling.StepTimer does so)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def restart(self) -> None:
        self.t0 = time.perf_counter()


def summarize_rollout(diags) -> dict:
    """Host-side summary of stacked rollout diagnostics, reduced over every
    axis ((B, n_periods) here; (n_periods,) for one lane in the JAX
    package)."""
    def host(name):
        return diags[name].detach().cpu().numpy()

    h = host('height')
    return dict(
        mean_height=float(h.mean()),
        min_height=float(h.min()),
        fallen_frac=float(host('fallen').mean()),
        qp_mu_max=float(host('qp_mu').max()),
        qp_r_dual_max=float(host('qp_r_dual').max()),
    )
