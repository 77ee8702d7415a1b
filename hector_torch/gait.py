"""Gait phase machine as pure tensor functions (port of ``hector/gait.py``,
after ``ConvexMPC/GaitGenerator.cpp``).

Everything is a function of the global tick counter and per-scenario gait
parameters (offsets (B, 2), durations (B, 2) in segments), so one batch mixes
walking and standing lanes.  Integer ``//`` and ``%`` on tensors keep
Python's floor semantics, as JAX's do.
"""

from __future__ import annotations

import torch


def phase_state(tick, iterations_per_mpc: int, n_segments: int):
    """(gait segment index, continuous phase in [0,1)).

    Matches ``Gait::setIterations`` (GaitGenerator.cpp:109-113).  The phase
    is float32 even in float64 runs, as in the JAX package (gait.py:27).
    """
    period = iterations_per_mpc * n_segments
    iteration = torch.remainder(
        torch.div(tick, iterations_per_mpc, rounding_mode='floor'),
        n_segments)
    phase = torch.remainder(tick, period).to(torch.float32) / period
    return iteration, phase


def contact_subphase(phase, offsets, durations, n_segments: int):
    """Per-leg contact sub-phase in [0,1]; 0 when not in contact
    (``Gait::getContactSubPhase``, GaitGenerator.cpp:29-47)."""
    off = offsets / n_segments
    dur = durations / n_segments
    progress = phase[..., None] - off
    progress = torch.where(progress < 0, progress + 1.0, progress)
    return torch.where(progress > dur, torch.zeros_like(progress),
                       progress / dur)


def swing_subphase(phase, offsets, durations, n_segments: int):
    """Per-leg swing sub-phase in [0,1]; 0 when not swinging
    (``Gait::getSwingSubPhase``, GaitGenerator.cpp:53-78)."""
    off = offsets / n_segments
    dur = durations / n_segments
    swing_off = off + dur
    swing_off = torch.where(swing_off > 1.0, swing_off - 1.0, swing_off)
    swing_dur = 1.0 - dur
    progress = phase[..., None] - swing_off
    progress = torch.where(progress < 0, progress + 1.0, progress)
    # guard 0/0 for full-stance gaits (standing: swing_dur == 0)
    safe_dur = torch.where(swing_dur == 0.0, torch.ones_like(swing_dur),
                           swing_dur)
    zero = torch.zeros_like(progress)
    sub = torch.where(progress > swing_dur, zero, progress / safe_dur)
    return torch.where(swing_dur == 0.0, zero, sub)


def mpc_gait_table(iteration, offsets, durations, n_segments: int):
    """(..., n_segments, 2) float32 contact table starting at the current
    segment (``Gait::mpc_gait``, GaitGenerator.cpp:85-103): entry [i, leg]
    is 1 when that leg is in stance ``i`` segments ahead of now."""
    idx = torch.arange(n_segments, device=iteration.device,
                       dtype=iteration.dtype)
    iters = torch.remainder(idx[:, None] + iteration[..., None, None],
                            n_segments)
    offs = offsets.to(torch.int32)[..., None, :]
    progress = torch.remainder(iters - offs, n_segments)
    return (progress < durations.to(torch.int32)[..., None, :]).to(
        torch.float32)
