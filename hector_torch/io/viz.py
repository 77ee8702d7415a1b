"""Offline visualization from logged arrays (port of ``hector/io/viz.py``).

Replaces the Gazebo GUI + draw_force_plugin visual checks
(unitree_gazebo/plugin/draw_force_plugin.cc scales force lines by /20) with
matplotlib renders of logged rollout arrays: CoM trajectory, height/velocity
tracking, gait diagram, contact forces.  Headless (Agg backend); every
function takes arrays or tensors of one lane (on any device), returns the
figure and optionally saves a PNG.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_tracking(diags, dt_period: float = 0.005, v_des=None, path=None):
    """Height + forward velocity over a rollout (one lane's diags from
    make_rollout, (n_periods,) each)."""
    plt = _plt()
    h = _np(diags["height"])
    vx = _np(diags["vx"])
    t = np.arange(h.shape[0]) * dt_period
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    ax1.plot(t, h)
    ax1.axhline(0.55, ls="--", c="gray", lw=0.8)
    ax1.set_ylabel("height [m]")
    ax2.plot(t, vx)
    if v_des is not None:
        ax2.axhline(v_des, ls="--", c="gray", lw=0.8)
    ax2.set_ylabel("vx [m/s]")
    ax2.set_xlabel("time [s]")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_forces(wrench_log, dt_period: float = 0.005, path=None):
    """Per-leg vertical GRF over time (wrench_log: (T, 2, 6) world)."""
    plt = _plt()
    w = _np(wrench_log)
    t = np.arange(w.shape[0]) * dt_period
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(t, w[:, 0, 2], label="left Fz")
    ax.plot(t, w[:, 1, 2], label="right Fz")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("GRF z [N]")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_gait(contact_log, dt: float = 0.001, path=None):
    """Gait diagram: contact state per leg over time ((T, 2) bools)."""
    plt = _plt()
    c = _np(contact_log).astype(float)
    fig, ax = plt.subplots(figsize=(8, 1.8))
    ax.imshow(c.T, aspect="auto", interpolation="nearest", cmap="Greys",
              extent=(0, c.shape[0] * dt, -0.5, 1.5))
    ax.set_yticks([0, 1], ["L", "R"])
    ax.set_xlabel("time [s]")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
