"""Live terminal visualization of a running simulation (port of
``hector/io/live.py``).

The batched engine's analog of watching the robot in the Gazebo GUI /
hector_rviz.launch (hector_description/launch/hector_rviz.launch) plus the
force-draw plugin (unitree_gazebo/plugin/draw_force_plugin.cc): an ANSI
side-view (x-z plane) of one scenario rendered live in the terminal while
the rollout advances period by period.  Works over SSH; no GUI
dependency.  ``python -m hector_torch view``.

The renderer is a pure function of host arrays (testable headless); the CLI
loop in hector_torch/cli.py drives it at a real-time-ish pace.
"""

from __future__ import annotations

import numpy as np

W, H = 72, 22          # canvas size in characters
X_SPAN = 1.6           # metres of world shown horizontally
Z_LO, Z_HI = -0.12, 0.95


def _terrain_z(x, step_height, step_length):
    if step_height == 0.0:
        return np.zeros_like(np.asarray(x, float))
    return step_height * np.floor(np.asarray(x, float) / max(step_length,
                                                             1e-3))


def _line(canvas, r0, c0, r1, c1, ch):
    """Bresenham onto the canvas (row 0 = top)."""
    n = int(max(abs(r1 - r0), abs(c1 - c0), 1))
    for i in range(n + 1):
        t = i / n
        r = int(round(r0 + t * (r1 - r0)))
        c = int(round(c0 + t * (c1 - c0)))
        if 0 <= r < H and 0 <= c < W:
            canvas[r][c] = ch


def render_frame(position, rpy, hips_w, feet_w, contact, fz, t,
                 cmd_text="", step_height=0.0, step_length=1.0) -> str:
    """Render one side-view frame to a string.

    position: (3,) CoM; rpy: (3,); hips_w/feet_w: (2, 3) world hip/foot
    points; contact: (2,) bools; fz: (2,) normal forces (N); t: sim time.
    """
    position = np.asarray(position, float)
    x_lo = position[0] - 0.35 * X_SPAN
    sx = (W - 1) / X_SPAN
    sz = (H - 1) / (Z_HI - Z_LO)

    def col(x):
        return (x - x_lo) * sx

    def row(z):
        return (Z_HI - z) * sz

    canvas = [[" "] * W for _ in range(H)]

    # ground (terrain-following)
    for c in range(W):
        x = x_lo + c / sx
        gz = _terrain_z(x, step_height, step_length)
        r = int(round(row(gz)))
        for rr in range(max(r, 0), H):
            canvas[rr][c] = "#" if rr > r else "="

    # trunk: segment through the CoM along the pitched body x-axis
    pitch = float(np.asarray(rpy, float)[1])
    dx, dz = 0.13 * np.cos(-pitch), 0.13 * np.sin(-pitch)
    _line(canvas, row(position[2] - dz), col(position[0] - dx),
          row(position[2] + dz), col(position[0] + dx), "O")

    # legs, then force arrows, then foot markers (markers drawn last so
    # they never get overpainted; colliding feet nudge one column apart)
    feet_w = np.asarray(feet_w, float)
    hips_w = np.asarray(hips_w, float)
    for leg in (0, 1):
        _line(canvas, row(hips_w[leg, 2]), col(hips_w[leg, 0]),
              row(feet_w[leg, 2]), col(feet_w[leg, 0]), ".")
    cells = []
    for leg, ch in ((0, "L"), (1, "R")):
        fr = int(round(row(feet_w[leg, 2])))
        fc = int(round(col(feet_w[leg, 0])))
        if (fr, fc) in [(r, c) for r, c, _ in cells]:
            fc += 1
        cells.append((fr, fc, ch if contact[leg] else ch.lower()))
        n_arrow = min(6, int(float(fz[leg]) / 60.0))   # one '^' per ~60 N
        for i in range(n_arrow):
            rr = fr - 1 - i
            if 0 <= rr < H and 0 <= fc < W:
                canvas[rr][fc] = "^"
    for fr, fc, ch in cells:
        if 0 <= fr < H and 0 <= fc < W:
            canvas[fr][fc] = ch

    hud1 = (f" t={float(t):6.2f}s  x={position[0]:+6.2f}  "
            f"z={position[2]:5.2f}  yaw={float(np.asarray(rpy)[2]):+5.2f}  "
            f"Fz=[{float(fz[0]):5.0f},{float(fz[1]):5.0f}]N")
    hud2 = (f" contact=[{'#' if contact[0] else '.'}"
            f"{'#' if contact[1] else '.'}]  {cmd_text}")
    rows = ["".join(r) for r in canvas]
    return "\n".join([hud1[:W], hud2[:W]] + rows)


ANSI_HOME = "\x1b[H\x1b[J"


def frame_geometry(plant, cfg):
    """Host-side hip/foot world points (2, 3) each and contact flags (2,)
    of lane 0 of a tier-1 plant state (or an observation of the tier-2
    one), for the renderer."""
    from .. import math as hm
    from ..kinematics import foot_position

    rot = hm.quat_to_rot(plant.quat[0]).detach().cpu().double().numpy()
    hips_b = np.asarray([cfg.robot.hip_yaw_location(0),
                         cfg.robot.hip_yaw_location(1)], float)
    p = plant.position[0].detach().cpu().double().numpy()
    hips_w = p[None, :] + hips_b @ rot.T
    p_leg = foot_position(plant.q[:1], cfg)[0]
    p_leg = p_leg.detach().cpu().double().numpy()
    feet_w = p[None, :] + (hips_b + p_leg) @ rot.T
    return hips_w, feet_w, plant.contact[0].cpu().numpy().astype(bool)
