"""Offline-trajectory playback, the FSMState_TO capability (port of
``hector/io/trajectory.py``).

The reference's trajectory-optimization state loads a 34-column CSV
(include/trajectory_data/example.csv; FSMState_TO.cpp:6-15), indexes a row
by elapsed time (extractTrajectory, FSMState_TO.cpp:100-112) and, its run()
being a stub, never applies it.  Here a table is loaded, looked up by time
(batched) and replayed in closed loop through the controller and the tier-1
plant.

Format: col 0 = time [s], cols 1:13 = the 12-dim MPC state
[rpy, p, omega, v], the remaining columns free-form payload kept verbatim.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class TrajectoryTable:
    """A trajectory with time-indexed lookup, on a device, in the dtype of
    the data it was made from (float64 from a CSV)."""

    def __init__(self, data, device='cuda'):
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] < 13:
            raise ValueError(
                f'trajectory needs (rows, >=13) columns, got {data.shape}')
        self.data = torch.as_tensor(data).to(resolve_device(device))
        self.times = self.data[:, 0].contiguous()

    @classmethod
    def from_csv(cls, path: str, device='cuda') -> 'TrajectoryTable':
        # ndmin=2: a single-row file (e.g. the reference's own example.csv
        # placeholder) must stay a (1, 34) table
        return cls(np.loadtxt(path, delimiter=',', ndmin=2), device)

    def row_at(self, t):
        """Row(s) for elapsed time(s) t (clamped at both ends, as
        extractTrajectory saturates at the final row)."""
        t = torch.as_tensor(t, dtype=self.times.dtype).to(self.times.device)
        idx = torch.searchsorted(self.times, t, right=True) - 1
        return self.data[idx.clamp(0, self.data.shape[0] - 1)]

    def state_at(self, t):
        """The 12-dim reference state at time(s) t."""
        return self.row_at(t)[..., 1:13]


def command_schedule(table: TrajectoryTable, n_periods: int,
                     dt_period: float):
    """A trajectory table as a one-lane rollout schedule (cmd_t (1,
    n_periods, ...), mode_cmd_t (1, n_periods)) for
    ``runtime.make_rollout(with_schedule=True)``.

    The table's state rows [rpy, p, omega, v] (world frame) become
    teleop-style commands: body-frame vx/vy from the world velocity rotated
    by the row's yaw, yaw_rate from omega_z, roll/pitch targets from the
    row's rpy; float32 whatever the table's dtype, as the JAX module casts
    (trajectory.py:69).  This completes what FSMState_TO leaves as a stub
    (FSMState_TO.cpp:27-40): the table drives the walking controller."""
    from .. import runtime as RT

    dev = table.data.device
    t = torch.arange(n_periods, dtype=table.times.dtype, device=dev) \
        * dt_period
    states = table.state_at(t).to(torch.float32)       # (n, 12)
    yaw = states[:, 2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    vx_b = cy * states[:, 9] + sy * states[:, 10]
    vy_b = -sy * states[:, 9] + cy * states[:, 10]
    walk = RT.walking_command(n_periods, device=dev)
    cmd_t = RT.ScenarioCommand(
        vx=vx_b, vy=vy_b, yaw_rate=states[:, 8],
        roll=states[:, 0], pitch=states[:, 1],
        gait_offsets=walk.gait_offsets, gait_durations=walk.gait_durations,
        terrain_step_height=walk.terrain_step_height,
        terrain_step_length=walk.terrain_step_length)
    cmd_t = RT.ScenarioCommand(*[f[None] for f in cmd_t])
    mode_t = torch.full((1, n_periods), RT.MODE_CMD_NONE, dtype=torch.int32,
                        device=dev)
    return cmd_t, mode_t


def closed_loop_replay(table: TrajectoryTable, cfg=None, seconds=None):
    """Closed-loop trajectory playback on the table's device: drive the
    controller and the tier-1 plant (one lane) from the table and report
    the tracking errors against its state reference.  Returns (report,
    diags of the lane, (n_periods, ...)).  The parity harness SURVEY.md
    §2.1 planned for the TO state."""
    from .. import runtime as RT
    from ..plant import srb
    from ..config import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    dev = table.data.device
    dt_period = cfg.mpc.dt * cfg.mpc.mpc_cadence
    t_end = float(table.times[-1]) if seconds is None else seconds
    n_periods = max(1, int(t_end / dt_period))
    cmd_t, mode_t = command_schedule(table, n_periods, dt_period)

    plant = srb.init_plant_state(1, cfg, device=dev)
    carry = RT.init_controller_carry(plant, cfg)
    roll = RT.make_rollout(n_periods, cfg, with_schedule=True)
    base = RT.ScenarioCommand(*[f[:, 0] for f in cmd_t])
    carry, plant, diags = roll(carry, plant, base, (cmd_t, mode_t))
    diags = {k: v[0] for k, v in diags.items()}

    t = np.arange(n_periods) * dt_period
    ref = table.state_at(t).cpu().numpy()
    xy = diags['xy'].cpu().numpy()
    z = diags['height'].cpu().numpy()
    pos_err = np.linalg.norm(xy - ref[:, 3:5], axis=-1)
    report = dict(
        rows=int(table.times.shape[0]),
        periods=n_periods,
        seconds=round(t_end, 3),
        fallen=bool(diags['fallen'].any()),
        pos_err_mean=round(float(pos_err.mean()), 4),
        pos_err_final=round(float(pos_err[-1]), 4),
        pos_err_max=round(float(pos_err.max()), 4),
        height_err_mean=round(float(np.abs(z - ref[:, 5]).mean()), 4),
    )
    return report, diags


def write_csv(path: str, times, states, payload=None) -> None:
    """Write a playback CSV in the reference's layout (time + 12 state +
    payload columns padded to 34)."""
    times = np.asarray(times)[:, None]
    states = np.asarray(states)
    if payload is None:
        payload = np.zeros((times.shape[0], 34 - 1 - states.shape[1]))
    table = np.concatenate([times, states, np.asarray(payload)], axis=1)
    np.savetxt(path, table, delimiter=',')
