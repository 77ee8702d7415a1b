"""Scenario generation: the batched replacement for keyboard teleop (port
of ``hector/io/scenarios.py``).

The reference's command surface is a raw-terminal key thread mapping
wasd/ijkl to velocity axes within the envelope vx in [-0.75, 0.75], vy in
[-0.25, 0.25], yaw_rate in [-1.5, 1.5] (src/interface/KeyBoard.cpp:31-93,
FSMState_Walking.cpp:30-33).  Here a scenario batch samples that envelope
(plus gait choice and disturbance schedules) from a PRNG key of
``hector_torch.prng``, the draws of ``jax.random`` for the same key.

The JAX module draws its standing/stairs/push masks in JAX's default float
type (float64 under ``jax_enable_x64``, float32 otherwise); here that type
is the explicit ``mask_dtype``, float32 by default as in a default JAX
process.
"""

from __future__ import annotations

import torch

from .. import prng
from .. import runtime as RT

# teleop envelope (FSMState_Walking.cpp:30-33)
VX_RANGE = (-0.75, 0.75)
VY_RANGE = (-0.25, 0.25)
YAW_RATE_RANGE = (-1.5, 1.5)


def random_commands(key, batch: int, p_standing: float = 0.1,
                    p_stairs: float = 0.0, max_step_height: float = 0.04,
                    dtype=torch.float32,
                    mask_dtype=torch.float32) -> RT.ScenarioCommand:
    """A batch of scenario commands over the teleop envelope, on the key's
    device.

    A fraction p_standing of scenarios use the standing gait with zero
    command (the reference's gait 1), the rest walk (gait 2).  A fraction
    p_stairs get randomized stairs terrain (config-3 style randomization).
    """
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6).unbind(-2)
    vx = prng.uniform(k1, batch, dtype, *VX_RANGE)
    vy = prng.uniform(k2, batch, dtype, *VY_RANGE)
    yaw_rate = prng.uniform(k3, batch, dtype, *YAW_RATE_RANGE)
    standing = prng.uniform(k4, batch, mask_dtype) < p_standing

    zeros = torch.zeros_like(vx)
    vx = torch.where(standing, zeros, vx)
    vy = torch.where(standing, zeros, vy)
    yaw_rate = torch.where(standing, zeros, yaw_rate)

    def pair(v):
        return torch.tensor(v, dtype=dtype).to(vx.device)[None]

    offsets = torch.where(standing[:, None], pair([0.0, 0.0]),
                          pair([0.0, 5.0]))
    durations = torch.where(standing[:, None], pair([10.0, 10.0]),
                            pair([5.0, 5.0]))

    stairs = prng.uniform(k5, batch, mask_dtype) < p_stairs
    step_h = torch.where(
        stairs, prng.uniform(k6, batch, dtype, 0.01, max_step_height), 0.0)
    step_l = torch.full_like(vx, 0.5)

    return RT.ScenarioCommand(
        vx=vx, vy=vy, yaw_rate=yaw_rate, roll=zeros, pitch=zeros,
        gait_offsets=offsets, gait_durations=durations,
        terrain_step_height=step_h, terrain_step_length=step_l)


def disturbance_schedule(key, batch: int, n_periods: int,
                         magnitude: float = 30.0, p_push: float = 0.002,
                         dtype=torch.float32, mask_dtype=torch.float32):
    """(batch, n_periods, 6) world trunk wrenches, on the key's device:
    sparse random pushes, the batched analog of external_force keyboard
    teleop (unitree_controller/src/external_force.cpp).  Feed to
    make_rollout(with_disturbance=True)."""
    k1, k2 = prng.split(key).unbind(-2)
    active = prng.uniform(k1, (batch, n_periods, 1), mask_dtype) < p_push
    direction = prng.normal(k2, (batch, n_periods, 6), dtype)
    direction = direction / (torch.linalg.vector_norm(
        direction[..., :3], dim=-1, keepdim=True) + 1e-6)
    scale = torch.tensor([1.0] * 3 + [0.2] * 3, dtype=dtype).to(
        direction.device)                   # mostly force, small moment
    return torch.where(active, magnitude * (direction * scale), 0.0)
