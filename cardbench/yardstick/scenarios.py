"""The benchmark's inputs, drawn from its seed with a ``torch.Generator``
on the device: commands over the teleop envelope, pushes, and lane states
around the standing pose.

The draws copy the logic of hector_torch/io/scenarios.py at commit dc0bcd9
(``random_commands``, ``disturbance_schedule``: the envelope of
FSMState_Walking.cpp:30-33, a share of standing lanes, sparse pushes of
mostly force), with the benchmark's own generator in place of the port's
threefry keys.  Inputs are returned as the reference's types
(reference/tick.py, reference/plant.py); compare.port_state hands the same
tensors to the program's types, which share the field names, and
``from_port`` takes the program's state back.
"""

from __future__ import annotations

import torch

from ..reference import plant as P
from ..reference import tick as R
from ..reference.config import DEFAULT_CONFIG

VX_RANGE = (-0.75, 0.75)
VY_RANGE = (-0.25, 0.25)
YAW_RATE_RANGE = (-1.5, 1.5)
SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream (a batch index, a kind of
    input): the same (seed, stream) gives the same draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) & SEED_MASK)
    return g


def uniform(g, shape, lo, hi, dtype, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype,
                                       device=device)


def commands(g, batch: int, p_standing: float, dtype, device) -> R.Command:
    """A batch of teleop commands: vx, vy and yaw rate uniform over the
    envelope, a share ``p_standing`` of lanes on the standing gait with a
    zero command, the rest on the walking gait Gait(10, (0,5), (5,5));
    flat ground."""
    vx = uniform(g, (batch,), *VX_RANGE, dtype, device)
    vy = uniform(g, (batch,), *VY_RANGE, dtype, device)
    yaw_rate = uniform(g, (batch,), *YAW_RATE_RANGE, dtype, device)
    standing = torch.rand((batch,), generator=g, device=device) < p_standing
    zeros = torch.zeros_like(vx)
    vx = torch.where(standing, zeros, vx)
    vy = torch.where(standing, zeros, vy)
    yaw_rate = torch.where(standing, zeros, yaw_rate)

    def pair(a, b):
        return torch.tensor([a, b], dtype=dtype, device=device)[None]

    offsets = torch.where(standing[:, None], pair(0.0, 0.0), pair(0.0, 5.0))
    durations = torch.where(standing[:, None], pair(10.0, 10.0),
                            pair(5.0, 5.0))
    return R.Command(vx=vx, vy=vy, yaw_rate=yaw_rate, roll=zeros,
                     pitch=zeros, gait_offsets=offsets,
                     gait_durations=durations,
                     terrain_step_height=zeros.clone(),
                     terrain_step_length=torch.full_like(vx, 0.5))


def pushes(g, batch: int, n_periods: int, magnitude: float, p_push: float,
           dtype, device):
    """(batch, n_periods, 6) world trunk wrenches: a push of ``magnitude``
    N in a random direction (a fifth of it as a moment) on a share
    ``p_push`` of lane-periods, zero elsewhere."""
    active = torch.rand((batch, n_periods, 1), generator=g,
                        device=device) < p_push
    direction = torch.randn((batch, n_periods, 6), generator=g, dtype=dtype,
                            device=device)
    direction = direction / (torch.linalg.vector_norm(
        direction[..., :3], dim=-1, keepdim=True) + 1e-6)
    scale = torch.tensor([1.0] * 3 + [0.2] * 3, dtype=dtype, device=device)
    return torch.where(active, magnitude * (direction * scale), 0.0)


def standing_state(batch: int, dtype, device):
    """(carry, plant): ``batch`` lanes standing still at the nominal pose,
    the controller as its first run leaves it, tick 0."""
    plant = P.standing(batch, DEFAULT_CONFIG, dtype, device)
    return R.first_carry(plant, torch.zeros(batch, dtype=torch.int32,
                                            device=device)), plant


def _quat(rpy):
    """ZYX euler angles to a wxyz quaternion."""
    c, s = torch.cos(0.5 * rpy), torch.sin(0.5 * rpy)
    cr, cp, cy = c.unbind(-1)
    sr, sp, sy = s.unbind(-1)
    return torch.stack([cr * cp * cy + sr * sp * sy,
                        sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy], -1)


def moving_state(g, batch: int, dtype, device):
    """(carry, plant): lanes at the standing pose with a trunk velocity
    inside the envelope (vx, vy, yaw rate), an attitude within +-0.1 rad
    on each axis, and a gait tick uniform over the gait's 10 segments of
    40 ticks, so that stance and swing mix."""
    _, plant = standing_state(batch, dtype, device)
    vx = uniform(g, (batch,), *VX_RANGE, dtype, device)
    vy = uniform(g, (batch,), *VY_RANGE, dtype, device)
    wz = uniform(g, (batch,), *YAW_RATE_RANGE, dtype, device)
    rpy = uniform(g, (batch, 3), -0.1, 0.1, dtype, device)
    zero = torch.zeros_like(vx)
    plant = plant._replace(
        v_world=torch.stack([vx, vy, zero], -1),
        omega_world=torch.stack([zero, zero, wz], -1),
        quat=_quat(rpy))
    period = DEFAULT_CONFIG.mpc.iterations_between_mpc * R.N_SEGMENTS
    tick = torch.randint(0, period, (batch,), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)
    return R.first_carry(plant, tick), plant


def from_port(pcarry, pplant, dtype=None):
    """The program's state as the reference's types, cast to ``dtype``
    (floating fields only)."""
    def cast(t):
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    carry = R.Carry(
        tick=pcarry.tick, mode=pcarry.mode,
        world_position_desired=cast(pcarry.planner.world_position_desired),
        f_ff=cast(pcarry.planner.f_ff),
        swing=R.SwingState(*[cast(t) for t in pcarry.swing]),
        yaw_des=cast(pcarry.command.yaw_des))
    plant = P.PlantState(*[cast(t) for t in pplant])
    return carry, plant


def _map(fn, tree):
    if isinstance(tree, tuple):
        values = [_map(fn, t) for t in tree]
        return type(tree)(*values) if hasattr(tree, '_fields') \
            else tuple(values)
    return fn(tree)


def cast_tree(tree, dtype):
    """A tree of NamedTuples and tuples of tensors with its floating
    fields cast to ``dtype``."""
    return _map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def take(tree, idx):
    """The lanes ``idx`` of a tree of (B, ...) tensors."""
    return _map(lambda t: t.index_select(0, idx), tree)

