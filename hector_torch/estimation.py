"""State estimation (port of ``hector/estimation.py``, cheater path only).

The estimator carry keeps every field of the JAX ``EstimatorState`` so a
carry converts one to one; the cheater estimator reads none of them and
returns the plant's ground truth (main.cpp:46-47).  The 'filtered' and 'kf'
estimators are not ported yet (ROADMAP.md queue A item 12) and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import control as C
from . import math as hm

KINDS = ('cheater', 'filtered', 'kf')


def require_cheater(kind: str):
    if kind not in KINDS:
        raise ValueError(f'unknown estimator kind {kind!r}; expected {KINDS}')
    if kind != 'cheater':
        raise NotImplementedError(
            f'estimator {kind!r} is not ported yet (ROADMAP.md queue A '
            f'item 12); only the cheater estimator runs in hector_torch')


class FilterState(NamedTuple):
    pos: torch.Tensor          # (B, 3)
    vel: torch.Tensor          # (B, 3)


class KFState(NamedTuple):
    x: torch.Tensor            # (B, 12)
    cov: torch.Tensor          # (B, 12, 12)


class MahonyState(NamedTuple):
    quat: torch.Tensor         # (B, 4)
    bias: torch.Tensor         # (B, 3)


class EstimatorState(NamedTuple):
    """One carry covering every estimator kind, as in the JAX package."""

    key: torch.Tensor          # (B, 2) PRNG key words of the JAX carry
    filt: FilterState
    kf: KFState
    mahony: MahonyState
    gyro_bias: torch.Tensor    # (B, 3)
    prev_v: torch.Tensor       # (B, 3)


def cheater(plant) -> C.StateEstimate:
    """Ground-truth passthrough (the reference's cheater estimators)."""
    return C.estimate_state(plant.position, plant.v_world, plant.quat,
                            plant.omega_world)


def est_init(plant, cfg, kind: str = 'cheater') -> EstimatorState:
    """The estimator carry at the plant state.  For the cheater it is
    inert: the sensor-noise key and the true gyro bias are zero (the JAX
    package draws them from a PRNG key the cheater never reads)."""
    require_cheater(kind)
    from .kinematics import foot_position, hip_yaw_locations
    dtype, dev = plant.position.dtype, plant.position.device
    bsz = plant.position.shape[0]
    rel = hip_yaw_locations(cfg, plant.q) + foot_position(plant.q, cfg)
    r_body = hm.quat_to_rot(plant.quat).transpose(-1, -2)
    p_feet_w = plant.position[:, None, :] + rel @ r_body
    eye = torch.eye(12, dtype=dtype, device=dev)
    return EstimatorState(
        key=torch.zeros((bsz, 2), dtype=torch.int64, device=dev),
        filt=FilterState(pos=plant.position, vel=plant.v_world),
        kf=KFState(x=torch.cat([plant.position, plant.v_world,
                                p_feet_w.reshape(bsz, 6)], dim=-1),
                   cov=(0.01 * eye).expand(bsz, 12, 12).clone()),
        mahony=MahonyState(
            quat=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                              device=dev).expand(bsz, 4).clone(),
            bias=torch.zeros((bsz, 3), dtype=dtype, device=dev)),
        gyro_bias=torch.zeros((bsz, 3), dtype=dtype, device=dev),
        prev_v=plant.v_world)


def est_update(kind: str, state: EstimatorState, plant, cfg):
    """One 1 kHz estimator tick; returns (new EstimatorState,
    StateEstimate)."""
    require_cheater(kind)
    return state, cheater(plant)
