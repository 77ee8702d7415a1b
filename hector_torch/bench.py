"""The port's headline benchmark: batched MPC planning steps per second on
one card (port of the top-level ``bench.py``, which ``python -m hector
bench`` runs).

    python -m hector_torch bench                # on the card
    python -m hector_torch --device cpu bench   # on the CPU, asked for

Prints one JSON line, the reference's record with its keys in its order:
``{"metric", "value", "unit", "vs_baseline"}``.

The unit of work is one full planning step a scenario (``plan_step_fn``:
FK and Jacobians, the gait table, the reference trajectory, the QP build,
the solve, the wrench and the torque map); on the card the solve is one
launch of the fused Riccati kernel a step.  BATCH identical walking lanes
(0.5 m/s), their positions moved by a uniform draw of at most 1e-6 m from
the repetition's key, run CHAIN_LEN chained steps: each step moves the
position by 1e-9 x the step's wrench, so no step can be skipped or
reordered.  Nothing inside the chain waits on the card; the host clock
stops after the chain's scalar is fetched as a Python float, which cannot
exist before the work ran.  The first chain (key 99) builds the kernel and
is not timed; the median of REPS timed chains (keys 0, 1, ...) over
CHAIN_LEN gives the time a step.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from . import prng, resolve_device
from . import runtime as RT
from .config import DEFAULT_CONFIG as CFG
from .plant import srb

BATCH = 32768         # bench.py:54
CHAIN_LEN = 128       # bench.py:62
REPS = 3              # bench.py:96
# the divisor of bench.py:108, kept so that the record reads as the
# reference's; it is no target for this card
BASELINE = 6250.0


def initial_state(batch: int, dtype=torch.float32, device='cuda'):
    """(carry, plant, cmd): ``batch`` identical lanes at the standing pose,
    commanded to walk forward at 0.5 m/s (bench.py:65-71)."""
    plant = srb.init_plant_state(batch, CFG, dtype=dtype, device=device)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.walking_command(batch, vx=0.5, dtype=dtype, device=device)
    return carry, plant, cmd


def chained_steps(plan, key, carry, plant, cmd, chain_len: int):
    """``chain_len`` planning steps from the state moved by the noise of
    ``key``, each step's position moved by 1e-9 x its wrench
    (bench.py:76-88): (sum(position) + sum(f_ff) as a 0-d tensor, the
    final carry, the final plant)."""
    noise = 1e-6 * prng.uniform(key, plant.position.shape,
                                plant.position.dtype)
    plant = plant._replace(position=plant.position + noise)
    for _ in range(chain_len):
        carry, wrench, _motor = plan(carry, plant, cmd)
        plant = plant._replace(
            position=plant.position + 1e-9 * wrench[:, 0, :3])
    return (plant.position.sum() + carry.planner.f_ff.sum(), carry,
            plant)


def run(batch: int, chain_len: int, reps: int, device='cuda') -> dict:
    """Time ``reps`` chains of ``chain_len`` steps at ``batch`` lanes after
    one chain not timed: the record bench.py prints.  ``value`` is solves
    a second on the one device the batch ran on; the reference divides by
    ``jax.local_device_count()`` though its chain runs on one device, the
    port by the one card it ran on."""
    dev = resolve_device(device)
    carry, plant, cmd = initial_state(batch, device=dev)
    plan = RT.plan_step_fn(CFG)
    float(chained_steps(plan, prng.PRNGKey(99, dev), carry, plant, cmd,
                        chain_len)[0])
    times = []
    for rep in range(reps):
        key = prng.PRNGKey(rep, dev)
        t0 = time.perf_counter()
        float(chained_steps(plan, key, carry, plant, cmd, chain_len)[0])
        times.append(time.perf_counter() - t0)
    per_card = batch / (statistics.median(times) / chain_len)
    return {
        "metric": "batched_mpc_solves_per_s_per_chip",
        "value": round(per_card, 1),
        "unit": "solves/s/chip",
        "vs_baseline": round(per_card / BASELINE, 3),
    }


def main(device='cuda') -> dict:
    """Run the benchmark at BATCH lanes, CHAIN_LEN steps and REPS
    repetitions and print its record: what ``python -m hector_torch
    bench`` does."""
    rec = run(BATCH, CHAIN_LEN, REPS, device)
    print(json.dumps(rec), flush=True)
    return rec
