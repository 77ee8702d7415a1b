"""World presets: the batched plant's analog of the reference's Gazebo
worlds (port of ``hector/worlds.py``).

The reference ships ten .world files selected by the ``wname`` launch arg
(unitree_ros/unitree_gazebo/launch/biped.launch:2).  For the plants the only
physically meaningful world-level knobs are gravity and the ground profile;
each preset maps a reference world onto (gravity, terrain heightfield
params, spawn height):

- ``normal`` / ``earth`` / ``box`` / ``maze`` / ``simple_house`` /
  ``house_obstacles`` / ``big_map`` / ``two_storeys``: flat ground,
  g = 9.81.
- ``space``: g = 0 (space.world), kept for parity; the walking controller
  assumes gravity, so it serves plant testing only.
- ``stairs``: ascending steps h(x) = step_height * floor(x / step_length),
  a climbable 0.03 m / 0.5 m profile; the raw reference geometry is
  ``STAIRS_REFERENCE_GEOMETRY``.

Usage:
    cfg, terrain = worlds.apply("stairs", DEFAULT_CONFIG)
    cmd = runtime.walking_command(batch, vx=0.4,
                                  step_height=terrain.step_height,
                                  step_length=terrain.step_length)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .config import HectorConfig, DEFAULT_CONFIG


@dataclasses.dataclass(frozen=True)
class Terrain:
    step_height: float = 0.0   # 0 = flat ground
    step_length: float = 1.0


@dataclasses.dataclass(frozen=True)
class World:
    name: str
    gravity: float = 9.81
    terrain: Terrain = Terrain()
    spawn_z: float = 0.55      # biped.launch spawns at z=0.545; plant inits
                               # at body_height
    description: str = ""


# stairs.world staircase boxes: 2 m wide, 0.25 m tread, 0.15 m rise
STAIRS_REFERENCE_GEOMETRY = Terrain(step_height=0.15, step_length=0.25)

_FLAT_WORLDS = ("normal", "earth", "box", "maze", "simple_house",
                "house_obstacles", "big_map", "two_storeys")

WORLDS: Dict[str, World] = {
    **{n: World(name=n, description=f"flat ground ({n}.world scenery)")
       for n in _FLAT_WORLDS},
    "space": World(name="space", gravity=0.0,
                   description="zero gravity (space.world)"),
    "stairs": World(name="stairs", terrain=Terrain(0.03, 0.5),
                    description="ascending heightfield (stairs.world)"),
}


def get(name: str) -> World:
    if name not in WORLDS:
        raise KeyError(f"unknown world {name!r}; have {sorted(WORLDS)}")
    return WORLDS[name]


def apply(name: str, cfg: HectorConfig = DEFAULT_CONFIG
          ) -> Tuple[HectorConfig, Terrain]:
    """(config with the world's gravity, terrain params).  Gravity applies
    to the plant only: the controller's MPC model keeps its own gravity
    (MPCConfig.gravity), as the reference controller ignores the .world
    file."""
    w = get(name)
    cfg = dataclasses.replace(
        cfg, plant=dataclasses.replace(cfg.plant, gravity=w.gravity))
    return cfg, w.terrain
