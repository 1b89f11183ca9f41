"""Scenario registry.

Replaces the reference's dict-returning `get_scenario_config`
(reference config/scenarios.py:11-68 active block; commented "paper"
variants at config/scenarios.py:78-147) with a structured, array-friendly
scenario record.  Obstacles are stored as stacked arrays so a scenario can
be fed straight into jit-compiled, batched pipelines with static shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named scenario: ego start/goal plus per-obstacle motion specs.

    Arrays:
      obstacle_starts      [n_obstacles, 2]
      obstacle_directions  [n_obstacles, 2]  (not necessarily unit norm;
                           normalized at rollout time, matching reference
                           simulation/obstacles.py:18-28)
      obstacle_speeds      [n_obstacles]
    """

    name: str
    description: str
    ego_start: np.ndarray
    ego_goal: np.ndarray
    obstacle_starts: np.ndarray
    obstacle_directions: np.ndarray
    obstacle_speeds: np.ndarray
    # Per-scenario sim-time override used by the paper preset (reference
    # config/scenarios.py:93,147 commented block); None -> Parameters.sim_time.
    sim_time: float | None = None

    @property
    def n_obstacles(self) -> int:
        return self.obstacle_starts.shape[0]


def _scenario(name, desc, ego_start, ego_goal, obstacles, sim_time=None):
    starts = np.asarray([o[0] for o in obstacles], dtype=np.float64)
    dirs = np.asarray([o[1] for o in obstacles], dtype=np.float64)
    speeds = np.asarray([o[2] for o in obstacles], dtype=np.float64)
    return Scenario(
        name=name,
        description=desc,
        ego_start=np.asarray(ego_start, dtype=np.float64),
        ego_goal=np.asarray(ego_goal, dtype=np.float64),
        obstacle_starts=starts,
        obstacle_directions=dirs,
        obstacle_speeds=speeds,
        sim_time=sim_time,
    )


# Active "custom" scenarios (reference config/scenarios.py:11-68).  The
# single-obstacle scenarios default obstacle speed to OBSTACLE_SPEED=1.0
# unless overridden ('overtaking' 0.7, 'intersection' 1.5).
_CUSTOM = {
    "head_on": _scenario(
        "head_on", "Head-on collision scenario",
        [-4.0, 0.0], [4.0, 0.0],
        [([4.0, 0.0], [-1.0, 0.0], 1.0)],
    ),
    "overtaking": _scenario(
        "overtaking", "Overtaking scenario",
        [-4.0, 0.0], [4.0, 0.0],
        [([-2.0, 0.0], [1.0, 0.0], 0.7)],
    ),
    "intersection": _scenario(
        "intersection", "Intersection crossing scenario",
        [-4.0, 0.0], [4.0, 0.0],
        [([0.0, 4.0], [0.0, -1.0], 1.5)],
    ),
    "multi_obstacle": _scenario(
        "multi_obstacle", "Multiple obstacle scenario",
        [-2.0, -1.0], [4.0, 0.0],
        [
            ([0.0, 2.0], [0.0, -0.5], 0.8),
            ([-3.0, 0.5], [0.7, 0.0], 0.6),
            ([1.5, -2.0], [-0.2, 0.5], 0.7),
        ],
    ),
}

# "Paper" scenarios (reference config/scenarios.py:78-147, commented there).
_ENV_LIM = 5.0
_PAPER = {
    "head_on": _scenario(
        "head_on", "Head-on collision scenario",
        [-_ENV_LIM + 0.3, 0.0], [_ENV_LIM - 0.3, 0.0],
        [([2.0, -0.01], [-1.0, 0.0], 1.0)],
        sim_time=3.0,
    ),
    "overtaking": _scenario(
        "overtaking", "Overtaking scenario",
        [-_ENV_LIM + 0.3, 0.0], [_ENV_LIM - 0.3, 0.0],
        [([-2.0, -0.05], [1.0, 0.0], 1.0)],
        sim_time=3.0,
    ),
    "intersection": _scenario(
        "intersection", "Intersection crossing scenario",
        [-3.5, 1.0], [1.0, -3.0],
        [([-3.5, -1.0], [1.5, 0.0], 1.5)],
        sim_time=3.0,
    ),
    "multi_obstacle": _scenario(
        "multi_obstacle", "Multiple obstacle scenario with three dynamic obstacles",
        [-_ENV_LIM + 0.3, -1.0], [_ENV_LIM - 0.3, 0.0],
        [
            ([-1.1, 1.01], [0.7, 0.0], 0.7),
            ([-2.0, -1.01], [1.0, 0.0], 1.0),
            ([-1.0, -2.01], [0.7, 0.0], 0.7),
        ],
        sim_time=5.0,
    ),
}

_REGISTRIES = {"custom": _CUSTOM, "paper": _PAPER}

SCENARIO_NAMES = tuple(_CUSTOM)


def get_scenario_config(name: str, preset: str = "custom") -> Scenario:
    """Look up a scenario by name (reference config/scenarios.py:11-68)."""
    try:
        registry = _REGISTRIES[preset]
    except KeyError:
        raise ValueError(
            f"Unknown preset: {preset!r}; available: {sorted(_REGISTRIES)}"
        ) from None
    try:
        return registry[name]
    except KeyError:
        raise ValueError(
            f"Unknown scenario: {name!r}; available: {sorted(registry)}"
        ) from None
