"""Configuration parameters as frozen dataclasses with named presets.

Replaces the reference's comment-toggled module constants
(reference config/parameters.py:11-33 "custom" block and the commented
"paper" block at config/parameters.py:45-68) with two named presets,
selectable at runtime instead of by editing source.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Global problem parameters (reference config/parameters.py:11-33)."""

    # Risk parameters
    alpha: float = 0.2       # CVaR confidence level (1-alpha quantile)
    delta: float = 0.1       # Risk bound
    epsilon: float = 0.15    # Wasserstein radius

    # Robot parameters
    robot_radius: float = 0.3
    dt: float = 0.2          # Time step (sec)

    # MPC parameters
    horizon: int = 30        # MPC horizon
    q_weight: float = 2.0    # State-tracking cost weight
    r_weight: float = 1.0    # Control-effort cost weight

    # Simulation parameters
    sim_time: float = 30.0   # Total simulation time (sec)
    num_samples: int = 20    # Number of obstacle trajectory samples

    # Obstacle parameters
    obstacle_radius: float = 0.3
    obstacle_speed: float = 1.0

    # Monte Carlo parameters
    num_mc_runs: int = 300

    # Reference-trajectory planner speed (reference simulation/planner.py:120)
    ego_velocity: float = 1.5

    # Obstacle sample noise covariance diagonal (reference
    # simulation/obstacles.py:134 hard-codes diag([0.01, 0.01]))
    noise_var: float = 0.01

    @property
    def n_sim_steps(self) -> int:
        return int(self.sim_time / self.dt)


# Active "custom" parameter set (reference config/parameters.py:11-33).
CUSTOM = Parameters()

# "Paper" parameter set (reference config/parameters.py:45-68, commented
# there; the only difference is ALPHA = 0.1).
PAPER = Parameters(alpha=0.1)

PRESETS = {"custom": CUSTOM, "paper": PAPER}


def get_parameters(preset: str = "custom") -> Parameters:
    """Look up a named parameter preset ('custom' or 'paper')."""
    try:
        return PRESETS[preset]
    except KeyError:
        raise ValueError(
            f"Unknown preset: {preset!r}; available: {sorted(PRESETS)}"
        ) from None
