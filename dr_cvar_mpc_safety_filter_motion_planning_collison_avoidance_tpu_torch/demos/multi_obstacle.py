"""Demo: the multi-obstacle scenario under DR-CVaR, with its control inputs.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.demos.multi_obstacle \
        [--save_dir results/multi_obstacle] [--seed 42] [--device cuda|cpu]

Port of the JAX package's test_scripts/multi_obstacle.py: runs
multi_obstacle through the pipeline in float32, prints the DR-CVaR
minimum distance to collision with its verdict and the QP status, and
saves `multi_obstacle_halfspaces.png` (the trajectory with its safe
halfspaces) and `multi_obstacle_inputs.png` (filtered against reference
inputs) under --save_dir.  Where matplotlib is not installed it prints
one line naming the plots it skips and still runs the scenario.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import config, models
from ..cli import load_viz
from ..config import DEFAULT_DEVICE

PLOTS = ("multi_obstacle_halfspaces.png", "multi_obstacle_inputs.png")


def _plot_inputs(u, u_ref, save_path) -> None:
    """Filtered against reference inputs, one panel an axis."""
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    for d, name in ((0, "a_x"), (1, "a_y")):
        axs[d].plot(u[:, d], "b-", label=f"filtered {name}")
        axs[d].plot(u_ref[:, d], "k--", label=f"reference {name}")
        axs[d].set_ylabel(name)
        axs[d].grid(True)
        axs[d].legend()
    axs[1].set_xlabel("Time step")
    fig.suptitle("DR-CVaR filtered control inputs")
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def run_multi_obstacle_scenario(save_dir: str, seed: int = 42,
                                device=DEFAULT_DEVICE) -> float:
    """The scenario; returns the DR-CVaR minimum distance."""
    params = config.get_parameters()
    scenario = config.get_scenario_config("multi_obstacle")
    print(f"\n=== {scenario.description} ===")

    result = models.run_single_scenario(scenario, params, seed=seed,
                                        dtype=torch.float32, device=device)

    idx = models.METRICS.index("dr_cvar")
    min_dist = float(result.distances[0, idx].min())
    verdict = "COLLISION" if min_dist < 0 else "Safe"
    print(f"  dr_cvar: min distance {min_dist:+.4f}  [{verdict}]")
    print(f"  QP status: "
          f"{'optimal' if bool(result.qp_converged[0, idx]) else 'fallback'}")

    viz = load_viz(f"{PLOTS[0]} and {PLOTS[1]}")
    if viz is None:
        return min_dist
    os.makedirs(save_dir, exist_ok=True)
    hs = result.halfspaces.dr_cvar
    viz.visualize_trajectory_with_halfspaces(
        result.filtered_x[0, idx], result.obstacles.realization[0],
        hs.h[0], hs.g_tilde[0], params.robot_radius, params.obstacle_radius,
        title="Multi-obstacle scenario with DR-CVaR safe halfspaces",
        save_path=os.path.join(save_dir, PLOTS[0]))
    _plot_inputs(viz.to_numpy(result.filtered_u[0, idx]),
                 viz.to_numpy(result.u_ref[0]),
                 os.path.join(save_dir, PLOTS[1]))
    print(f"  Saved plots to {save_dir}/")
    return min_dist


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save_dir", default="results/multi_obstacle")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default=DEFAULT_DEVICE)
    args = parser.parse_args(argv)
    return run_multi_obstacle_scenario(args.save_dir, args.seed, args.device)


if __name__ == "__main__":
    main()
