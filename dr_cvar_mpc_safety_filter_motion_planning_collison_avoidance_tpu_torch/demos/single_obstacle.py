"""Demo: the single-obstacle scenarios under all three risk metrics.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.demos.single_obstacle \
        [--save_dir results/single_obstacle] [--seed 42] [--device cuda|cpu]

Port of the JAX package's test_scripts/single_obstacle.py: runs head_on,
overtaking and intersection through the pipeline in float32, prints each
metric's minimum distance to collision with a COLLISION / Safe verdict
(and the unfiltered reference's), and saves
`<scenario>_distances.png` and `<scenario>_<metric>_trajectory.png`
under --save_dir.  Where matplotlib is not installed it prints one line
naming the plots it skips and still runs every scenario.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import config, models
from ..cli import load_viz
from ..config import DEFAULT_DEVICE

SCENARIOS = ("head_on", "overtaking", "intersection")


def run_single_obstacle_scenario(scenario_name: str, save_dir: str,
                                 seed: int = 42, device=DEFAULT_DEVICE):
    """One scenario; returns {name: (min distance, verdict)} for the
    three metrics."""
    params = config.get_parameters()
    scenario = config.get_scenario_config(scenario_name)
    print(f"\n=== {scenario.description} ===")

    result = models.run_single_scenario(scenario, params, seed=seed,
                                        dtype=torch.float32, device=device)

    verdicts = {}
    for i, metric in enumerate(models.METRICS):
        min_dist = float(result.distances[0, i].min())
        verdict = "COLLISION" if min_dist < 0 else "Safe"
        verdicts[metric] = (min_dist, verdict)
        print(f"  {metric:10s}: min distance {min_dist:+.4f}  [{verdict}]")
    ref_min = float(result.reference_distance[0].min())
    print(f"  {'reference':10s}: min distance {ref_min:+.4f}  "
          f"[{'COLLISION' if ref_min < 0 else 'Safe'}]")

    distances_png = f"{scenario_name}_distances.png"
    viz = load_viz(f"{distances_png} and the {scenario_name}_<metric>_"
                   f"trajectory.png plots")
    if viz is None:
        return verdicts
    os.makedirs(save_dir, exist_ok=True)
    distances = {m: result.distances[0, i]
                 for i, m in enumerate(models.METRICS)}
    distances["reference"] = result.reference_distance[0]
    viz.plot_distance_to_collision(
        distances, save_path=os.path.join(save_dir, distances_png),
        title=f"{scenario_name}: distance to collision")
    for i, metric in enumerate(models.METRICS):
        viz.plot_scenario(
            result.filtered_x[0, i], result.obstacles.realization[0],
            params.robot_radius, params.obstacle_radius,
            title=f"{scenario_name} ({metric})",
            save_path=os.path.join(save_dir,
                                   f"{scenario_name}_{metric}_trajectory.png"))
    return verdicts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save_dir", default="results/single_obstacle")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default=DEFAULT_DEVICE)
    args = parser.parse_args(argv)
    return {name: run_single_obstacle_scenario(name, args.save_dir,
                                               args.seed, args.device)
            for name in SCENARIOS}


if __name__ == "__main__":
    main()
