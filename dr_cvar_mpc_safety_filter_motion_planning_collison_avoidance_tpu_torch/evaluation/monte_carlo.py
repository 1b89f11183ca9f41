"""Monte Carlo safety evaluation: the paper's collision-probability study.

Port of the JAX package's evaluation/monte_carlo.py.  The run axis is the
pipeline's scenario axis: runs go through `run_scenario_with_obstacles`
in chunks of `chunk_size` scenarios, and each run is reduced to its
minimum distance over time per metric (plus the unfiltered reference)
and its QPs' converged flags.

Results do not depend on `chunk_size`, `batched` or a mesh: JAX splits
one key per run up front; here one seed per run is drawn up front from
`seed` (`run_seeds`, whose first n seeds are the same for any longer
draw), and each run's obstacle noise comes from its own
`torch.Generator` seeded with it, so a run draws the same numbers in any
chunk and on any rank.  On a CUDA float32 chunk one kernel launch draws
all of its runs, bit for bit as their generators would
(`use_draw_kernel`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, Parameters, Scenario
from ..models.pipeline import (METRICS, PipelineStatics, ScenarioResult,
                               make_statics, run_scenario_with_obstacles)
from ..simulation.obstacles import (ObstacleData, draw_runs_kernel,
                                    draw_runs_loop)
from ..utils.timing import count
from .metrics import safety_metrics


class MonteCarloResult(NamedTuple):
    """Per-run tensors (leading axis = MC run) plus aggregates.

    Metric axis ordering follows METRICS + ('reference',) where noted.
    """

    min_distances: torch.Tensor     # [n_runs, 4]: mean/cvar/dr_cvar/reference
    collisions: torch.Tensor        # [n_runs, 4] bool
    collision_probs: torch.Tensor   # [4]
    qp_converged: torch.Tensor      # [n_runs, 3]

    def summary(self):
        names = list(METRICS) + ["reference"]
        return {
            name: {
                "collision_prob": float(self.collision_probs[i]),
                **{k: float(v) for k, v in
                   safety_metrics(self.min_distances[:, i]).items()},
            }
            for i, name in enumerate(names)
        }


def run_seeds(seed: int, n_runs: int) -> list[int]:
    """One generator seed per run, drawn up front from `seed` by a CPU
    generator; `run_seeds(s, n)` is a prefix of `run_seeds(s, m)` for
    m > n, so a mesh's padded draw starts with the runs of a plain one."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 62, (n_runs,), generator=gen,
                         dtype=torch.int64).tolist()


def use_draw_kernel(device, dtype) -> bool:
    """Whether a chunk's draws go to the draw kernel
    (`simulation/obstacles.py::draw_runs_kernel`): float32 on a CUDA
    device, where it replays each run's card generator bit for bit.
    Elsewhere the runs take the loop: the CPU's generator is another
    algorithm, and float64 `randn` another transform.  Decided from the
    device and dtype alone."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def run_obstacles(statics: PipelineStatics, seeds, scenario: Scenario,
                  params: Parameters, n_steps: int) -> ObstacleData:
    """Obstacle draws of the runs with these seeds, stacked on the
    scenario axis; each run's draw is that of its own generator, in one
    kernel launch or a loop (`use_draw_kernel`).  The recorder counts
    the runs of each path (`obstacles.kernel_runs`,
    `obstacles.loop_runs`)."""
    env = statics.env
    as_t = lambda v: torch.as_tensor(v, dtype=env.dtype,   # noqa: E731
                                     device=env.device)
    args = (seeds, *(as_t(v) for v in (
        scenario.obstacle_starts, scenario.obstacle_directions,
        scenario.obstacle_speeds)), n_steps, env.dt, params.num_samples,
        params.noise_var)
    if use_draw_kernel(env.device, env.dtype):
        count("obstacles.kernel_runs", len(seeds))
        return draw_runs_kernel(*args)
    count("obstacles.loop_runs", len(seeds))
    return draw_runs_loop(*args)


def reduce_runs(result: ScenarioResult):
    """(min_distances [S, 4], qp_converged [S, 3]) of a batch of runs:
    each metric's minimum distance over time, then the reference's."""
    min_d = torch.cat([result.distances.amin(-1),
                       result.reference_distance.amin(-1)[:, None]], dim=1)
    return min_d, result.qp_converged


def run_monte_carlo_simulation(scenario: Scenario, params: Parameters,
                               n_runs: int | None = None, seed: int = 42,
                               dtype=torch.float32, device=DEFAULT_DEVICE,
                               statics: PipelineStatics | None = None,
                               batched: bool = True,
                               chunk_size: int = 1024,
                               mesh=None,
                               qp_iters: int = 60) -> MonteCarloResult:
    """Run the full MC experiment.

    With `batched=True` (default) the runs go through the pipeline in
    chunks of `chunk_size` scenarios (the bound on device memory);
    `batched=False` runs them one at a time.  With a `parallel.Mesh` as
    `mesh` the runs are split over its data axis instead
    (`parallel.sweep.run_batch_sharded`, on the mesh's device), padded
    to a multiple of the data axis with further seeds, and stripped.
    Every way gives the result for the same seeds, with the same
    `qp_iters`.
    """
    if n_runs is None:
        n_runs = params.num_mc_runs
    device = torch.device(device) if mesh is None else mesh.device
    if statics is None:
        statics = make_statics(scenario, params, dtype, device)
    sim_time = (scenario.sim_time if scenario.sim_time is not None
                else params.sim_time)
    n_steps = int(sim_time / params.dt)
    chunk = max(1, chunk_size if batched else 1)

    if mesh is not None:
        from ..parallel.sweep import run_batch_sharded
        n_data = mesh.shape["data"]
        seeds = run_seeds(seed, -(-n_runs // n_data) * n_data)
        dmin, ref_min, conv = run_batch_sharded(
            mesh, statics, seeds, scenario, params, n_steps,
            qp_iters=qp_iters)
        min_d = torch.cat([dmin, ref_min[:, None]], dim=1)[:n_runs]
        conv = conv[:n_runs]
    else:
        seeds = run_seeds(seed, n_runs)
        min_d, conv = [], []
        for start in range(0, n_runs, chunk):
            obstacles = run_obstacles(statics, seeds[start:start + chunk],
                                      scenario, params, n_steps)
            res = run_scenario_with_obstacles(
                statics, obstacles, scenario.ego_start, scenario.ego_goal,
                params.ego_velocity, qp_iters=qp_iters)
            md, cv = reduce_runs(res)
            min_d.append(md)
            conv.append(cv)
        min_d, conv = torch.cat(min_d), torch.cat(conv)
    collisions = min_d < 0
    return MonteCarloResult(
        min_distances=min_d,
        collisions=collisions,
        collision_probs=collisions.to(torch.float32).mean(0),
        qp_converged=conv,
    )


def save_mc_result(result: MonteCarloResult, path):
    """Persist a MonteCarloResult to .npz (the JAX package's keys)."""
    np.savez(path, **{f: getattr(result, f).cpu().numpy()
                      for f in MonteCarloResult._fields})


def load_mc_result(path) -> MonteCarloResult:
    """Inverse of `save_mc_result` (CPU tensors)."""
    with np.load(path) as archive:
        return MonteCarloResult(**{f: torch.from_numpy(archive[f])
                                   for f in MonteCarloResult._fields})


def print_mc_summary(result: MonteCarloResult):
    """Human-readable summary, as the JAX package prints it."""
    names = list(METRICS) + ["reference"]
    md = result.min_distances.cpu().numpy()
    cp = result.collision_probs.cpu().numpy()
    print(f"Monte Carlo summary over {md.shape[0]} runs:")
    for i, name in enumerate(names):
        print(f"  {name:10s}: collision_prob={cp[i]:.3f} "
              f"min_dist mean={md[:, i].mean():.4f} "
              f"min={md[:, i].min():.4f} max={md[:, i].max():.4f}")
