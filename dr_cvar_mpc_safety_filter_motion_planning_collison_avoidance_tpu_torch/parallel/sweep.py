"""Batches of independent instances split over the mesh's data axis.

Port of the JAX package's parallel/sweep.py.  Each rank runs its block
of the batch (`mesh.block_rows`) as one batched call on its own device,
with no collective inside: the JAX package's per-device `shard_map`
program has none either, and the IPM's per-iteration exit test
(`bool(active.any())`) stays a local host sync on each rank.  The blocks
come back to every rank with ONE collective per batch
(`mesh.gather_batch`).  The ranks of one data row compute the same block.
"""

from __future__ import annotations

import torch

from ..config import Parameters, Scenario
from ..evaluation.monte_carlo import reduce_runs, run_obstacles
from ..models.pipeline import PipelineStatics, run_scenario_with_obstacles
from ..ops.halfspace import dr_cvar_g_star
from .mesh import Mesh, block_rows, gather_batch, shard_batch


def run_batch_sharded(mesh: Mesh, statics: PipelineStatics, seeds,
                      scenario: Scenario, params: Parameters, n_steps: int,
                      qp_iters: int = 35):
    """The scenario pipeline for a batch of Monte Carlo runs, one
    generator seed a run (`evaluation.monte_carlo.run_seeds`), the batch
    split over the data axis.  `statics` lie on this rank's device.

    Each rank draws its runs' obstacles (`run_obstacles`), runs them
    through `run_scenario_with_obstacles` (kernels 1-3 on the card) and
    reduces them (`reduce_runs`); one gather follows.
    Returns (min_distances [B, 3], reference_min [B], converged [B, 3])
    on every rank.
    """
    seeds = list(seeds)
    block = [seeds[i] for i in block_rows(len(seeds), mesh).tolist()]
    obstacles = run_obstacles(statics, block, scenario, params, n_steps)
    res = run_scenario_with_obstacles(
        statics, obstacles, scenario.ego_start, scenario.ego_goal,
        params.ego_velocity, qp_iters=qp_iters)
    min_d, conv = reduce_runs(res)
    # One buffer for the three outputs: [min distances x 3, reference,
    # converged x 3], the flags as 0 / 1 in the distances' dtype.
    out = gather_batch(torch.cat([min_d, conv.to(min_d.dtype)], dim=1), mesh,
                       len(seeds))
    return out[:, :3], out[:, 3], out[:, 4:] > 0.5


def sharded_halfspace_throughput(mesh: Mesh, samples, h, alpha, delta,
                                 epsilon, robot_radius, obstacle_radius):
    """Batched DR-CVaR halfspace solves (the closed form, as in JAX) with
    the instances split over the data axis.  samples: [B, N, 2]; h:
    [B, 2].  Returns g* [B] on every rank."""
    g_local, _ = dr_cvar_g_star(shard_batch(samples, mesh),
                                shard_batch(h, mesh), alpha, delta, epsilon,
                                robot_radius, obstacle_radius)
    return gather_batch(g_local, mesh, samples.shape[0])


def make_sharded_timing_solvers(mesh: Mesh, params: Parameters):
    """Mesh counterparts of
    evaluation.timing_analysis._make_batched_solvers: (dr, cvar) solvers
    with the same `(samples [B, N, 2], h [2]) -> g [B]` signature, the
    batch split over the data axis (padded by wrapping; a pad may exceed
    B) and gathered back."""
    from ..evaluation.timing_analysis import _make_batched_solvers

    def split(local):
        def solver(samples, h):
            return gather_batch(local(shard_batch(samples, mesh), h), mesh,
                                samples.shape[0])
        return solver

    dr_local, cvar_local = _make_batched_solvers(params)
    return split(dr_local), split(cvar_local)
