"""Collective census of the mesh programs.

Takes the place of the JAX package's parallel/scaling.py, which counts
the collectives in the optimized HLO of compiled XLA programs; PyTorch
runs eagerly and has no such program, so here `parallel/` counts its
own collective calls (`mesh.CENSUS`, by op and mesh axis) while the
programs run.  The programs are those the JAX module covers:

  * data-split: `run_batch_sharded` (the scenario pipeline with its MPC
    QPs) and `sharded_halfspace_throughput` make ONE collective a batch,
    the final gather, whatever the number of IPM iterations;
  * sample-split: `dr_cvar_g_sample_parallel` makes rounds + 4 (one MAX,
    one SUM of moments, a SUM a bisection round, one MIN, one SUM for the
    tail), which is why that axis stays inside one host.

Writes no file (SCALING.json is the JAX package's).  Run it under
torchrun, or alone for a mesh of one:

    torchrun --nproc_per_node 2 -m \\
        dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.parallel.scaling \\
        --mesh data=2 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, get_parameters, get_scenario_config
from ..models.pipeline import make_statics
from .mesh import CENSUS, Mesh, make_mesh
from .sample_parallel import dr_cvar_g_sample_parallel
from .sweep import run_batch_sharded, sharded_halfspace_throughput

BATCH = 8   # instances (and Monte Carlo runs) a program


def _counted(fn):
    """(fn's result, {"op@axis": calls} of its collectives, total)."""
    CENSUS.clear()
    out = fn()
    census = {f"{op}@{axis}": n for (op, axis), n in sorted(CENSUS.items())}
    return out, census, sum(census.values())


def analyze_mesh_programs(mesh: Mesh, n_samples: int = 1024) -> dict:
    """Run the three programs once on `mesh` at small sizes (`BATCH`
    instances, `n_samples` samples an instance) and census their
    collectives; each entry also holds the expected total."""
    p = get_parameters()
    dev = mesh.device
    results = {"mesh": mesh.shape, "device": str(dev)}

    small = dataclasses.replace(p, horizon=6, sim_time=2.0, num_samples=8)
    scenario = get_scenario_config("head_on")
    statics = make_statics(scenario, small, torch.float32, dev)
    _, census, total = _counted(lambda: run_batch_sharded(
        mesh, statics, list(range(BATCH)), scenario, small,
        int(small.sim_time / small.dt), qp_iters=35))
    results["pipeline_data_split"] = {"census": census, "total": total,
                                      "expected": 1}

    rng = np.random.default_rng(0)
    samples = torch.as_tensor(rng.normal(size=(BATCH, n_samples, 2)),
                              dtype=torch.float32, device=dev)
    h = torch.as_tensor(rng.normal(size=(BATCH, 2)), dtype=torch.float32,
                        device=dev)
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    args = (p.alpha, p.delta, p.epsilon, p.robot_radius, p.obstacle_radius)
    _, census, total = _counted(
        lambda: sharded_halfspace_throughput(mesh, samples, h, *args))
    results["halfspace_data_split"] = {"census": census, "total": total,
                                       "expected": 1}

    (_, rounds), census, total = _counted(lambda: dr_cvar_g_sample_parallel(
        mesh, samples, h, *args, return_rounds=True))
    results["halfspace_sample_split"] = {"census": census, "total": total,
                                         "rounds": rounds,
                                         "expected": rounds + 4}
    return results


def main(argv=None):
    from ..cli import _parse_mesh_spec

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh", default="data=1")
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default=DEFAULT_DEVICE)
    args = parser.parse_args(argv)
    axes = _parse_mesh_spec(args.mesh)
    mesh = make_mesh(axes["data"], axes["samples"], device=args.device)
    try:
        results = analyze_mesh_programs(mesh)
        if mesh.rank == 0:
            print(json.dumps(results))
    finally:
        mesh.close()
    return results


if __name__ == "__main__":
    main()
