"""Multi-process runs of the PyTorch port's `parallel/`, on Gloo.

`run_cluster` spawns `world` processes, joins them in one Gloo process
group through a FileStore (no TCP port, so concurrent test workers
cannot collide), runs a function of this module on every rank and
returns each rank's result.  A rank that raises, or a run that outlasts
its timeout, kills every rank and raises here: a hung collective never
outlives the timeout.

Spawned children import the module of the function they run, so this
module imports only torch, numpy and the port (never jax, and not the
tests' conftest).  The `*_checks` functions are the rank bodies of
tests/test_torch_parallel.py and tests/test_torch_distributed.py.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time
import traceback

import numpy as np
import torch

ARGS = (0.2, 0.1, 0.15, 0.3, 0.3)   # alpha, delta, epsilon, radii
# The pipeline batch of the JAX package's test_run_batch_sharded_pipeline
# and the Monte Carlo of its test_mc_mesh_and_nonmesh_agree.
PIPE = dict(horizon=6, sim_time=2.0, num_samples=8)
MC = dict(sim_time=4.0, num_samples=10)


def _entry(rank, world, store_path, env, fn, args, results):
    import torch.distributed as dist

    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_cluster(world: int, fn, args=(), store_dir=".", timeout=120.0,
                envs=None):
    """[fn(rank, world, *args) for each rank], each run in its own
    spawned process of one process group; `envs[rank]` is added to that
    rank's environment."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    envs = envs or [{}] * world
    procs = [ctx.Process(target=_entry, args=(rank, world, store, envs[rank],
                                              fn, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__}: {world} ranks did not "
                                   f"finish within {timeout} s; "
                                   f"finished: {sorted(out)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"{fn.__name__}: ranks {dead} died "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"{fn.__name__}: rank {rank} failed:\n"
                                   f"{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [out[r] for r in range(world)]


def _pt():
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
    return pt


def sample_inputs(seed, B, N):
    """float64 samples [B, N, 2] and unit normals h [B, 2]."""
    rng = np.random.default_rng(seed)
    samples = rng.normal(size=(B, N, 2))
    h = rng.normal(size=(B, 2))
    return samples, h / np.linalg.norm(h, axis=-1, keepdims=True)


def _sample_parallel(pt, mesh, samples, h):
    """g over the mesh with B replicated and with B over data, each with
    its rounds and collectives; the k-th largest of -s with its rounds."""
    par = pt.parallel
    s, hh = torch.as_tensor(samples), torch.as_tensor(h)
    out = {}
    for over in (False, True):
        par.CENSUS.clear()
        g, rounds = par.dr_cvar_g_sample_parallel(
            mesh, s, hh, *ARGS, batch_over_data=over, return_rounds=True)
        out[over] = (g.numpy(), rounds, sum(par.CENSUS.values()))
    n = samples.shape[1]
    k = max(min(int(np.ceil(ARGS[0] * n - 1e-12)), n), 1)
    n_local = n // mesh.shape["samples"]
    j = mesh.coordinate[1]
    x_local = -pt.ops.halfspace._project(s[:, j * n_local:(j + 1) * n_local],
                                         hh)
    v, _, rounds = par.sample_parallel.distributed_kth_largest(
        x_local, k, n, mesh)
    out["kth"] = (v.numpy(), k, rounds)
    return out


def _pipeline_batch(pt, mesh, dtype, seeds):
    params = dataclasses.replace(pt.config.get_parameters("custom"), **PIPE)
    scenario = pt.config.get_scenario_config("head_on")
    statics = pt.models.make_statics(scenario, params, dtype, mesh.device)
    pt.parallel.CENSUS.clear()
    out = pt.parallel.run_batch_sharded(
        mesh, statics, seeds, scenario, params,
        int(params.sim_time / params.dt))
    return [t.numpy() for t in out], sum(pt.parallel.CENSUS.values())


def meshless_pipeline_batch(pt, dtype, seeds):
    """run_batch_sharded's outputs for these seeds, without a mesh."""
    params = dataclasses.replace(pt.config.get_parameters("custom"), **PIPE)
    scenario = pt.config.get_scenario_config("head_on")
    statics = pt.models.make_statics(scenario, params, dtype, "cpu")
    mc = pt.evaluation.monte_carlo
    obs = mc.run_obstacles(statics, seeds, scenario, params,
                           int(params.sim_time / params.dt))
    res = pt.models.run_scenario_with_obstacles(
        statics, obs, scenario.ego_start, scenario.ego_goal,
        params.ego_velocity, qp_iters=35)
    min_d, conv = mc.reduce_runs(res)
    return min_d[:, :3].numpy(), min_d[:, 3].numpy(), conv.numpy()


def monte_carlo(pt, dtype, mesh=None, n_runs=10, seed=3):
    params = dataclasses.replace(pt.config.get_parameters("custom"), **MC)
    scenario = pt.config.get_scenario_config("head_on")
    res = pt.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=n_runs, seed=seed, dtype=dtype,
        device="cpu", mesh=mesh)
    return res.min_distances.numpy(), res.qp_converged.numpy()


def world2_checks(rank, world, samples, h, seeds):
    """(1, 2): sample-parallel; (2, 1): the pipeline batch in both
    dtypes."""
    pt = _pt()
    mesh = pt.parallel.make_mesh(1, 2, device="cpu")
    out = {"sp": _sample_parallel(pt, mesh, samples, h)}
    mesh = pt.parallel.make_mesh(2, 1, device="cpu")
    for dtype in (torch.float64, torch.float32):
        out[str(dtype)] = _pipeline_batch(pt, mesh, dtype, seeds)
    out["replicated"] = pt.parallel.replicated(
        torch.full((3,), float(rank + 1)), mesh).tolist()
    return out


def world4_checks(rank, world, sp_inputs, tp_inputs, timing_inputs):
    """(2, 2) and (1, 4): sample-parallel; (4, 1): the halfspace batch,
    the timing solvers, Monte Carlo in both dtypes; the census of
    parallel/scaling.py on (2, 2)."""
    pt = _pt()
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = pt.parallel.make_mesh(*shape, device="cpu")
        out[shape] = _sample_parallel(pt, mesh, *sp_inputs[shape])
    mesh = pt.parallel.make_mesh(4, 1, device="cpu")
    s, hh = (torch.as_tensor(a) for a in tp_inputs)
    out["throughput"] = pt.parallel.sharded_halfspace_throughput(
        mesh, s, hh, *ARGS).numpy()
    dr, cv = pt.parallel.make_sharded_timing_solvers(
        mesh, pt.config.Parameters())
    h_t = torch.as_tensor(np.array([1.0, 1.0]) / np.sqrt(2.0))
    out["timing"] = {B: (dr(torch.as_tensor(x), h_t).numpy(),
                         cv(torch.as_tensor(x), h_t).numpy())
                     for B, x in timing_inputs.items()}
    out["mc"] = {str(dt): monte_carlo(pt, dt, mesh)
                 for dt in (torch.float64, torch.float32)}
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.parallel import (
        scaling)
    out["census"] = scaling.analyze_mesh_programs(
        pt.parallel.make_mesh(2, 2, device="cpu"), n_samples=256)
    return out


def multihost_checks(rank, world, samples, h, big, hb, seeds):
    """The JAX package's distributed_worker.py on a 2-host x 2-rank
    cluster (GROUP_RANK / LOCAL_RANK set as torchrun sets them for two
    nodes): the host-aware mesh, the sample-parallel solve over it with
    B over hosts, a data-parallel batch over all four ranks, and the
    pipeline batch over the hosts."""
    pt = _pt()
    par = pt.parallel
    mesh = par.make_multihost_mesh(device="cpu")
    assert mesh.shape == {"data": 2, "samples": 2}, mesh.shape
    host = int(os.environ["GROUP_RANK"])
    assert mesh.coordinate[0] == host, (mesh.coordinate, host)
    row = torch.distributed.get_process_group_ranks(mesh.group("samples"))
    out = {"row": row}
    out["sp"] = par.dr_cvar_g_sample_parallel(
        mesh, torch.as_tensor(samples), torch.as_tensor(h), *ARGS,
        batch_over_data=True).numpy()
    flat = par.make_mesh(4, 1, device="cpu")
    out["dp"] = par.sharded_halfspace_throughput(
        flat, torch.as_tensor(big), torch.as_tensor(hb), *ARGS).numpy()
    out["pipe"], _ = _pipeline_batch(pt, mesh, torch.float32, seeds)
    return out
