"""Command line of the PyTorch / CUDA port.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.cli \
        --scenario head_on --mode single [--metric dr_cvar] [--animate] \
        [--preset paper] [--dtype float64] [--device cuda|cpu] [--seed 42]
    ... --mode monte_carlo --mc_runs 300 [--save_dir results]
    ... --mode timing_analysis --sample_sizes 10,50,100,500,1000,1500 \
        --timing_runs 50 [--save_dir results]
    ... [--profile_dir DIR]   (a torch.profiler trace of the run, with the
                              port's spans and counters in DIR/spans.json)
    torchrun --nproc_per_node N -m <this module> --mode monte_carlo \
        --mesh data=N[,samples=M] ...   (also timing_analysis)

The modes of the JAX package's CLI:

  * single: one scenario through the pipeline; prints each metric's
    solver status and IPM iterations and the minimum distance to
    collision with its verdict; saves `<scenario>_results.png` and
    `<scenario>_<metric>_halfspaces.png` (with --animate also
    `<scenario>_<metric>_animation.mp4`, or `.gif` where ffmpeg cannot
    write) under --save_dir;
  * monte_carlo: the collision-probability study; prints the summary and
    saves `<scenario>_mc_data.npz` and `<scenario>_mc_comparison.png`
    under --save_dir;
  * timing_analysis: the DR-CVaR computation-time sweep; writes the JAX
    package's artifacts under --save_dir.

The plots need matplotlib.  Where it is not installed the run prints one
line naming the plots it skips and goes on; --animate there is an error.

--mesh data=N[,samples=M] splits monte_carlo's runs and timing_analysis's
batches over a (data, samples) mesh of N x M processes, one device each
(`parallel/`): under torchrun with that many processes, or alone for
data=1 (a process group of one, set up here).  Only rank 0 prints the
summary and writes files.  Single mode ignores it.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import torch

from .config import DEFAULT_DEVICE


def _dtype(args):
    return torch.float64 if args.dtype == "float64" else torch.float32


def _parse_mesh_spec(spec: str) -> dict:
    """Parse `data=N[,samples=M]` into axis sizes."""
    axes = {"data": None, "samples": 1}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        name = name.strip()
        if (name not in axes or not value.strip().isdigit()
                or int(value) < 1):
            raise SystemExit(
                f"--mesh: bad axis spec '{part}' "
                "(expected data=N[,samples=M], sizes >= 1)")
        axes[name] = int(value)
    if axes["data"] is None:
        raise SystemExit("--mesh: a data=N axis is required")
    return axes


def build_mesh(args):
    """The mesh that --mesh asks for (None without it), on --device.

    Under torchrun the process group comes from its environment; alone,
    the mesh sets up a group of one.  Either way `make_mesh` sets it up
    here, so the mesh owns it and `close_mesh` ends it.  The mesh must
    use every process.
    """
    if not getattr(args, "mesh", None):
        return None
    from .parallel import make_mesh

    axes = _parse_mesh_spec(args.mesh)
    try:
        return make_mesh(n_data=axes["data"], n_samples=axes["samples"],
                         device=args.device)
    except ValueError as exc:
        raise SystemExit(
            f"--mesh {args.mesh}: {exc} (launch with torchrun "
            f"--nproc_per_node {axes['data'] * axes['samples']} -m "
            f"{__package__}.cli ...)") from exc


def close_mesh(mesh, finished: bool) -> None:
    """End the CLI's process group.  After a finished run every rank
    first waits at a barrier, so that none leaves while another still
    works (rank 0 writes and plots after the last collective); a rank
    that exits with its Gloo group alive can abort in the group's
    destructor.  After a failure the rank does not wait: torchrun stops
    the others."""
    import torch.distributed as dist

    if finished and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    mesh.close()


def _lead(mesh) -> bool:
    """Whether this process prints and writes: rank 0, or no mesh."""
    return mesh is None or mesh.rank == 0


def load_viz(skipped: str):
    """simulation/visualization.py, or None (after one line naming the
    plots that are skipped) where matplotlib is not installed."""
    try:
        from .simulation import visualization
    except ImportError:
        print(f"matplotlib is not installed: skipping {skipped}")
        return None
    return visualization


def run_single(args):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)

    print(f"Running scenario: {scenario.description} on {args.device}")
    result = dct.models.run_single_scenario(scenario, params, seed=args.seed,
                                            dtype=_dtype(args),
                                            device=args.device)

    print("\nMPC Feasibility Information:")
    for i, metric in enumerate(dct.models.METRICS):
        status = "optimal" if bool(result.qp_converged[0, i]) else "fallback"
        print(f"{metric} status: {status}  "
              f"(ipm_iters={int(result.qp_iterations[0, i])}, "
              f"gap={float(result.qp_gap[0, i]):.2e})")
    print(f"pipeline wall time: {result.wall_time_ms:.1f} ms "
          f"(all 3 metrics, kernel build included on a first CUDA run)")

    distances = {m: result.distances[0, i].cpu()
                 for i, m in enumerate(dct.models.METRICS)}
    distances["reference"] = result.reference_distance[0].cpu()
    for name, d in distances.items():
        d_min = float(d.min())
        verdict = "COLLISION" if d_min < 0 else "Safe"
        print(f"{name:10s}: min distance {d_min:+.4f}  [{verdict}]")

    metric = args.metric
    results_png = f"{args.scenario}_results.png"
    halfspaces_png = f"{args.scenario}_{metric}_halfspaces.png"
    viz = load_viz(f"{results_png} and {halfspaces_png}")
    if viz is None:
        return result
    viz.plot_distance_to_collision(
        distances, save_path=os.path.join(args.save_dir, results_png))
    idx = dct.models.METRICS.index(metric)
    hs = result.halfspaces.by_metric(metric)
    viz.visualize_trajectory_with_halfspaces(
        result.filtered_x[0, idx], result.obstacles.realization[0],
        hs.h[0], hs.g_tilde[0], params.robot_radius, params.obstacle_radius,
        title=(f"{args.scenario.capitalize()} Scenario with "
               f"{metric.upper()} Safe Halfspaces"),
        save_path=os.path.join(args.save_dir, halfspaces_png))
    print(f"Saved plots to {args.save_dir}/")

    if args.animate:
        print("\nCreating animation...")
        path = os.path.join(args.save_dir,
                            f"{args.scenario}_{metric}_animation.mp4")
        viz.animate_scenario(
            result.filtered_x[0, idx], result.obstacles.realization[0],
            params.robot_radius, params.obstacle_radius,
            hs.h[0], hs.g_tilde[0],
            title=(f"{args.scenario.capitalize()} Scenario with "
                   f"{metric.upper()} Safety Filtering"),
            save_path=path)
        print(f"Animation saved near {path}")
    return result


def run_timing(args, mesh=None):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    sizes = [int(n.strip()) for n in args.sample_sizes.split(",")]
    lead = _lead(mesh)
    if lead:
        if mesh is not None:
            print(f"Splitting the timing sweep over mesh {mesh.shape}")
        print(f"\nRunning DR-CVaR computation time analysis on "
              f"{args.device}...")
    data = dct.evaluation.analyze_dr_cvar_computation_time(
        sample_sizes=sizes, n_runs=args.timing_runs, save_dir=args.save_dir,
        params=params, dtype=_dtype(args), device=args.device, mesh=mesh)
    if lead:
        print(f"Timing analysis complete. Results saved to {args.save_dir}")
    return data


def run_monte_carlo(args, mesh=None):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)
    lead = _lead(mesh)
    if lead:
        if mesh is not None:
            print(f"Splitting the MC run axis over mesh {mesh.shape}")
        print(f"Monte Carlo: {args.mc_runs} runs of {args.scenario} on "
              f"{args.device} ...")
    timer = dct.utils.Timer().start()
    result = dct.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=args.mc_runs, seed=args.seed,
        dtype=_dtype(args), device=args.device, mesh=mesh)
    seconds = timer.stop(block=result)
    if not lead:
        return result
    print(f"Monte Carlo (run): {seconds:.6f} seconds")
    dct.evaluation.print_mc_summary(result)

    npz_path = os.path.join(args.save_dir, f"{args.scenario}_mc_data.npz")
    dct.evaluation.save_mc_result(result, npz_path)
    print(f"Saved MC arrays to {npz_path}")
    comparison_png = f"{args.scenario}_mc_comparison.png"
    viz = load_viz(comparison_png)
    if viz is not None:
        names = list(dct.models.METRICS) + ["reference"]
        viz.compare_risk_metrics(
            {name: result.min_distances[:, i]
             for i, name in enumerate(names)},
            save_path=os.path.join(args.save_dir, comparison_png),
            title=(f"{args.scenario}: min distance over {args.mc_runs} "
                   f"MC runs"))
        print(f"Saved MC comparison plot to {args.save_dir}/")
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run DR-CVaR Safety Filtering Scenarios "
                    "(PyTorch / CUDA port)")
    parser.add_argument("--scenario",
                        choices=["head_on", "overtaking", "intersection",
                                 "multi_obstacle"],
                        default="head_on")
    parser.add_argument("--mode",
                        choices=["single", "timing_analysis", "monte_carlo"],
                        default="single")
    parser.add_argument("--animate", action="store_true",
                        help="single mode: also save an animation "
                             "(needs matplotlib)")
    parser.add_argument("--metric", choices=["mean", "cvar", "dr_cvar"],
                        default="dr_cvar",
                        help="single mode: the metric whose halfspaces "
                             "are plotted")
    parser.add_argument("--sample_sizes", type=str,
                        default="10,50,100,500,1000,1500")
    parser.add_argument("--timing_runs", type=int, default=50)
    parser.add_argument("--mc_runs", type=int, default=300)
    parser.add_argument("--preset", choices=["custom", "paper"],
                        default="custom")
    parser.add_argument("--dtype", choices=["float32", "float64"],
                        default="float32")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default=DEFAULT_DEVICE,
                        help="the card unless cpu is asked for; with no "
                             "card the default fails, it does not move to "
                             "the CPU")
    parser.add_argument("--mesh", type=str, default=None,
                        help="split monte_carlo / timing_analysis over a "
                             "mesh of processes, e.g. data=2 or "
                             "data=2,samples=2, under torchrun with that "
                             "many processes (data=1 runs alone; single "
                             "mode ignores it)")
    parser.add_argument("--save_dir", type=str, default="results")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of the run "
                             "into this directory (trace.json, Chrome trace "
                             "format) and the port's own spans and counters "
                             "over it (spans.json)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.animate and importlib.util.find_spec("matplotlib") is None:
        parser.error("--animate needs matplotlib, which is not installed")

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
        trace)

    if args.mode == "single" and args.mesh:
        print("--mesh is ignored in --mode single "
              "(one scenario; use monte_carlo/timing_analysis)")
    mesh = None if args.mode == "single" else build_mesh(args)
    lead = _lead(mesh)
    finished = False
    try:
        if lead:
            os.makedirs(args.save_dir, exist_ok=True)
        with trace(args.profile_dir):
            if args.mode == "single":
                result = run_single(args)
            elif args.mode == "timing_analysis":
                result = run_timing(args, mesh)
            else:
                result = run_monte_carlo(args, mesh)
        finished = True
    finally:
        if mesh is not None:
            close_mesh(mesh, finished)
    if args.profile_dir and lead:
        print(f"Profiler trace written to {args.profile_dir}")
    return result


if __name__ == "__main__":
    main()
