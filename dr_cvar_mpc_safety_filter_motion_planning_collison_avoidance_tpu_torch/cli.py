"""Command line of the PyTorch / CUDA port.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.cli \
        --scenario head_on --mode single [--preset paper] [--dtype float64] \
        [--device cuda|cpu] [--seed 42]
    ... --mode monte_carlo --mc_runs 300 [--save_dir results]
    ... --mode timing_analysis --sample_sizes 10,50,100,500,1000,1500 \
        --timing_runs 50 [--save_dir results]
    ... [--profile_dir DIR]   (a torch.profiler trace of the run)

The modes of the JAX package's CLI:

  * single: one scenario through the pipeline; prints each metric's
    solver status and IPM iterations and the minimum distance to
    collision with its verdict (the plots are not ported yet);
  * monte_carlo: the collision-probability study; prints the summary and
    saves `<scenario>_mc_data.npz` under --save_dir;
  * timing_analysis: the DR-CVaR computation-time sweep; writes the JAX
    package's artifacts under --save_dir.
"""

from __future__ import annotations

import argparse
import os

import torch

from .config import DEFAULT_DEVICE


def _dtype(args):
    return torch.float64 if args.dtype == "float64" else torch.float32


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
    return result


def run_timing(args):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    sizes = [int(n.strip()) for n in args.sample_sizes.split(",")]
    print(f"\nRunning DR-CVaR computation time analysis on {args.device}...")
    data = dct.evaluation.analyze_dr_cvar_computation_time(
        sample_sizes=sizes, n_runs=args.timing_runs, save_dir=args.save_dir,
        params=params, dtype=_dtype(args), device=args.device)
    print(f"Timing analysis complete. Results saved to {args.save_dir}")
    return data


def run_monte_carlo(args):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)
    print(f"Monte Carlo: {args.mc_runs} runs of {args.scenario} on "
          f"{args.device} ...")
    timer = dct.utils.Timer().start()
    result = dct.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=args.mc_runs, seed=args.seed,
        dtype=_dtype(args), device=args.device)
    print(f"Monte Carlo (run): {timer.stop(block=result):.6f} seconds")
    dct.evaluation.print_mc_summary(result)

    npz_path = os.path.join(args.save_dir, f"{args.scenario}_mc_data.npz")
    dct.evaluation.save_mc_result(result, npz_path)
    print(f"Saved MC arrays to {npz_path}")
    print("The MC comparison plot (viz.compare_risk_metrics) waits for the "
          "port of simulation/visualization.py")
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
    parser.add_argument("--save_dir", type=str, default="results")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of the run "
                             "into this directory (Chrome trace format)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
        trace)

    os.makedirs(args.save_dir, exist_ok=True)
    with trace(args.profile_dir):
        if args.mode == "single":
            result = run_single(args)
        elif args.mode == "timing_analysis":
            result = run_timing(args)
        else:
            result = run_monte_carlo(args)
    if args.profile_dir:
        print(f"Profiler trace written to {args.profile_dir}")
    return result


if __name__ == "__main__":
    main()
