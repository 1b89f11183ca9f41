"""Command line of the PyTorch / CUDA port: `--mode single`.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.cli \
        --scenario head_on --mode single [--preset paper] [--dtype float64] \
        [--device cpu|cuda] [--seed 42]

Runs one scenario through the port's pipeline and prints, as the JAX
package's CLI does, each metric's solver status and IPM iterations and
the minimum distance to collision with its verdict.  The plots and the
other modes (monte_carlo, timing_analysis) are not ported yet.
"""

from __future__ import annotations

import argparse

import torch


def run_single(args):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32

    print(f"Running scenario: {scenario.description} on {args.device}")
    result = dct.models.run_single_scenario(scenario, params, seed=args.seed,
                                            dtype=dtype, device=args.device)

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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run DR-CVaR Safety Filtering Scenarios "
                    "(PyTorch / CUDA port)")
    parser.add_argument("--scenario",
                        choices=["head_on", "overtaking", "intersection",
                                 "multi_obstacle"],
                        default="head_on")
    parser.add_argument("--mode", choices=["single"], default="single")
    parser.add_argument("--preset", choices=["custom", "paper"],
                        default="custom")
    parser.add_argument("--dtype", choices=["float32", "float64"],
                        default="float32")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default="cuda" if torch.cuda.is_available()
                        else "cpu")
    args = parser.parse_args(argv)
    return run_single(args)


if __name__ == "__main__":
    main()
