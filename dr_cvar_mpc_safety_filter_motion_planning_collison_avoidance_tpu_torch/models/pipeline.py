"""End-to-end safety-filtering pipeline over a batch of scenarios.

Port of the JAX package's models/pipeline.py.  Obstacle generation ->
straight-line planning -> halfspaces under all three risk metrics ->
MPC filtering per metric -> distance to collision, for S scenarios at
once.  The JAX version vmaps the three metrics inside a vmap over
scenarios; here (scenario, metric) is ONE flat batch of S*3 QPs.  A
single scenario is S = 1.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, Parameters, Scenario
from ..core.dynamics import simulate_linear_system
from ..simulation.environment import (Environment, SafeHalfspaces,
                                      compute_distance_to_collision,
                                      compute_safe_halfspaces_for_trajectory)
from ..simulation.obstacles import ObstacleData, generate_obstacle_scenarios
from .mpc_filter import MPCProblem, _filter_core, build_mpc_problem
from .planner import Planner, straight_line_trajectory

METRICS = ("mean", "cvar", "dr_cvar")

# The reference's hard-coded bounds.
STATE_BOUNDS = (np.array([-10.0, -10.0, -5.0, -5.0]),
                np.array([10.0, 10.0, 5.0, 5.0]))
INPUT_BOUNDS = (np.array([-5.0, -5.0]), np.array([5.0, 5.0]))


class PipelineStatics(NamedTuple):
    """Objects shared across solves of one scenario shape, on one
    device and dtype."""

    env: Environment
    planner: Planner
    mpc: MPCProblem


class ScenarioResult(NamedTuple):
    """Outputs of a batch of S scenario runs.

    The metric axis follows METRICS = (mean, cvar, dr_cvar).
    """

    x_ref: torch.Tensor            # [S, H+1, n]
    u_ref: torch.Tensor            # [S, H, m]
    filtered_x: torch.Tensor       # [S, 3, H+1, n]
    filtered_u: torch.Tensor       # [S, 3, H, m]
    slack: torch.Tensor            # [S, 3, H, n_obs]
    qp_converged: torch.Tensor     # [S, 3] bool
    used_fallback: torch.Tensor    # [S, 3] bool
    objective: torch.Tensor        # [S, 3]
    qp_iterations: torch.Tensor    # [S, 3] int32 IPM iterations
    qp_gap: torch.Tensor           # [S, 3] final complementarity gap
    wall_time_ms: float            # host wall time; -1 unless measured
    distances: torch.Tensor        # [S, 3, T] per-metric distance
    reference_distance: torch.Tensor   # [S, T] unfiltered reference
    halfspaces: SafeHalfspaces     # batch [S, n_steps, n_obs]
    obstacles: ObstacleData

    def distance_for(self, metric: str):
        return self.distances[:, METRICS.index(metric)]


def pin_matmul_precision(device) -> None:
    """Full float32 matmuls: TF32 would put ~1e-3 errors into the QP data
    (the JAX package pins HIGHEST precision for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 matmul precision could not be pinned "
                           "to 'highest' (TF32 still enabled)")


def make_statics(scenario: Scenario, params: Parameters,
                 dtype=torch.float32, device=DEFAULT_DEVICE) -> PipelineStatics:
    """Environment, planner and MPC problem for a scenario shape
    (n_obstacles) and parameter preset."""
    env = Environment(
        robot_radius=params.robot_radius,
        obstacle_radius=params.obstacle_radius,
        horizon=params.horizon,
        dt=params.dt,
        alpha=params.alpha,
        delta=params.delta,
        epsilon=params.epsilon,
        dtype=dtype,
        device=torch.device(device),
    )
    planner = Planner(env.A, env.B, env.C, params.q_weight, params.r_weight,
                      params.horizon, params.dt)
    mpc = build_mpc_problem(env.A, env.B, env.C, params.q_weight,
                            params.r_weight, params.horizon,
                            scenario.n_obstacles)
    return PipelineStatics(env, planner, mpc)


def _batch2(v, S, dtype, device):
    """A [2] or [S, 2] position as an [S, 2] tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(S, 2)


def run_scenario_with_obstacles(statics: PipelineStatics,
                                obstacles: ObstacleData,
                                ego_start, ego_goal, ego_velocity: float,
                                qp_iters: int = 60,
                                qp_tol: float | None = None
                                ) -> ScenarioResult:
    """Pipeline stages downstream of obstacle generation, for S scenarios.

    obstacles: ObstacleData with a leading scenario axis (see
    simulation/obstacles.py); ego_start / ego_goal: [2] or [S, 2].
    """
    env, planner, mpc = statics
    dtype, device = env.dtype, env.device
    pin_matmul_precision(device)
    obstacles = ObstacleData(*(x.to(device=device, dtype=dtype)
                               for x in obstacles))
    S = obstacles.samples.shape[0]
    H, n, n_obs = env.horizon, env.n_states, mpc.n_obstacles
    ego_start = _batch2(ego_start, S, dtype, device)
    ego_goal = _batch2(ego_goal, S, dtype, device)

    x_ref, u_ref, _ = straight_line_trajectory(planner, ego_start, ego_goal,
                                               ego_velocity)
    halfspaces = compute_safe_halfspaces_for_trajectory(
        env, obstacles.samples, x_ref)

    # x0: position = ego_start, zero velocity.
    x0 = torch.zeros((S, n), dtype=dtype, device=device)
    x0[:, :2] = ego_start

    hs_h = torch.stack([halfspaces.by_metric(m).h for m in METRICS], dim=1)
    hs_g = torch.stack([halfspaces.by_metric(m).g_tilde for m in METRICS],
                       dim=1)                         # [S, 3, n_hs, n_obs]
    # sim_time shorter than the horizon: later timesteps have no obstacle
    # data, hence no safety constraint.  Pad with INACTIVE halfspaces
    # (unit normal, g~ = -1e4: an obstacle ~10 km away; slack stays 0).
    n_hs = hs_h.shape[2]
    if n_hs < H:
        pad_h = torch.zeros((S, 3, H - n_hs, n_obs, 2), dtype=dtype,
                            device=device)
        pad_h[..., 0] = 1.0
        pad_g = torch.full((S, 3, H - n_hs, n_obs), -1e4, dtype=dtype,
                           device=device)
        hs_h = torch.cat([hs_h, pad_h], dim=2)
        hs_g = torch.cat([hs_g, pad_g], dim=2)

    u_min, u_max = (torch.as_tensor(v, dtype=dtype, device=device)
                    for v in INPUT_BOUNDS)
    # The reference passes the 4-vector state bounds; the position box
    # keeps their first two entries.
    p_min, p_max = (torch.as_tensor(v[:2], dtype=dtype, device=device)
                    for v in STATE_BOUNDS)

    # One flat batch of S*3 QPs, scenario-major.
    B = S * 3
    u_opt, slack, sol, objective = _filter_core(
        mpc, x0.repeat_interleave(3, dim=0),
        x_ref.repeat_interleave(3, dim=0),
        hs_h.reshape(B, H, n_obs, 2), hs_g.reshape(B, H, n_obs),
        u_min, u_max, p_min, p_max, qp_iters, qp_tol)
    per = lambda t: t.reshape((S, 3) + t.shape[1:])   # noqa: E731

    # Fallback on non-convergence: no previous solution in a one-shot
    # run, so replay u_ref.
    use_fb = ~per(sol.converged)
    u_final = torch.where(use_fb[..., None, None], u_ref[:, None],
                          per(u_opt))
    x_final, _ = simulate_linear_system(x0[:, None, :].expand(S, 3, n),
                                        u_final, env.A, env.B, env.C)
    distances = compute_distance_to_collision(
        env, x_final, obstacles.realization[:, None])
    ref_distance = compute_distance_to_collision(env, x_ref,
                                                 obstacles.realization)
    return ScenarioResult(
        x_ref=x_ref, u_ref=u_ref,
        filtered_x=x_final, filtered_u=u_final, slack=per(slack),
        qp_converged=per(sol.converged), used_fallback=use_fb,
        objective=per(objective),
        qp_iterations=per(sol.iterations), qp_gap=per(sol.gap),
        wall_time_ms=-1.0,
        distances=distances, reference_distance=ref_distance,
        halfspaces=halfspaces, obstacles=obstacles,
    )


def run_scenario_core(statics: PipelineStatics, generator,
                      ego_start, ego_goal,
                      obstacle_starts, obstacle_directions, obstacle_speeds,
                      n_steps: int, n_samples: int,
                      noise_var: float, ego_velocity: float,
                      qp_iters: int = 60, qp_tol: float | None = None,
                      n_scenarios: int = 1) -> ScenarioResult:
    """The full pipeline for `n_scenarios` obstacle draws of one
    scenario: generate obstacles with `generator` (on the statics'
    device), then `run_scenario_with_obstacles`."""
    env = statics.env
    as_t = lambda v: torch.as_tensor(v, dtype=env.dtype,   # noqa: E731
                                     device=env.device)
    obstacles = generate_obstacle_scenarios(
        generator, as_t(obstacle_starts), as_t(obstacle_directions),
        as_t(obstacle_speeds), n_steps, env.dt, n_samples, noise_var,
        n_scenarios)
    return run_scenario_with_obstacles(statics, obstacles, ego_start,
                                       ego_goal, ego_velocity, qp_iters,
                                       qp_tol)


def run_single_scenario(scenario: Scenario, params: Parameters,
                        generator: torch.Generator | None = None,
                        seed: int = 42, dtype=torch.float32, device=DEFAULT_DEVICE,
                        statics: PipelineStatics | None = None
                        ) -> ScenarioResult:
    """Build statics, seed a generator, run one scenario (S = 1).

    `wall_time_ms` is the host time from the start of the run to the
    result's arrival on the host.
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    if statics is None:
        statics = make_statics(scenario, params, dtype, device)
    sim_time = (scenario.sim_time if scenario.sim_time is not None
                else params.sim_time)
    t0 = time.perf_counter()
    result = run_scenario_core(
        statics, generator, scenario.ego_start, scenario.ego_goal,
        scenario.obstacle_starts, scenario.obstacle_directions,
        scenario.obstacle_speeds, int(sim_time / params.dt),
        params.num_samples, params.noise_var, params.ego_velocity)
    float(result.objective.sum())   # the result has reached the host
    return result._replace(wall_time_ms=(time.perf_counter() - t0) * 1e3)
