"""Safety-filtering environment: halfspaces along a trajectory, and
distance to collision.

Port of the JAX package's simulation/environment.py, batched over
scenarios.  Every (scenario, timestep, obstacle) halfspace of all three
risk metrics comes from ONE call of the all-metrics kernel
(ops/cuda_kernels.py) on a flat [S * n_steps * n_obs, N, 2] batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.dynamics import create_double_integrator_matrices
from ..ops.cuda_kernels import all_metrics_halfspaces
from ..ops.halfspace import Halfspace


class SafeHalfspaces(NamedTuple):
    """All three risk metrics' halfspaces, batch shape [S, n_steps, n_obs]."""

    mean: Halfspace
    cvar: Halfspace
    dr_cvar: Halfspace

    def by_metric(self, metric: str) -> Halfspace:
        return getattr(self, metric)


@dataclasses.dataclass(frozen=True, eq=False)
class Environment:
    """Radii, horizon, risk parameters and the system matrices, on one
    device and dtype."""

    robot_radius: float
    obstacle_radius: float
    horizon: int
    dt: float
    alpha: float
    delta: float
    epsilon: float
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cpu"

    def __post_init__(self):
        A, B, C = create_double_integrator_matrices(
            self.dt, dtype=self.dtype, device=self.device)
        object.__setattr__(self, "A", A)
        object.__setattr__(self, "B", B)
        object.__setattr__(self, "C", C)

    @property
    def n_states(self):
        return self.A.shape[0]

    @property
    def n_inputs(self):
        return self.B.shape[1]

    @property
    def n_outputs(self):
        return self.C.shape[0]


def halfspace_rows(env: Environment, obstacle_samples, x_ref):
    """The all-metrics kernel's input: one row of N samples per
    (scenario, timestep, obstacle), scenario-major.

    Args:
      obstacle_samples: [S, n_obs, n_samples, T+1, 2].
      x_ref: [S, H+1, n_states] ego reference trajectories.
    Returns:
      (rows [S*n_steps*n_obs, N, 2], ego [S*n_steps*n_obs, 2],
      (S, n_steps, n_obs)), both contiguous, with n_steps =
      min(H+1, horizon, T+1): with a sim_time shorter than the horizon
      there are no samples past the simulation's end, and the pipeline
      pads those rows as inactive constraints.
    """
    S, n_obs, n_samples = obstacle_samples.shape[:3]
    n_steps = min(x_ref.shape[-2], env.horizon, obstacle_samples.shape[-2])
    # [S, n_obs, N, n_steps, 2] -> [S, n_steps, n_obs, N, 2]
    rows = obstacle_samples[..., :n_steps, :].permute(0, 3, 1, 2, 4)
    rows = rows.to(env.dtype).reshape(-1, n_samples, 2).contiguous()
    ego_pos = x_ref[:, :n_steps].to(env.dtype) @ env.C.T     # [S, n_steps, 2]
    ego = ego_pos[:, :, None, :].expand(S, n_steps, n_obs, 2)
    return rows, ego.reshape(-1, 2).contiguous(), (S, n_steps, n_obs)


def compute_safe_halfspaces_for_trajectory(env: Environment,
                                           obstacle_samples, x_ref
                                           ) -> SafeHalfspaces:
    """Halfspaces for every (scenario, t, obstacle, metric) in one call.

    Args as `halfspace_rows`.  Returns SafeHalfspaces with batch shape
    [S, n_steps, n_obs].
    """
    rows, ego, shape = halfspace_rows(env, obstacle_samples, x_ref)
    out = all_metrics_halfspaces(rows, ego, env.alpha, env.delta,
                                 env.epsilon, env.robot_radius,
                                 env.obstacle_radius)
    h = out.h.reshape(shape + (2,))
    return SafeHalfspaces(
        mean=Halfspace(out.h_mean.reshape(shape + (2,)),
                       out.g_mean.reshape(shape)),
        cvar=Halfspace(h, out.g_cvar.reshape(shape)),
        dr_cvar=Halfspace(h, out.g_drcvar.reshape(shape)))


def compute_distance_to_collision(env: Environment, ego_trajectory,
                                  obstacle_trajectories):
    """Signed distance to the nearest obstacle at each step:
    min over obstacles of ||C x_t - obs_t|| - r_robot - r_obs.

    ego_trajectory [..., T_e+1, n_states]; obstacle_trajectories
    [..., n_obs, T_o+1, 2] (leading axes broadcast).  Returns
    [..., min(T_e, T_o)+1].
    """
    n_steps = min(ego_trajectory.shape[-2], obstacle_trajectories.shape[-2])
    ego_pos = ego_trajectory[..., :n_steps, :].to(env.dtype) @ env.C.T
    obs_pos = obstacle_trajectories[..., :n_steps, :].to(env.dtype)
    dist = torch.linalg.vector_norm(ego_pos[..., None, :, :] - obs_pos,
                                    dim=-1)
    dist = dist - env.robot_radius - env.obstacle_radius
    return dist.amin(-2)
