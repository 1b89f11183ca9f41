"""Straight-line reference planner, batched over scenarios.

Port of `Planner` and `straight_line_trajectory` of the JAX package's
models/planner.py.  As there, when the goal is closer than one step the
trajectory snaps to the goal (the reference raises ZeroDivisionError).
The goal-tracking QP planner `plan_trajectory` is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Planner:
    """System matrices and horizon."""

    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    q_weight: float
    r_weight: float
    horizon: int
    dt: float

    @property
    def n_states(self):
        return self.A.shape[0]

    @property
    def n_inputs(self):
        return self.B.shape[1]


def straight_line_trajectory(planner: Planner, start_pos, goal_pos,
                             velocity: float = 1.5):
    """Constant-velocity straight-line references with recovered inputs.

    start_pos, goal_pos: [S, 2].  Returns (x_ref [S, H+1, n], u_ref
    [S, H, m], info); inputs are recovered as u_t = B^+ (x_{t+1} - A x_t).
    """
    H, n = planner.horizon, planner.n_states
    dtype, device = planner.A.dtype, planner.A.device
    start_pos = start_pos.to(dtype)
    goal_pos = goal_pos.to(dtype)
    S = start_pos.shape[0]

    diff = goal_pos - start_pos
    distance = torch.linalg.vector_norm(diff, dim=-1)
    degenerate = distance < 1e-10
    direction = diff / torch.where(degenerate, torch.ones_like(distance),
                                   distance)[:, None]

    time_to_goal = distance / velocity
    n_steps = torch.floor(time_to_goal / planner.dt).to(torch.int32)
    steps = n_steps.to(dtype)[:, None]

    t = torch.arange(1, H + 1, dtype=dtype, device=device)[None, :]
    moving = (t <= steps)[..., None]                          # [S, H, 1]
    progress = t / torch.clamp(steps, min=1.0)
    pos = torch.where(moving,
                      start_pos[:, None, :] + progress[..., None]
                      * diff[:, None, :],
                      goal_pos[:, None, :])
    vel = torch.where(moving, velocity * direction[:, None, :],
                      torch.zeros((), dtype=dtype, device=device))

    x_ref = torch.zeros((S, H + 1, n), dtype=dtype, device=device)
    x_ref[:, 0, :2] = start_pos
    x_ref[:, 1:, :2] = pos
    x_ref[:, 1:, 2:] = vel
    # Degenerate start == goal: stationary at start with zero velocity.
    x_stat = torch.zeros_like(x_ref)
    x_stat[..., :2] = start_pos[:, None, :]
    x_ref = torch.where(degenerate[:, None, None], x_stat, x_ref)

    B_pinv = torch.linalg.pinv(planner.B)
    u_ref = (x_ref[:, 1:] - x_ref[:, :-1] @ planner.A.T) @ B_pinv.T
    u_ref = torch.where(degenerate[:, None, None], torch.zeros_like(u_ref),
                        u_ref)
    info = {"distance": distance, "time_to_goal": time_to_goal,
            "n_steps": n_steps}
    return x_ref, u_ref, info
