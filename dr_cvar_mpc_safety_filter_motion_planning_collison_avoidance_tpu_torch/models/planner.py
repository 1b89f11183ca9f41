"""Reference trajectory planners.

Port of the JAX package's models/planner.py:

  * `straight_line_trajectory`, batched over scenarios: the analytic
    constant-velocity line with recovered inputs.  As there, when the
    goal is closer than one step the trajectory snaps to the goal (the
    reference raises ZeroDivisionError);
  * `plan_trajectory`: the goal-tracking QP planner (dead code in the
    reference, live API in the JAX package), condensed to input space
    and solved with the generic IPM (ops/qp_ipm.py), whose Cholesky
    factorisations and solves run on the batched kernels for float32
    systems of at most 64 inputs (a horizon of 30 with 2 inputs: 60).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.dynamics import condensed_dynamics
from ..ops.qp_ipm import solve_qp


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


def plan_trajectory(planner: Planner, x0, goal_state, input_bounds=None,
                    state_bounds=None, has_bounds: bool = False):
    """Goal-tracking QP planner for one start state x0 [n].

    Minimizes sum_t (x_{t+1} - goal)'Q(x_{t+1} - goal) + u_t'R u_t
    subject to the dynamics and, with `has_bounds`, the input box
    `input_bounds = (u_min, u_max)` and the state box `state_bounds =
    (x_min, x_max)`, as the constraints [I; -I; Gamma; -Gamma] of the
    condensed QP.  Without bounds the answer is the exact Newton solve.
    Returns (x_ref [H+1, n], u_ref [H, m], {"converged": bool tensor}).
    """
    H = planner.horizon
    n, m = planner.n_states, planner.n_inputs
    dtype, device = planner.A.dtype, planner.A.device
    as_t = lambda v: torch.as_tensor(v, dtype=dtype,  # noqa: E731
                                     device=device)
    x0 = as_t(x0)
    Phi, Gamma = condensed_dynamics(planner.A, planner.B, H)

    n_u = H * m
    eye_u = torch.eye(n_u, dtype=dtype, device=device)
    P = 2.0 * (planner.q_weight * Gamma.T @ Gamma + planner.r_weight * eye_u)
    phi_x0 = Phi @ x0
    q = 2.0 * planner.q_weight * (Gamma.T @ (phi_x0 - as_t(goal_state)
                                             .repeat(H)))

    if not has_bounds:
        u = -torch.linalg.solve(P, q)
        converged = torch.ones((), dtype=torch.bool, device=device)
    else:
        (u_min, u_max), (x_min, x_max) = input_bounds, state_bounds
        G = torch.cat([eye_u, -eye_u, Gamma, -Gamma])
        h = torch.cat([as_t(u_max).repeat(H), -as_t(u_min).repeat(H),
                       as_t(x_max).repeat(H) - phi_x0,
                       phi_x0 - as_t(x_min).repeat(H)])
        sol = solve_qp(P, q, G, h)
        u, converged = sol.z, sol.converged

    X = (phi_x0 + Gamma @ u).reshape(H, n)
    x_ref = torch.cat([x0[None], X])
    return x_ref, u.reshape(H, m), {"converged": converged}
