"""MPC safety filter: condensed QP + batched interior-point solve.

Port of `MPCProblem`, `build_mpc_problem` and `_filter_core` of the JAX
package's models/mpc_filter.py, batched over a leading axis.  The
dynamics equalities are eliminated by condensation (X = Phi x0 +
Gamma U), leaving a dense QP in z = [U; slacks]:

  objective: sum_t (x_{t+1}-xref_{t+1})' Q (x_{t+1}-xref_{t+1}) + u_t' R u_t
             + sum_{t,j} (50 s_{t,j} + 50 s_{t,j}^2)
  constraints: u box, position box on C x_t for t = 1..H, and soft
             halfspace rows h.(C x_t) + g <= s_{t,j}, s >= 0.

Alignment quirk (the reference's): the halfspace computed at timestep t
constrains the state x_{t+1}.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.dynamics import condensed_dynamics
from ..ops.qp_ipm_structured import solve_mpc_qp

SLACK_LIN = 50.0   # linear slack penalty
SLACK_QUAD = 50.0  # quadratic slack penalty


@dataclasses.dataclass(frozen=True, eq=False)
class MPCProblem:
    """Static (shape-defining) data of the condensed MPC QP."""

    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    Phi: torch.Tensor      # [H*n, n]
    Gamma: torch.Tensor    # [H*n, H*m]
    Theta: torch.Tensor    # [H, p, H*m]  position rows of Gamma
    P: torch.Tensor        # [nz, nz] constant QP Hessian (x2 convention)
    horizon: int
    n_states: int
    n_inputs: int
    n_outputs: int
    n_obstacles: int
    q_weight: float
    r_weight: float


def build_mpc_problem(A, B, C, q_weight: float, r_weight: float,
                      horizon: int, n_obstacles: int) -> MPCProblem:
    """Precompute the condensed matrices and the constant Hessian, on
    A's device and in A's dtype."""
    n, m, p, H = A.shape[0], B.shape[1], C.shape[0], horizon
    dtype, device = A.dtype, A.device
    Phi, Gamma = condensed_dynamics(A, B, H)
    eye_H = torch.eye(H, dtype=dtype, device=device)
    Theta = (torch.kron(eye_H, C) @ Gamma).reshape(H, p, H * m)

    n_u, n_s = H * m, H * n_obstacles
    P = torch.zeros((n_u + n_s, n_u + n_s), dtype=dtype, device=device)
    P[:n_u, :n_u] = 2.0 * (q_weight * Gamma.T @ Gamma
                           + r_weight * torch.eye(n_u, dtype=dtype,
                                                  device=device))
    P[n_u:, n_u:] = 2.0 * SLACK_QUAD * torch.eye(n_s, dtype=dtype,
                                                 device=device)
    return MPCProblem(A, B, C, Phi, Gamma, Theta, P, H, n, m, p,
                      n_obstacles, q_weight, r_weight)


def _filter_core(prob: MPCProblem, x0, x_ref, hs_h, hs_g,
                 u_min, u_max, p_min, p_max, max_iters: int, tol):
    """Assemble and solve the condensed QPs of a batch.

    x0 [B, n]; x_ref [B, H+1, n]; hs_h [B, H, n_obs, 2] halfspace
    normals computed at timestep t (constraining x_{t+1}); hs_g
    [B, H, n_obs]; u_min/u_max [m] and p_min/p_max [p] box bounds (both
    box families present: the pipeline's layout, solved with the
    structured `box_theta` operators).

    Returns (u [B, H, m], slack [B, H, n_obs], MPCQPSolution, objective
    [B]); the objective includes the constant dropped by condensation,
    so it equals the reference problem's value.
    """
    H, n, m = prob.horizon, prob.n_states, prob.n_inputs
    n_obs = prob.n_obstacles
    n_u, n_s = H * m, H * n_obs
    dtype = prob.P.dtype
    Bsz = x0.shape[0]
    Phi, Gamma, Theta, C = prob.Phi, prob.Gamma, prob.Theta, prob.C

    phi_x0 = x0.to(dtype) @ Phi.T                             # [B, H*n]
    e0 = phi_x0 - x_ref[:, 1:H + 1].reshape(Bsz, -1).to(dtype)
    q_u = 2.0 * prob.q_weight * (e0 @ Gamma)
    pos0 = phi_x0.reshape(Bsz, H, n) @ C.T                    # [B, H, p]

    # Halfspace rows: h_{t,j} . (Theta_t u + pos0_t) + g <= s_{t,j}
    hs_h = hs_h.to(dtype)
    HS_u = torch.einsum("btjd,tdn->btjn", hs_h, Theta).reshape(Bsz, n_s, n_u)
    hs_rhs = (-hs_g.to(dtype) - torch.einsum("btjd,btd->btj", hs_h, pos0)
              ).reshape(Bsz, n_s)

    eye_u = torch.eye(n_u, dtype=dtype, device=x0.device)
    Theta_flat = Theta.reshape(-1, n_u)
    G_u = torch.cat([eye_u, -eye_u, Theta_flat, -Theta_flat], dim=0)
    pos0_flat = pos0.reshape(Bsz, -1)
    tile = lambda v: v.to(dtype).repeat(H).expand(Bsz, -1)   # noqa: E731
    h1 = torch.cat([tile(u_max), -tile(u_min), tile(p_max) - pos0_flat,
                    pos0_flat - tile(p_min)], dim=1)

    sol = solve_mpc_qp(prob.P[:n_u, :n_u], q_u, G_u, h1, HS_u, hs_rhs,
                       2.0 * SLACK_QUAD, SLACK_LIN, max_iters=max_iters,
                       tol=tol, box_theta=Theta_flat)
    objective = sol.obj + prob.q_weight * (e0 * e0).sum(-1)
    return (sol.u.reshape(Bsz, H, m), sol.s.reshape(Bsz, H, n_obs), sol,
            objective)
