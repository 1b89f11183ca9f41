"""MPC safety filter: condensed QP + batched interior-point solve.

Port of the JAX package's models/mpc_filter.py, batched over a leading
axis: `MPCProblem`, `build_mpc_problem`, `_filter_core`,
`filter_core_batched`, `MPCResult` and `filter_trajectory`.  The
dynamics equalities are eliminated by condensation (X = Phi x0 +
Gamma U), leaving a dense QP in z = [U; slacks]:

  objective: sum_t (x_{t+1}-xref_{t+1})' Q (x_{t+1}-xref_{t+1}) + u_t' R u_t
             + sum_{t,j} (50 s_{t,j} + 50 s_{t,j}^2)
  constraints: u box, position box on C x_t for t = 1..H, and soft
             halfspace rows h.(C x_t) + g <= s_{t,j}, s >= 0.

Alignment quirk (the reference's): the halfspace computed at timestep t
constrains the state x_{t+1}.

When the solver does not converge, `filter_trajectory` replays the
previous optimal input sequence shifted by one step (or `u_ref` when
there is none); the fallback is computed for every lane and selected
with `torch.where` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config.parameters import DEFAULT_DEVICE
from ..core.dynamics import condensed_dynamics, simulate_linear_system
from ..ops.qp_ipm_structured import MPCQPSolution, solve_mpc_qp
from ..utils.timing import annotate

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


class MPCResult(NamedTuple):
    """One filtered trajectory, or a batch with a leading axis on every
    field."""

    x_filtered: torch.Tensor     # [H+1, n]
    u_filtered: torch.Tensor     # [H, m]
    slack: torch.Tensor          # [H, n_obs]
    status: torch.Tensor         # bool: QP converged (no fallback)
    used_fallback: torch.Tensor
    objective: torch.Tensor
    qp_gap: torch.Tensor
    qp_iterations: torch.Tensor


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


def _trim_bounds(bounds, dim):
    """Bounds longer than the constrained vector are trimmed to its
    leading entries (the reference's `state_bounds[:2]` call-site quirk).
    None when no bounds are given: those rows then leave the QP."""
    if bounds is None:
        return None
    lo, hi = (np.asarray(torch.as_tensor(v).detach().cpu(),
                         dtype=np.float64).reshape(-1)[:dim] for v in bounds)
    return lo, hi


def _filter_core(prob: MPCProblem, x0, x_ref, hs_h, hs_g,
                 u_min, u_max, p_min, p_max, max_iters: int, tol,
                 has_u_bounds: bool = True, has_p_bounds: bool = True,
                 warm=None):
    """Assemble and solve the condensed QPs of a batch.

    x0 [B, n]; x_ref [B, H+1, n]; hs_h [B, H, n_obs, 2] halfspace
    normals computed at timestep t (constraining x_{t+1}); hs_g
    [B, H, n_obs]; u_min/u_max [m] and p_min/p_max [p] box bounds.

    `has_u_bounds` / `has_p_bounds`: absent bounds drop their rows from
    the QP (their min/max arguments are not read).  With both present
    G_u has the [I; -I; Theta; -Theta] layout and the solver runs its
    structured `box_theta` operators; otherwise the dense ones, and with
    neither G_u is [0, n_u].

    `warm`: optional `(u, s, l1, l2, l3)` iterates of a related solve of
    the same shapes (see `solve_mpc_qp`).

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

    with annotate("filter.assemble"):
        phi_x0 = x0.to(dtype) @ Phi.T                             # [B, H*n]
        e0 = phi_x0 - x_ref[:, 1:H + 1].reshape(Bsz, -1).to(dtype)
        q_u = 2.0 * prob.q_weight * (e0 @ Gamma)
        pos0 = phi_x0.reshape(Bsz, H, n) @ C.T                    # [B, H, p]

        # Halfspace rows: h_{t,j} . (Theta_t u + pos0_t) + g <= s_{t,j}
        hs_h = hs_h.to(dtype)
        HS_u = torch.einsum("btjd,tdn->btjn", hs_h, Theta).reshape(
            Bsz, n_s, n_u)
        hs_rhs = (-hs_g.to(dtype) - torch.einsum("btjd,btd->btj", hs_h, pos0)
                  ).reshape(Bsz, n_s)

        eye_u = torch.eye(n_u, dtype=dtype, device=x0.device)
        Theta_flat = Theta.reshape(-1, n_u)
        pos0_flat = pos0.reshape(Bsz, -1)
        tile = lambda v: v.to(dtype).repeat(H).expand(Bsz, -1)   # noqa: E731
        G_blocks = [torch.zeros((0, n_u), dtype=dtype, device=x0.device)]
        h_blocks = [torch.zeros((Bsz, 0), dtype=dtype, device=x0.device)]
        if has_u_bounds:
            G_blocks += [eye_u, -eye_u]
            h_blocks += [tile(u_max), -tile(u_min)]
        if has_p_bounds:
            G_blocks += [Theta_flat, -Theta_flat]
            h_blocks += [tile(p_max) - pos0_flat, pos0_flat - tile(p_min)]
        G_u = torch.cat(G_blocks, dim=0)
        h1 = torch.cat(h_blocks, dim=1)

        box_theta = Theta_flat if (has_u_bounds and has_p_bounds) else None

    sol = solve_mpc_qp(prob.P[:n_u, :n_u], q_u, G_u, h1, HS_u, hs_rhs,
                       2.0 * SLACK_QUAD, SLACK_LIN, max_iters=max_iters,
                       tol=tol, warm=warm, box_theta=box_theta)
    objective = sol.obj + prob.q_weight * (e0 * e0).sum(-1)
    return (sol.u.reshape(Bsz, H, m), sol.s.reshape(Bsz, H, n_obs), sol,
            objective)


def filter_core_batched(prob: MPCProblem, x0_b, x_ref_b, hs_h_b, hs_g_b,
                        u_min, u_max, p_min, p_max, max_iters: int, tol,
                        chunk: int = 512):
    """`_filter_core` with the flat batch split into chunks of `chunk`,
    each with its own solver loop.

    One flat solve runs until its SLOWEST lane stops; a chunk retires
    when its own slowest lane does.  Lanes freeze one by one in the
    solver, so the chunking changes no lane's algorithm: in float64 a
    lane's result is the flat call's to rounding.  In float32 it is the
    flat call's only up to the solver's own tolerance, because a BLAS
    may round a lane's products differently at another batch size.  Any
    batch size works (the last chunk may be short); B <= chunk is one
    flat call.  Returns what `_filter_core` returns, concatenated along
    the batch axis (the MPCQPSolution's fields too).
    """
    B = x0_b.shape[0]
    parts = [_filter_core(prob, x0_b[i:i + chunk], x_ref_b[i:i + chunk],
                          hs_h_b[i:i + chunk], hs_g_b[i:i + chunk],
                          u_min, u_max, p_min, p_max, max_iters, tol)
             for i in range(0, B, chunk)]
    if len(parts) == 1:
        return parts[0]
    u, slack, sols, objective = zip(*parts)
    fields = {f: torch.cat([getattr(s, f) for s in sols])
              for f in MPCQPSolution._fields if f != "mults"}
    mults = tuple(torch.cat(ls) for ls in zip(*(s.mults for s in sols)))
    return (torch.cat(u), torch.cat(slack),
            MPCQPSolution(**fields, mults=mults), torch.cat(objective))


def filter_trajectory(prob: MPCProblem, x0, x_ref, u_ref, hs_h, hs_g,
                      input_bounds=None, position_bounds=None,
                      last_optimal_u=None, has_last=False,
                      max_iters: int = 60, tol: float | None = None,
                      device=DEFAULT_DEVICE) -> MPCResult:
    """Filter a reference trajectory, or a batch of them.

    Args:
      prob: MPCProblem from `build_mpc_problem`, on `device`.
      x0: [n] initial state.
      x_ref: [H+1, n] reference states; u_ref: [H, m] reference inputs.
      hs_h: [H, n_obs, 2] halfspace normals computed at timestep t
            (constraining x_{t+1}); hs_g: [H, n_obs] offsets.
      input_bounds / position_bounds: (min, max) pairs or None.  Bounds
        longer than the constrained vector are trimmed (the reference's
        `state_bounds[:2]` quirk); absent bounds drop their rows.
      last_optimal_u / has_last: the previous optimal inputs [H, m] for
        the fallback, and whether they exist.
      device: where the arrays go and the QP is solved.

    Every array may carry one leading batch axis (x0 [B, n], ...,
    has_last [B] or one bool); the result then has it on every field.
    Arrays are anything `torch.as_tensor` takes; they are cast to the
    problem's dtype.
    """
    device = torch.device(device)
    if prob.P.device.type != device.type:
        raise ValueError(f"filter_trajectory: the MPCProblem is on "
                         f"{prob.P.device}, device is {device}")
    dtype = prob.P.dtype
    H, m, p = prob.horizon, prob.n_inputs, prob.n_outputs
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    x0, x_ref, u_ref, hs_h, hs_g = map(as_t, (x0, x_ref, u_ref, hs_h, hs_g))
    single = x0.dim() == 1
    if single:
        x0, x_ref, u_ref, hs_h, hs_g = (t[None] for t in
                                        (x0, x_ref, u_ref, hs_h, hs_g))
    ub = _trim_bounds(input_bounds, m)
    pb = _trim_bounds(position_bounds, p)
    u_min, u_max = map(as_t, ub if ub else (np.zeros(m),) * 2)
    p_min, p_max = map(as_t, pb if pb else (np.zeros(p),) * 2)

    u_opt, slack, sol, objective = _filter_core(
        prob, x0, x_ref, hs_h, hs_g, u_min, u_max, p_min, p_max,
        max_iters, tol, has_u_bounds=ub is not None,
        has_p_bounds=pb is not None)

    # Fallback: the previous optimal sequence shifted by one step, its
    # tail padded with u_ref's last step; with no previous solution,
    # u_ref itself.
    if last_optimal_u is None:
        u_fb = u_ref
    else:
        last = as_t(last_optimal_u)
        last = last[None] if single else last
        shifted = torch.cat([last[:, 1:], u_ref[:, H - 1:H]], dim=1)
        has_last = torch.as_tensor(has_last, dtype=torch.bool, device=device)
        u_fb = torch.where(has_last.reshape(-1, 1, 1), shifted, u_ref)

    use_fallback = ~sol.converged
    u_final = torch.where(use_fallback[:, None, None], u_fb, u_opt)
    x_final, _ = simulate_linear_system(x0, u_final, prob.A, prob.B, prob.C)
    result = MPCResult(
        x_filtered=x_final, u_filtered=u_final, slack=slack,
        status=sol.converged, used_fallback=use_fallback,
        objective=objective, qp_gap=sol.gap, qp_iterations=sol.iterations)
    return MPCResult(*(t[0] for t in result)) if single else result
