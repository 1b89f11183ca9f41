"""Batched dense primal-dual interior-point QP solver.

Port of the JAX package's ops/qp_ipm.py.  Solves, per instance,

    min_z  0.5 z'Pz + q'z   s.t.  G z <= h

with a Mehrotra predictor-corrector method, row equilibration of G,
best-iterate tracking, the stall and breakdown exits and acceptance at
10 tol; the duals come back in the caller's scale.  The generic solver
off the pipeline's path: the MPC filter uses the structured solver
(ops/qp_ipm_structured.py); `models.planner.plan_trajectory` uses this.

The batch is a leading axis [B, ...] of every argument instead of `vmap`.
Every lane carries its own `done` and `stall` state and is frozen once
it stops, exactly as `vmap` of the JAX `while_loop` freezes it, so a
lane's `iterations` and iterates are those of a solve on its own.  The
loop runs until every lane has stopped; its exit test reads one boolean
back to the host per iteration.

Every factorisation and solve goes through the structured solver's
`_factor` / `_solve`, which choose from dtype and shape alone: float32
systems with n <= 64 go to the batched Cholesky / solve kernels
(`cuda_linalg`; the hand kernels on a CUDA tensor), the rest to the
plain versions on the same device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .qp_ipm_structured import _dot, _factor, _mv, _pos_step, _rmv, _solve, _where


class QPSolution(NamedTuple):
    z: torch.Tensor           # [B, n] primal solution
    lam: torch.Tensor         # [B, m] dual multipliers for Gz <= h
    obj: torch.Tensor         # [B] objective 0.5 z'Pz + q'z
    gap: torch.Tensor         # [B] final complementarity measure mu
    prim_res: torch.Tensor    # [B] ||max(Gz - h, 0)||_inf (scaled rows)
    dual_res: torch.Tensor    # [B] ||Pz + q + G'lam||_inf (scaled rows)
    converged: torch.Tensor   # [B] bool: best merit < 10 tol
    iterations: torch.Tensor  # [B] int32 (until stopped, else max_iters)
    merit: torch.Tensor       # [B] achieved scaled KKT merit


def solve_qp(P, q, G, h, max_iters: int = 60, tol: float | None = None,
             reg: float = 0.0) -> QPSolution:
    """Primal-dual IPM solve of one QP: P [n, n], q [n], G [m, n], h [m].

    `tol` is the iteration target on the scaled KKT merit
    (complementarity + violation + dual residual, scaled by max|q|);
    iterations stop early on convergence, stagnation or breakdown.
    `converged` is True when the best merit is below 10 tol (in float32
    the achievable floor on ill-scaled data can sit just above a tight
    target); callers with another threshold read `merit`.  Defaults:
    tol 1e-9 (float64) / 3e-5 (float32), reg 1e-10 / 1e-7.
    """
    sol = solve_qp_batched(P[None], q[None], G[None], h[None], max_iters,
                           tol, reg)
    return QPSolution(*(t[0] for t in sol))


def solve_qp_batched(P, q, G, h, max_iters: int = 60,
                     tol: float | None = None,
                     reg: float = 0.0) -> QPSolution:
    """`solve_qp` over a leading batch axis of every argument:
    P [B, n, n], q [B, n], G [B, m, n], h [B, m]."""
    dtype, device = P.dtype, P.device
    if reg == 0.0:
        reg = 1e-10 if dtype == torch.float64 else 1e-7
    if tol is None:
        tol = 1e-9 if dtype == torch.float64 else 3e-5
    Bsz, n = q.shape
    m = G.shape[1]

    # Row equilibration: each constraint row scaled to unit inf-norm, so
    # constraints of very different scales keep the barrier centred.
    # G z <= h  <=>  (G/r) z <= h/r, with lam_orig = lam_scaled / r.
    row_scale = torch.clamp(G.abs().amax(-1), min=1e-8)
    G = G / row_scale[..., None]
    h = h / row_scale
    q_scale = torch.clamp(q.abs().amax(-1), min=1.0)
    eye = torch.eye(n, dtype=dtype, device=device)

    def merit_of(z, w, lam):
        """Scaled KKT merit: complementarity + true violation (max(Gz -
        h, 0), not |Gz + w - h|) + dual residual."""
        mu = _dot(lam, w) / m
        viol = torch.relu(_mv(G, z) - h).amax(-1)
        rd = (_mv(P, z) + q + _rmv(G, lam)).abs().amax(-1)
        return (mu + viol + rd) / q_scale

    z = q.new_zeros((Bsz, n))
    w = torch.clamp(h, min=1.0)          # slack: Gz + w = h
    # Centred start: lam_i w_i == 1 for every constraint.
    lam = torch.clamp(1.0 / w, 1e-6, 1e6)
    x = [z, w, lam]                      # the iterate
    best = list(x)
    best_merit = torch.full((Bsz,), 1e30, dtype=dtype, device=device)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)
    stall = torch.zeros(Bsz, dtype=torch.int32, device=device)
    iters = torch.zeros(Bsz, dtype=torch.int32, device=device)

    active = ~done & (iters < max_iters)
    while bool(active.any()):
        z, w, lam = x
        r_dual = _mv(P, z) + q + _rmv(G, lam)
        r_prim = _mv(G, z) + w - h
        mu = _dot(lam, w) / m

        # Best iterate: late steps at mu ~ eps are noise-dominated and
        # can degrade the iterates.  Stagnation (no 0.5% improvement of
        # the best merit) and breakdown (a non-finite merit) stop a lane.
        merit = merit_of(z, w, lam)
        better = merit < best_merit
        improved = merit < best_merit * 0.995
        stall_n = torch.where(improved, torch.zeros_like(stall), stall + 1)
        broke = ~torch.isfinite(merit)
        best_merit_n = torch.where(better, merit, best_merit)
        best_n = [_where(better, new, old) for new, old in zip(x, best)]

        d = torch.clamp(lam / w, 1e-10, 1e10)
        M = P + (G.transpose(-1, -2) * d[:, None, :]) @ G + reg * eye
        L = _factor(M)

        def newton(r_cent):
            rhs = -r_dual - _rmv(G, d * r_prim - r_cent / w)
            dz = _solve(L, rhs)
            dlam = d * (_mv(G, dz) + r_prim) - r_cent / w
            dw = -(r_cent + w * dlam) / lam
            return dz, dlam, dw

        # Affine (predictor) direction.
        _, dlam_a, dw_a = newton(lam * w)
        a_p = _pos_step(w, dw_a, 1.0)[:, None]
        a_d = _pos_step(lam, dlam_a, 1.0)[:, None]
        mu_aff = _dot(lam + a_d * dlam_a, w + a_p * dw_a) / m
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # Corrector.
        dz, dlam, dw = newton(lam * w + dlam_a * dw_a - (sigma * mu)[:, None])
        a_p = _pos_step(w, dw, 0.99)[:, None]
        a_d = _pos_step(lam, dlam, 0.99)[:, None]

        conv = best_merit_n < tol
        done_n = done | conv | broke | (stall_n >= 10)
        # A lane that stops now does not step.
        stepped = [z + a_p * dz, w + a_p * dw, lam + a_d * dlam]
        x_n = [_where(done_n, old, new) for new, old in zip(stepped, x)]
        iters_n = torch.where(done_n, iters, iters + 1)

        # A lane that had stopped before this pass keeps its whole state.
        x = [_where(active, new, old) for new, old in zip(x_n, x)]
        best = [_where(active, new, old) for new, old in zip(best_n, best)]
        best_merit = torch.where(active, best_merit_n, best_merit)
        done = torch.where(active, done_n, done)
        stall = torch.where(active, stall_n, stall)
        iters = torch.where(active, iters_n, iters)
        active = ~done & (iters < max_iters)

    # The final iterate may beat the tracked best (the loop checks first).
    merit = merit_of(*x)
    better = merit < best_merit
    best_merit = torch.where(better, merit, best_merit)
    z, w, lam = [_where(better, new, old) for new, old in zip(x, best)]

    obj = 0.5 * _dot(z, _mv(P, z)) + _dot(q, z)
    gap = _dot(lam, w) / m
    prim_res = torch.relu(_mv(G, z) - h).amax(-1)
    dual_res = (_mv(P, z) + q + _rmv(G, lam)).abs().amax(-1)
    return QPSolution(z, lam / row_scale, obj, gap, prim_res, dual_res,
                      best_merit < 10.0 * tol, iters, best_merit)
