"""Structure-exploiting batched IPM for the MPC safety-filter QP.

Port of the JAX package's ops/qp_ipm_structured.py, written over a
leading batch axis [B, ...] instead of under `vmap`.  Per instance:

  min_u,s  0.5 u'P_uu u + q_u'u + 0.5 s'(p_ss I)s + q_s's
  s.t.     G_u u <= h1          (input + position boxes, m1 rows)
           A u - s <= b         (soft halfspace rows,    m2 rows)
           -s <= 0              (slack nonnegativity,    m2 rows)

The slack block is eliminated analytically (its Newton block is
diagonal), so each iteration factors ONE n x n Schur matrix
(`cuda_linalg.batched_cholesky`) and solves two right-hand sides
(`cuda_linalg.batched_cho_solve`).  Mehrotra predictor-corrector,
centred start, best-iterate tracking, merit-based two-tier termination
and the active-set polish are those of the JAX solver.

Batching: every lane carries its own `done` and `stall` state, and a
lane's state is frozen once it stops, exactly as `vmap` of the JAX
`while_loop` freezes it, so each lane's `iterations` and iterates are
those of a solve on its own.  The loop runs until every lane has
stopped; its exit test reads one boolean back to the host per
iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_linalg import batched_cho_solve, batched_cholesky


class MPCQPSolution(NamedTuple):
    u: torch.Tensor           # [B, n]
    s: torch.Tensor           # [B, m2] slack variables
    obj: torch.Tensor         # [B]
    gap: torch.Tensor         # [B] complementarity from TRUE slacks
    prim_res: torch.Tensor    # [B]
    dual_res: torch.Tensor    # [B]
    converged: torch.Tensor   # [B] bool: best merit < 10*tol
    iterations: torch.Tensor  # [B] int32 IPM iterations
    merit: torch.Tensor       # [B] achieved scaled KKT merit
    mults: tuple              # (l1 [B, m1], l2 [B, m2], l3 [B, m2])


def _mv(M, v):
    """M v for M [r, c] (shared) or [B, r, c], v [B, c] -> [B, r]."""
    if M.dim() == 2:
        return v @ M.T
    return (M @ v[..., None])[..., 0]


def _rmv(M, w):
    """M' w for M [r, c] (shared) or [B, r, c], w [B, r] -> [B, c]."""
    if M.dim() == 2:
        return w @ M
    return (M.transpose(-1, -2) @ w[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def _max_or_zero(x):
    """Row max along the last axis; 0 for an empty constraint block."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return x.amax(-1)


def _pos_step(v, dv, frac: float):
    """Largest step in [0, 1] (times `frac`) keeping v + a dv >= 0."""
    if v.shape[-1] == 0:
        return v.new_ones(v.shape[:-1])
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(frac * ratio.amin(-1), max=1.0)


class _BoxOps:
    """G_u with the MPC box layout [I; -I; T; -T] (T = box_theta [hp, n]):
    matvecs need one T product and the weighted Gram matrix is a
    diagonal plus a T-sized product."""

    def __init__(self, T, n):
        self.T, self.n, self.hp = T, n, T.shape[0]

    def mv(self, v):
        Tv = v @ self.T.T
        return torch.cat([v, -v, Tv, -Tv], dim=-1)

    def rmv(self, w):
        n, hp = self.n, self.hp
        return (w[:, :n] - w[:, n:2 * n]
                + (w[:, 2 * n:2 * n + hp] - w[:, 2 * n + hp:]) @ self.T)

    def quad(self, d):
        n, hp = self.n, self.hp
        dT = d[:, 2 * n:2 * n + hp] + d[:, 2 * n + hp:]
        return (torch.diag_embed(d[:, :n] + d[:, n:2 * n])
                + (self.T.T * dT[:, None, :]) @ self.T)


class _DenseOps:
    def __init__(self, G):
        self.G = G

    def mv(self, v):
        return _mv(self.G, v)

    def rmv(self, w):
        return _rmv(self.G, w)

    def quad(self, d):
        return (self.G.transpose(-1, -2) * d[:, None, :]) @ self.G


def _where(cond, new, old):
    """Lane select: cond [B] picks `new` over `old` for each lane."""
    return torch.where(cond.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, p_ss, q_s,
                 max_iters: int = 60, tol: float | None = None,
                 box_theta=None) -> MPCQPSolution:
    """Solve a batch of the slack-structured QPs above.

    Shapes: q_u [B, n], h1 [B, m1], A [B, m2, n], b [B, m2];
    P_uu [n, n] and G_u [m1, n] shared by the batch, or [B, n, n] and
    [B, m1, n]; p_ss, q_s scalars or broadcastable to [B, m2].

    `box_theta` (optional, shared [hp, n]): G_u has the layout
    [I; -I; T; -T] with T = box_theta; every per-iteration product with
    G_u then uses the structure.  G_u must still be given (the polish
    and the reported residuals use its dense rows).

    The IPM's answer goes through the active-set Newton polish
    (`_polish`), which takes a float32 iterate from the IPM's merit floor
    (~1e-4 relative) to linear-solve accuracy (~1e-6).
    """
    dtype, device = q_u.dtype, q_u.device
    reg = 1e-10 if dtype == torch.float64 else 1e-7
    if tol is None:
        tol = 1e-9 if dtype == torch.float64 else 3e-5
    Bsz, n = q_u.shape
    m1, m2 = h1.shape[-1], b.shape[-1]
    if box_theta is not None:
        hp = box_theta.shape[0]
        if m1 != 2 * n + 2 * hp:
            raise ValueError(
                f"box_theta layout expects m1 == 2n + 2hp rows "
                f"(got m1={m1}, n={n}, hp={hp})")
        gu = _BoxOps(box_theta.to(dtype), n)
    else:
        gu = _DenseOps(G_u)
    m_total = m1 + 2 * m2
    p_ss = torch.as_tensor(p_ss, dtype=dtype, device=device).expand(Bsz, m2)
    q_s = torch.as_tensor(q_s, dtype=dtype, device=device).expand(Bsz, m2)

    q_scale = torch.clamp(torch.maximum(q_u.abs().amax(-1),
                                        q_s.abs().amax(-1)), min=1.0)
    eye = torch.eye(n, dtype=dtype, device=device)

    def merit_of(u, s, l1, l2, l3, w1, w2, w3):
        mu = (_dot(l1, w1) + _dot(l2, w2) + _dot(l3, w3)) / m_total
        Au = _mv(A, u)
        viol = torch.maximum(
            _max_or_zero(torch.relu(gu.mv(u) - h1)),
            torch.maximum(torch.relu(Au - s - b).amax(-1),
                          torch.relu(-s).amax(-1)))
        rd_u = (_mv(P_uu, u) + q_u + gu.rmv(l1) + _rmv(A, l2)).abs().amax(-1)
        rd_s = (p_ss * s + q_s - l2 - l3).abs().amax(-1)
        return (mu + viol + torch.maximum(rd_u, rd_s)) / q_scale, mu

    # Centred cold start.
    u = q_u.new_zeros((Bsz, n))
    s = q_u.new_zeros((Bsz, m2))
    w1 = torch.clamp(h1, min=1.0)
    w2 = torch.clamp(b, min=1.0)
    w3 = torch.ones_like(s)
    l1, l2, l3 = (torch.clamp(1.0 / w, 1e-6, 1e6) for w in (w1, w2, w3))
    x = [u, s, w1, w2, w3, l1, l2, l3]          # the iterate
    best_merit = torch.full((Bsz,), 1e30, dtype=dtype, device=device)
    best = list(x)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)
    stall = torch.zeros(Bsz, dtype=torch.int32, device=device)
    iters = torch.zeros(Bsz, dtype=torch.int32, device=device)

    active = ~done & (iters < max_iters)
    while bool(active.any()):
        u, s, w1, w2, w3, l1, l2, l3 = x
        merit, mu = merit_of(u, s, l1, l2, l3, w1, w2, w3)
        better = merit < best_merit
        # Stagnation / breakdown: count iterations without a 0.5%
        # best-merit improvement; a non-finite merit means the iterate
        # broke down and the tracked best iterate is the answer.
        improved = merit < best_merit * 0.995
        stall_n = torch.where(improved, torch.zeros_like(stall), stall + 1)
        broke = ~torch.isfinite(merit)
        best_merit_n = torch.where(better, merit, best_merit)
        best_n = [_where(better, new, old) for new, old in zip(x, best)]

        r_du = _mv(P_uu, u) + q_u + gu.rmv(l1) + _rmv(A, l2)
        r_ds = p_ss * s + q_s - l2 - l3
        r_p1 = gu.mv(u) + w1 - h1
        r_p2 = _mv(A, u) - s + w2 - b
        r_p3 = -s + w3

        d1 = torch.clamp(l1 / w1, 1e-10, 1e10)
        d2 = torch.clamp(l2 / w2, 1e-10, 1e10)
        d3 = torch.clamp(l3 / w3, 1e-10, 1e10)
        m_ss = p_ss + d2 + d3
        d2_eff = d2 - d2 * d2 / m_ss
        S = (P_uu + gu.quad(d1)
             + (A.transpose(-1, -2) * d2_eff[:, None, :]) @ A + reg * eye)
        Lchol = batched_cholesky(S)

        def newton(rc1, rc2, rc3):
            t_s = (-r_ds + d2 * r_p2 - rc2 / w2 + d3 * r_p3 - rc3 / w3)
            rhs = (-r_du - gu.rmv(d1 * r_p1 - rc1 / w1)
                   - _rmv(A, d2 * r_p2 - rc2 / w2)
                   + _rmv(A, d2 * t_s / m_ss))
            du = batched_cho_solve(Lchol, rhs)
            Adu = _mv(A, du)
            ds = (t_s + d2 * Adu) / m_ss
            dl1 = d1 * (gu.mv(du) + r_p1) - rc1 / w1
            dl2 = d2 * (Adu - ds + r_p2) - rc2 / w2
            dl3 = d3 * (-ds + r_p3) - rc3 / w3
            dw1 = -(rc1 + w1 * dl1) / l1
            dw2 = -(rc2 + w2 * dl2) / l2
            dw3 = -(rc3 + w3 * dl3) / l3
            return du, ds, dl1, dl2, dl3, dw1, dw2, dw3

        def steps(dl1, dl2, dl3, dw1, dw2, dw3, frac):
            a_p = torch.minimum(torch.minimum(_pos_step(w1, dw1, frac),
                                              _pos_step(w2, dw2, frac)),
                                _pos_step(w3, dw3, frac))
            a_d = torch.minimum(torch.minimum(_pos_step(l1, dl1, frac),
                                              _pos_step(l2, dl2, frac)),
                                _pos_step(l3, dl3, frac))
            return a_p[:, None], a_d[:, None]

        # Predictor.
        _, _, dl1_a, dl2_a, dl3_a, dw1_a, dw2_a, dw3_a = newton(
            l1 * w1, l2 * w2, l3 * w3)
        a_p, a_d = steps(dl1_a, dl2_a, dl3_a, dw1_a, dw2_a, dw3_a, 1.0)
        mu_aff = (_dot(l1 + a_d * dl1_a, w1 + a_p * dw1_a)
                  + _dot(l2 + a_d * dl2_a, w2 + a_p * dw2_a)
                  + _dot(l3 + a_d * dl3_a, w3 + a_p * dw3_a)) / m_total
        sm = ((mu_aff / torch.clamp(mu, min=1e-30)) ** 3 * mu)[:, None]

        # Corrector.
        du, ds, dl1, dl2, dl3, dw1, dw2, dw3 = newton(
            l1 * w1 + dl1_a * dw1_a - sm,
            l2 * w2 + dl2_a * dw2_a - sm,
            l3 * w3 + dl3_a * dw3_a - sm)
        a_p, a_d = steps(dl1, dl2, dl3, dw1, dw2, dw3, 0.99)

        conv = best_merit_n < tol
        done_n = done | conv | broke | (stall_n >= 10)
        stepped = [u + a_p * du, s + a_p * ds,
                   w1 + a_p * dw1, w2 + a_p * dw2, w3 + a_p * dw3,
                   l1 + a_d * dl1, l2 + a_d * dl2, l3 + a_d * dl3]
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

    merit, _ = merit_of(x[0], x[1], x[5], x[6], x[7], x[2], x[3], x[4])
    better = merit < best_merit
    best_merit = torch.where(better, merit, best_merit)
    u, s, w1, w2, w3, l1, l2, l3 = [_where(better, new, old)
                                    for new, old in zip(x, best)]

    pol = _polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
                  u, s, l1, l2, l3, w1, w2, w3)
    merit_p, _ = merit_of(*pol)
    use_p = torch.isfinite(merit_p) & (merit_p < best_merit)
    u, s, l1, l2, l3, w1, w2, w3 = [
        _where(use_p, new, old)
        for new, old in zip(pol, (u, s, l1, l2, l3, w1, w2, w3))]
    best_merit = torch.where(use_p, merit_p, best_merit)

    return _finalize(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, m_total, tol,
                     u, s, l1, l2, l3, best_merit, iters)


def _polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
            u, s, l1, l2, l3, w1, w2, w3):
    """Active-set Newton polish of a near-optimal IPM iterate.

    With the active set classified by l > w at the IPM's merit floor,
    every slack case eliminates analytically (penalised soft rows fold
    p_ss into the Hessian; soft rows at s = 0 become equalities on u),
    leaving an equality-constrained QP in u whose Schur complement runs
    over the <= n + 4 highest-multiplier active rows of [G_u; A],
    selected with `topk` + `gather`.  Tied zero scores pick inactive
    rows, which get va = 0 and decouple, so the tie order does not
    matter.  Two KKT refinement passes follow.  The caller keeps the
    polished iterate only where its merit is lower.
    """
    dtype, device = q_u.dtype, q_u.device
    Bsz, n = q_u.shape
    m1 = h1.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=device)
    zeros = torch.zeros_like

    a1 = l1 > w1
    a2 = l2 > w2
    a3 = l3 > w3
    m_pen = a2 & ~a3
    m_eq = a2 & a3

    # K and q_t are assembled, and the KKT residuals of the refinement
    # below evaluated, in float64; the factorisations and solves stay in
    # the working dtype.  In float32 their rounding (|K| ~ 1e3 on the
    # H = 30 MPC) left the float32 pipeline's controls 1.1e-4 (head_on)
    # and 1.1e-4 (multi_obstacle) from the scipy oracle on an H100
    # (700 W), over the 1e-4 the float32 path is held to; with them in
    # float64, 1.8e-5 and 2.1e-5 (seed-42 streams; on the CPU 1.1e-4
    # and 1.5e-4 against 3.0e-5 and 1.2e-5).
    acc = torch.float64
    A_h = A.to(acc)
    pen = torch.where(m_pen, p_ss, zeros(p_ss)).to(acc)
    K_h = (P_uu.to(acc) + (A_h.transpose(-1, -2) * pen[:, None, :]) @ A_h
           + reg * eye.to(acc))
    q_h = q_u.to(acc) + _rmv(A_h, torch.where(m_pen, q_s.to(acc) - p_ss.to(acc)
                                              * b.to(acc), zeros(b, dtype=acc)))
    K, q_t = K_h.to(dtype), q_h.to(dtype)

    G_b = G_u.expand(Bsz, m1, n) if G_u.dim() == 2 else G_u
    E = torch.cat([G_b, A], dim=1)                         # [B, m_rows, n]
    e = torch.cat([h1, b], dim=1)
    act = torch.cat([a1, m_eq], dim=1)
    l_all = torch.cat([l1, l2], dim=1)
    k_sel = min(n + 4, E.shape[1])

    score = torch.where(act, 1.0 + l_all, zeros(l_all))
    idx = torch.topk(score, k_sel, dim=1).indices          # [B, k_sel]
    va = torch.gather(act.to(dtype), 1, idx)
    Eg = torch.gather(E, 1, idx[:, :, None].expand(Bsz, k_sel, n))
    eg = torch.gather(e, 1, idx)

    LK = batched_cholesky(K)
    KiEq = batched_cho_solve(
        LK, torch.cat([Eg.transpose(1, 2), q_t[:, :, None]], dim=2))
    KiEg, Kiq = KiEq[:, :, :k_sel], KiEq[:, :, k_sel]
    Mg = (va[:, :, None] * (Eg @ KiEg) * va[:, None, :]
          + torch.diag_embed(1.0 - va)
          + reg * torch.eye(k_sel, dtype=dtype, device=device))
    rhs = va * (-_mv(Eg, Kiq) - eg)
    LM = batched_cholesky(Mg)
    nug = va * batched_cho_solve(LM, rhs)
    u_p = -(Kiq + _mv(KiEg, nug))

    # KKT iterative refinement of u and nu against
    #     K u + q_t + E_a' nu_a = 0,   E_a u = e_a.
    Eg_h, eg_h, va_h = (t.to(acc) for t in (Eg, eg, va))
    u_h, nu_h = u_p.to(acc), nug.to(acc)
    for _ in range(2):
        r1 = (_mv(K_h, u_h) + q_h + _rmv(Eg_h, nu_h)).to(dtype)
        r2 = (va_h * (_mv(Eg_h, u_h) - eg_h)).to(dtype)
        t = batched_cho_solve(LK, r1)
        dnu = va * batched_cho_solve(LM, r2 - va * _mv(Eg, t))
        u_h = u_h - (t + _mv(KiEg, dnu)).to(acc)
        nu_h = nu_h + dnu.to(acc)
    u_p, nug = u_h.to(dtype), nu_h.to(dtype)

    # Scatter the gathered multipliers back (inactive rows carry 0).
    nu = torch.zeros_like(e).scatter(1, idx, nug * va)

    Au = _mv(A, u_p)
    s_p = torch.relu(torch.where(m_pen, Au - b, zeros(b)))
    l1_p = torch.where(a1, torch.relu(nu[:, :m1]), zeros(l1))
    nu2 = nu[:, m1:]
    l2_p = torch.where(m_pen, p_ss * s_p + q_s,
                       torch.where(m_eq,
                                   torch.minimum(torch.relu(nu2), q_s),
                                   zeros(nu2)))
    l3_p = torch.relu(p_ss * s_p + q_s - l2_p)
    tiny = 1e-12 if dtype == torch.float64 else 1e-8
    w1_p = torch.clamp(h1 - _mv(G_u, u_p), min=tiny)
    w2_p = torch.clamp(b - Au + s_p, min=tiny)
    w3_p = torch.clamp(s_p, min=tiny)
    # Active rows are equalities now: zero their complementarity.
    w1_p = torch.where(a1, torch.full_like(w1_p, tiny), w1_p)
    w2_p = torch.where(a2, torch.full_like(w2_p, tiny), w2_p)
    w3_p = torch.where(a3, torch.full_like(w3_p, tiny), w3_p)
    return u_p, s_p, l1_p, l2_p, l3_p, w1_p, w2_p, w3_p


def _finalize(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, m_total, tol,
              u, s, l1, l2, l3, best_merit, iters) -> MPCQPSolution:
    """Reported objective and residuals; converged = best merit < 10 tol."""
    obj = (0.5 * _dot(u, _mv(P_uu, u)) + _dot(q_u, u)
           + 0.5 * _dot(p_ss * s, s) + _dot(q_s, s))
    Gu = _mv(G_u, u)
    Au = _mv(A, u)
    # Complementarity from TRUE slacks (h - Gz), not the w iterates.
    gap = (_dot(l1, torch.relu(h1 - Gu)) + _dot(l2, torch.relu(b - Au + s))
           + _dot(l3, torch.relu(s))) / m_total
    viol = torch.maximum(
        _max_or_zero(torch.relu(Gu - h1)),
        torch.maximum(torch.relu(Au - s - b).amax(-1),
                      torch.relu(-s).amax(-1)))
    rd = torch.maximum(
        (_mv(P_uu, u) + q_u + _rmv(G_u, l1) + _rmv(A, l2)).abs().amax(-1),
        (p_ss * s + q_s - l2 - l3).abs().amax(-1))
    converged = best_merit < 10.0 * tol
    return MPCQPSolution(u, s, obj, gap, viol, rd, converged, iters,
                         best_merit, (l1, l2, l3))
