"""Structure-exploiting batched IPM for the MPC safety-filter QP.

Port of the JAX package's ops/qp_ipm_structured.py, written over a
leading batch axis [B, ...] instead of under `vmap`.  Per instance:

  min_u,s  0.5 u'P_uu u + q_u'u + 0.5 s'(p_ss I)s + q_s's
  s.t.     G_u u <= h1          (input + position boxes, m1 rows)
           A u - s <= b         (soft halfspace rows,    m2 rows)
           -s <= 0              (slack nonnegativity,    m2 rows)

The slack block is eliminated analytically (its Newton block is
diagonal), so each iteration factors ONE n x n Schur matrix and solves
two right-hand sides.  Mehrotra predictor-corrector, centred (or warm)
start, best-iterate tracking, merit-based two-tier termination and the
active-set polish are those of the JAX solver.

Every factorisation and solve goes through `_factor` / `_solve`, which
choose per call, from dtype and shape alone (`use_linalg_kernels`), as
the JAX package's `_dispatch_chol` / `_dispatch_solve` do: float32
systems of n <= 64 with at most 256 right-hand sides go to
`cuda_linalg.batched_cholesky` / `batched_cho_solve` (the hand kernels
on a CUDA tensor); float64, a horizon above 32 (n = 2 H > 64) and the
polish's (n + 4)-wide system of a horizon above 30 go to the plain
versions on the same device.

Batching: every lane carries its own `done` and `stall` state, and a
lane's state is frozen once it stops, exactly as `vmap` of the JAX
`while_loop` freezes it, so each lane's `iterations` and iterates are
those of a solve on its own.  The loop runs until every lane has
stopped; its exit test reads one boolean back to the host per
iteration.

On a CUDA tensor the pass and the work after the loop are captured once
per key as CUDA graphs (`_Graphs`, at most `GRAPH_CACHE_SIZE` keys,
least recent dropped) and replayed: the same kernels in the same order,
kernels 2 and 3 among them, on static buffers that hold the call's data
and the loop's state.  The CPU runs the same functions op by op.

Fused pass: op by op a pass is ~470 small kernels, and even from a graph
the card spends ~1 ms a pass in the gaps between them.  Where
`use_fused_pass` takes a solve (float32 on a CUDA tensor, the box layout,
shared P_uu, n <= 64), the pass is six launches instead (`_fused_pass`:
three hand kernels of `cuda_ipm` around kernel 2 and kernel 3 twice);
`_one_pass` stays its plain version, and every other solve's.  Both
update the state's buffers in place (distinct contiguous copies,
`_dense`), and `_pass_of` picks one of them once a solve: the graph path
and the op-by-op path run the same pass on the same buffers.

Rescue: a float32 lane that stops unconverged (the stall rule, a
breakdown, or the iteration cap) is solved again in float64, warm from
its float32 iterate, and where that start does not converge it from the
cold start with one step length for primal and dual variables, op by op
(`_rescue`).

With the port's recorder on (`utils/timing.py`), each pass and its parts
are spans (`ipm.pass`; `ipm.residuals`, `ipm.factor`, `ipm.newton` twice,
`ipm.step`; the readback `ipm.sync`; after the loop `ipm.polish`,
`ipm.finalize`; `ipm.rescue`) and the solve counts `ipm.lanes`,
`ipm.passes`, `ipm.lane_passes` (the sum over passes of the lanes still
active: the readback then reads that number in place of the boolean),
`ipm.polish_kept` (lanes whose polished iterate is kept, one more
readback a solve), `ipm.graph_passes` (passes replayed from a graph),
`ipm.fused_passes` (passes run on the fused kernels), `ipm.rescued`,
`ipm.rescued_capped`, `ipm.rescued_cold` and `ipm.rescued_converged`.
On the graph path the pass's parts and the polish's inner spans fire only
while a graph is captured;
`ipm.pass` wraps a replay, `ipm.polish` the post-loop replay and
`ipm.finalize` the copy of its results.  Off, the spans and counters do
nothing and the loop reads back its boolean.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch

from ..utils import timing
from ..utils.timing import annotate
from . import cuda_ipm
from .cuda_ipm import ipm_predictor, ipm_residuals, ipm_step
from .cuda_linalg import (MAX_RHS, N_MAX, batched_cho_solve,
                          batched_cho_solve_plain, batched_cholesky,
                          batched_cholesky_plain)


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


def use_linalg_kernels(dtype, n: int, k: int = 1) -> bool:
    """Whether a system of size n with k right-hand sides goes to the
    batched Cholesky / solve kernels: what they take (float32, n <=
    N_MAX, k <= MAX_RHS).  The choice never looks at the device or at
    whether a launch succeeded."""
    return dtype == torch.float32 and n <= N_MAX and k <= MAX_RHS


def use_fused_pass(device_type: str, dtype, n: int, m2: int, hp,
                   shared: bool) -> bool:
    """Whether a solve's passes run on the fused pass kernels
    (`_fused_pass`): float32 on a CUDA tensor, the box layout (`hp`, the
    rows of box_theta, not None), P_uu shared and A per lane (`shared`),
    n <= N_MAX, hp <= cuda_ipm.HP_MAX and 1 <= m2 <= cuda_ipm.M2_MAX soft
    rows.  Decided from these alone, never from whether a launch
    succeeded."""
    return (device_type == "cuda" and dtype == torch.float32
            and hp is not None and shared and 1 <= n <= N_MAX
            and hp <= cuda_ipm.HP_MAX and 1 <= m2 <= cuda_ipm.M2_MAX)


POLISH_REFINEMENTS = 2   # KKT refinement passes of the polish


def _factor(S):
    """Lower Cholesky factors of S [B, n, n]; NaN where not SPD."""
    if use_linalg_kernels(S.dtype, S.shape[-1]):
        return batched_cholesky(S)
    return batched_cholesky_plain(S)


def _solve(L, r):
    """Solve L L' x = r; r is [B, n] or [B, n, k]."""
    k = 1 if r.dim() == L.dim() - 1 else r.shape[-1]
    if use_linalg_kernels(L.dtype, L.shape[-1], k):
        return batched_cho_solve(L, r)
    return batched_cho_solve_plain(L, r)


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


def _select_rows(score, k: int):
    """Indices of the k highest scores of each row (the polish's active
    rows)."""
    return torch.topk(score, k, dim=1).indices


def _where(cond, new, old):
    """Lane select: cond [B] picks `new` over `old` for each lane."""
    return torch.where(cond.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _still_active(active) -> bool:
    """The loop's exit test, its one readback a pass.  With the recorder
    on, the number of active lanes is read back in its place (one sync
    either way) and counted."""
    if not timing.RECORDING:
        return bool(active.any())
    with annotate("ipm.sync"):
        n = int(active.sum())
    if n:
        timing.count("ipm.passes")
        timing.count("ipm.lane_passes", n)
    return n > 0


class _Data(NamedTuple):
    """The tensors one solve reads after its set-up."""
    P_uu: torch.Tensor
    q_u: torch.Tensor
    G_u: torch.Tensor
    h1: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    p_ss: torch.Tensor              # [B, m2]
    q_s: torch.Tensor               # [B, m2]
    q_scale: torch.Tensor           # [B]
    eye: torch.Tensor               # [n, n]
    T: torch.Tensor | None          # box_theta in the working dtype


class _Spec(NamedTuple):
    """The numbers of a solve that its device work depends on.
    `one_step`: primal and dual variables take one step length, the
    smaller of the two (`_next_state`, so `_pass_of` then takes the plain
    pass; the rescue's cold float64 start alone sets it)."""
    m_total: int
    reg: float
    tol: float
    max_iters: int
    one_step: bool = False


class _State(NamedTuple):
    """The loop's state: the iterate (u, s, w1, w2, w3, l1, l2, l3), the
    best one, and each lane's best merit, stop flag, stall count,
    iterations and whether it is still active."""
    x: tuple
    best: tuple
    best_merit: torch.Tensor
    done: torch.Tensor
    stall: torch.Tensor
    iters: torch.Tensor
    active: torch.Tensor

    def flat(self) -> tuple:
        return (*self.x, *self.best, self.best_merit, self.done, self.stall,
                self.iters, self.active)

    @classmethod
    def of(cls, flat) -> "_State":
        return cls(tuple(flat[:8]), tuple(flat[8:16]), *flat[16:])

    def dense(self) -> "_State":
        """The state on distinct contiguous copies: what a pass updates."""
        return _State.of(_dense(self.flat()))


def _prepare(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, max_iters, tol,
             box_theta):
    """(_Data, _Spec) of a call: the defaults, the checks, the slack
    weights broadcast to [B, m2] and the merit's scale."""
    dtype, device = q_u.dtype, q_u.device
    reg = 1e-10 if dtype == torch.float64 else 1e-7
    if tol is None:
        tol = 1e-9 if dtype == torch.float64 else 3e-5
    Bsz, n = q_u.shape
    m1, m2 = h1.shape[-1], b.shape[-1]
    T = None
    if box_theta is not None:
        hp = box_theta.shape[0]
        if m1 != 2 * n + 2 * hp:
            raise ValueError(
                f"box_theta layout expects m1 == 2n + 2hp rows "
                f"(got m1={m1}, n={n}, hp={hp})")
        T = box_theta.to(dtype)
    p_ss = torch.as_tensor(p_ss, dtype=dtype, device=device).expand(Bsz, m2)
    q_s = torch.as_tensor(q_s, dtype=dtype, device=device).expand(Bsz, m2)
    q_scale = torch.clamp(torch.maximum(q_u.abs().amax(-1),
                                        q_s.abs().amax(-1)), min=1.0)
    eye = torch.eye(n, dtype=dtype, device=device)
    return (_Data(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, q_scale, eye, T),
            _Spec(m1 + 2 * m2, reg, float(tol), int(max_iters)))


def _ops(d: _Data):
    """G_u's products: the box structure where box_theta was given."""
    return _BoxOps(d.T, d.q_u.shape[1]) if d.T is not None else _DenseOps(d.G_u)


def _merit(d: _Data, gu, m_total, u, s, l1, l2, l3, w1, w2, w3):
    """(scaled KKT merit, mu) of an iterate."""
    mu = (_dot(l1, w1) + _dot(l2, w2) + _dot(l3, w3)) / m_total
    Au = _mv(d.A, u)
    viol = torch.maximum(
        _max_or_zero(torch.relu(gu.mv(u) - d.h1)),
        torch.maximum(torch.relu(Au - s - d.b).amax(-1),
                      torch.relu(-s).amax(-1)))
    rd_u = (_mv(d.P_uu, u) + d.q_u + gu.rmv(l1)
            + _rmv(d.A, l2)).abs().amax(-1)
    rd_s = (d.p_ss * s + d.q_s - l2 - l3).abs().amax(-1)
    return (mu + viol + torch.maximum(rd_u, rd_s)) / d.q_scale, mu


def _start(d: _Data, spec: _Spec, warm) -> _State:
    """The loop's first state: the centred cold start, or `warm` moved
    back into the interior."""
    gu = _ops(d)
    q_u, h1, b = d.q_u, d.h1, d.b
    Bsz, n = q_u.shape
    dtype, device = q_u.dtype, q_u.device
    if warm is None:
        # Centred cold start.
        u = q_u.new_zeros((Bsz, n))
        s = q_u.new_zeros((Bsz, b.shape[-1]))
        w1 = torch.clamp(h1, min=1.0)
        w2 = torch.clamp(b, min=1.0)
        w3 = torch.ones_like(s)
        l1, l2, l3 = (torch.clamp(1.0 / w, 1e-6, 1e6) for w in (w1, w2, w3))
    else:
        # A related solve's iterates, moved back into the interior: the
        # large floor keeps the central-path mu moderate, which lets a
        # start that is slightly off converge instead of jamming on the
        # boundary.
        floor = 1e-2
        u, s, l1, l2, l3 = (t.to(dtype) for t in warm)
        s = torch.relu(s)
        w1 = torch.clamp(h1 - gu.mv(u), min=floor)
        w2 = torch.clamp(b - _mv(d.A, u) + s, min=floor)
        w3 = torch.clamp(s, min=floor)
        l1, l2, l3 = (torch.clamp(t, floor, 1e6) for t in (l1, l2, l3))
    x = (u, s, w1, w2, w3, l1, l2, l3)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)
    iters = torch.zeros(Bsz, dtype=torch.int32, device=device)
    return _State(x, x, torch.full((Bsz,), 1e30, dtype=dtype, device=device),
                  done, torch.zeros(Bsz, dtype=torch.int32, device=device),
                  iters, ~done & (iters < spec.max_iters))


def _next_state(d: _Data, spec: _Spec, st: _State) -> _State:
    """One pass of the loop over every lane, op by op: the next state, in
    new tensors."""
    P_uu, q_u, h1, A, b, p_ss, q_s = d.P_uu, d.q_u, d.h1, d.A, d.b, d.p_ss, d.q_s
    m_total, tol, max_iters = spec.m_total, spec.tol, spec.max_iters
    gu = _ops(d)
    x, best, best_merit = st.x, st.best, st.best_merit
    done, stall, iters, active = st.done, st.stall, st.iters, st.active
    with annotate("ipm.residuals"):
        u, s, w1, w2, w3, l1, l2, l3 = x
        merit, mu = _merit(d, gu, m_total, u, s, l1, l2, l3, w1, w2, w3)
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
             + (A.transpose(-1, -2) * d2_eff[:, None, :]) @ A
             + spec.reg * d.eye)
    with annotate("ipm.factor"):
        Lchol = _factor(S)

    def newton(rc1, rc2, rc3):
        t_s = (-r_ds + d2 * r_p2 - rc2 / w2 + d3 * r_p3 - rc3 / w3)
        rhs = (-r_du - gu.rmv(d1 * r_p1 - rc1 / w1)
               - _rmv(A, d2 * r_p2 - rc2 / w2)
               + _rmv(A, d2 * t_s / m_ss))
        du = _solve(Lchol, rhs)
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

    with annotate("ipm.newton"):
        # Predictor.
        _, _, dl1_a, dl2_a, dl3_a, dw1_a, dw2_a, dw3_a = newton(
            l1 * w1, l2 * w2, l3 * w3)
        a_p, a_d = steps(dl1_a, dl2_a, dl3_a, dw1_a, dw2_a, dw3_a, 1.0)
        mu_aff = (_dot(l1 + a_d * dl1_a, w1 + a_p * dw1_a)
                  + _dot(l2 + a_d * dl2_a, w2 + a_p * dw2_a)
                  + _dot(l3 + a_d * dl3_a, w3 + a_p * dw3_a)) / m_total
        sm = ((mu_aff / torch.clamp(mu, min=1e-30)) ** 3 * mu)[:, None]
    with annotate("ipm.newton"):
        # Corrector.
        du, ds, dl1, dl2, dl3, dw1, dw2, dw3 = newton(
            l1 * w1 + dl1_a * dw1_a - sm,
            l2 * w2 + dl2_a * dw2_a - sm,
            l3 * w3 + dl3_a * dw3_a - sm)
    with annotate("ipm.step"):
        a_p, a_d = steps(dl1, dl2, dl3, dw1, dw2, dw3, 0.99)
        if spec.one_step:
            a_p = a_d = torch.minimum(a_p, a_d)

        conv = best_merit_n < tol
        done_n = done | conv | broke | (stall_n >= 10)
        stepped = [u + a_p * du, s + a_p * ds,
                   w1 + a_p * dw1, w2 + a_p * dw2, w3 + a_p * dw3,
                   l1 + a_d * dl1, l2 + a_d * dl2, l3 + a_d * dl3]
        x_n = [_where(done_n, old, new) for new, old in zip(stepped, x)]
        iters_n = torch.where(done_n, iters, iters + 1)

        # A lane that had stopped before this pass keeps its whole state.
        x = tuple(_where(active, new, old) for new, old in zip(x_n, x))
        best = tuple(_where(active, new, old)
                     for new, old in zip(best_n, best))
        best_merit = torch.where(active, best_merit_n, best_merit)
        done = torch.where(active, done_n, done)
        stall = torch.where(active, stall_n, stall)
        iters = torch.where(active, iters_n, iters)
        active = ~done & (iters < max_iters)
    return _State(x, best, best_merit, done, stall, iters, active)


def _one_pass(d: _Data, spec: _Spec, st: _State) -> _State:
    """One pass of the loop op by op, the plain version of `_fused_pass`:
    updates `st`'s buffers in place (they must be distinct) with
    `_next_state` and returns `st`."""
    for dst, src in zip(st.flat(), _next_state(d, spec, st).flat()):
        dst.copy_(src)
    return st


def _lanes(d: _Data, st: _State) -> cuda_ipm.Lanes:
    """The fused kernels' pointer table of a solve's data and state."""
    return cuda_ipm.lanes((d.P_uu, d.T, d.q_u, d.h1, d.A, d.b, d.p_ss,
                           d.q_s, d.q_scale, *st.x, *st.best, st.best_merit,
                           st.done, st.stall, st.iters, st.active))


def _fused_pass(d: _Data, spec: _Spec, st: _State) -> _State:
    """One pass of the loop on the fused kernels, the same pass as
    `_one_pass` (to the order of sums): kernel A (merit, bookkeeping, D,
    S, predictor right-hand side), `_factor`, `_solve`, kernel B
    (predictor step, corrector right-hand side), `_solve`, kernel C
    (corrector step).  Updates `st`'s buffers in place (they must be
    distinct and contiguous, as `d`'s) and returns `st`."""
    lanes = _lanes(d, st)
    with annotate("ipm.residuals"):
        S, rhs, work = ipm_residuals(lanes, spec.reg, spec.tol,
                                     spec.max_iters)
    with annotate("ipm.factor"):
        L = _factor(S)
    with annotate("ipm.newton"):
        ipm_predictor(lanes, work, _solve(L, rhs), rhs)
    with annotate("ipm.newton"):
        du = _solve(L, rhs)
    with annotate("ipm.step"):
        ipm_step(lanes, work, du)
    return st


# Counters a pass adds each time it runs, op by op or replayed.
_one_pass.counters = ()
_fused_pass.counters = ("ipm.fused_passes",)


def _pass_of(d: _Data, one_step: bool = False):
    """The pass a prepared solve runs, chosen once a solve from its data's
    metadata: `_fused_pass` where `use_fused_pass` takes it, else
    `_one_pass`; with `one_step` (the solve's `_Spec.one_step`) always
    `_one_pass`, which alone takes one step length."""
    fused = not one_step and use_fused_pass(
        d.q_u.device.type, d.q_u.dtype, d.q_u.shape[1], d.b.shape[-1],
        None if d.T is None else d.T.shape[0],
        d.P_uu.dim() == 2 and d.A.dim() == 3)
    return _fused_pass if fused else _one_pass


def _count_pass(step):
    """Count one run of the pass `step`, op by op or replayed."""
    for name in step.counters:
        timing.count(name)


def _dense(tensors) -> list:
    """Distinct contiguous copies: the buffers a pass updates."""
    return [None if t is None else t.contiguous().clone() for t in tensors]


def _post(d: _Data, spec: _Spec, st: _State):
    """After the loop: the best iterate, its polish where that lowers the
    merit, and the reported solution.  Returns (MPCQPSolution, the lanes
    whose polished iterate is kept)."""
    gu = _ops(d)
    x, best = st.x, st.best
    with annotate("ipm.polish"):
        merit, _ = _merit(d, gu, spec.m_total, x[0], x[1], x[5], x[6], x[7],
                          x[2], x[3], x[4])
        better = merit < st.best_merit
        best_merit = torch.where(better, merit, st.best_merit)
        u, s, w1, w2, w3, l1, l2, l3 = [_where(better, new, old)
                                        for new, old in zip(x, best)]

        pol = _polish(d.P_uu, d.q_u, d.G_u, d.h1, d.A, d.b, d.p_ss, d.q_s,
                      spec.reg, u, s, l1, l2, l3, w1, w2, w3)
        merit_p, _ = _merit(d, gu, spec.m_total, *pol)
        use_p = torch.isfinite(merit_p) & (merit_p < best_merit)
        u, s, l1, l2, l3, w1, w2, w3 = [
            _where(use_p, new, old)
            for new, old in zip(pol, (u, s, l1, l2, l3, w1, w2, w3))]
        best_merit = torch.where(use_p, merit_p, best_merit)
    with annotate("ipm.finalize"):
        sol = _finalize(d.P_uu, d.q_u, d.G_u, d.h1, d.A, d.b, d.p_ss, d.q_s,
                        spec.m_total, spec.tol, u, s, l1, l2, l3, best_merit,
                        st.iters)
    return sol, use_p


def _ipm_eager(d: _Data, spec: _Spec, warm) -> MPCQPSolution:
    """The solve without graphs, pass by pass: the CPU's path and the
    rescue's (op by op), and on the card the graph path's reference (the
    same pass, `_pass_of`'s, on the same buffers)."""
    step = _pass_of(d, spec.one_step)
    st = _start(d, spec, warm).dense()
    d = _Data(*_dense(d))
    while _still_active(st.active):
        with annotate("ipm.pass"):
            step(d, spec, st)
            _count_pass(step)
    sol, use_p = _post(d, spec, st)
    if timing.RECORDING:
        timing.count("ipm.polish_kept", int(use_p.sum()))
    return sol


GRAPH_CACHE_SIZE = 8     # keys whose graphs are kept, least recent dropped
_KERNELS = (batched_cholesky, batched_cho_solve, ipm_residuals,
            ipm_predictor, ipm_step)               # they own `.launches`


def _graph_key(d: _Data, spec: _Spec, step) -> tuple:
    """Everything that changes the captured work: every tensor's device,
    dtype and shape (so B, n, m1, m2, shared or per-lane P_uu and G_u,
    box or dense), the numbers of the spec, the pass (`_pass_of`'s) and
    the process's float32 matmul settings.  Code that rebinds the names
    the work calls drops `_GRAPHS` instead (qpbench's `variant`)."""
    return (tuple(None if t is None else (t.device, t.dtype, tuple(t.shape))
                  for t in d),
            spec, step,
            # A caller of `filter_trajectory` outside the pipeline can turn
            # TF32 on for the whole process, and the captured plain pass and
            # polish run torch matmuls.
            torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32)


def _capture(fn):
    """(graph, fn's result) with fn's device work captured on the current
    stream; a capture that fails raises, after ending the capture.  Only
    this thread's unsafe CUDA calls break the capture (another thread's,
    such as a process group's watchdog polling its events, do not)."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        out = fn()
    except BaseException:
        with contextlib.suppress(RuntimeError):
            graph.capture_end()
        raise
    graph.capture_end()
    return graph, out


class _Graphs:
    """The CUDA graphs of one key: a pass of the loop (`step`), and the
    work after it (best iterate, polish, acceptance, finalize).  Both read
    and write only static buffers (`_dense`): the call's data is copied
    into `d` and its first state into `state` before the loop; the pass
    updates `state` in place; the post graph's results are cloned out by
    the caller.  The hand kernels' `.launches` count each replay's
    launches; the warm-up and the capture are not counted."""

    _side: dict = {}       # device -> the stream the graphs are captured on

    def __init__(self, d: _Data, st0: _State, step):
        self.step = step
        self.d = _Data(*_dense(d))
        self.state = st0.dense()

    def load(self, d: _Data, st0: _State):
        for dst, src in zip(self.d, d):
            if dst is not None:
                dst.copy_(src)
        for dst, src in zip(self.state.flat(), st0.flat()):
            dst.copy_(src)

    def capture(self, spec: _Spec):
        """Warm up one pass on copies of the state, on the capture stream
        (library handles and lazily loaded kernels are set up outside any
        capture), then capture the pass and the post-loop work."""
        device = self.d.q_u.device
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        before = [fn.launches for fn in _KERNELS]
        try:
            with torch.cuda.stream(side):
                self.step(self.d, spec, self.state.dense())
                mid = [fn.launches for fn in _KERNELS]
                self.pass_graph, _ = _capture(
                    lambda: self.step(self.d, spec, self.state))
                after_pass = [fn.launches for fn in _KERNELS]
                self.post_graph, (self.sol, self.use_p) = _capture(
                    lambda: _post(self.d, spec, self.state))
                after_post = [fn.launches for fn in _KERNELS]
        finally:
            for fn, n in zip(_KERNELS, before):
                fn.launches = n
        current.wait_stream(side)
        self.pass_launches = [b - a for a, b in zip(mid, after_pass)]
        self.post_launches = [b - a for a, b in zip(after_pass, after_post)]

    def replay_pass(self):
        self.pass_graph.replay()
        for fn, n in zip(_KERNELS, self.pass_launches):
            fn.launches += n
        timing.count("ipm.graph_passes")
        _count_pass(self.step)

    def replay_post(self):
        self.post_graph.replay()
        for fn, n in zip(_KERNELS, self.post_launches):
            fn.launches += n


_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def _ipm_graphs(d: _Data, spec: _Spec, warm) -> MPCQPSolution:
    """The solve on a CUDA tensor: the first state op by op, then each
    pass and the post-loop work replayed from the key's graphs, captured
    at the key's first call.  Passes, iterations and every lane's
    iterates are the eager loop's: the same kernels run in the same
    order, and the loop reads back `active` once a pass as it does."""
    step = _pass_of(d, spec.one_step)
    key = _graph_key(d, spec, step)
    st0 = _start(d, spec, warm)
    graphs = _GRAPHS.pop(key, None)
    if graphs is None:
        graphs = _Graphs(d, st0, step)
        graphs.load(d, st0)
        graphs.capture(spec)
    else:
        graphs.load(d, st0)
    _GRAPHS[key] = graphs
    while len(_GRAPHS) > GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    while _still_active(graphs.state.active):
        with annotate("ipm.pass"):
            graphs.replay_pass()
    with annotate("ipm.polish"):
        graphs.replay_post()
    with annotate("ipm.finalize"):
        sol = graphs.sol
        sol = MPCQPSolution(*(t.clone() for t in sol[:-1]),
                            tuple(t.clone() for t in sol.mults))
    if timing.RECORDING:
        timing.count("ipm.polish_kept", int(graphs.use_p.sum()))
    return sol


def _lanes64(d: _Data, spec: _Spec, idx):
    """(_Data, _Spec) of lanes `idx` of a call in float64, with the call's
    cap and tolerance."""
    f64 = torch.float64
    lanes = lambda t: t[idx].to(f64)                          # noqa: E731
    per_lane = lambda t: (t[idx] if t.dim() == 3 else t).to(f64)  # noqa: E731
    return _prepare(per_lane(d.P_uu), lanes(d.q_u), per_lane(d.G_u),
                    lanes(d.h1), lanes(d.A), lanes(d.b), lanes(d.p_ss),
                    lanes(d.q_s), spec.max_iters, spec.tol,
                    None if d.T is None else d.T.to(f64))


def _rescue(d: _Data, spec: _Spec, sol: MPCQPSolution) -> MPCQPSolution:
    """Re-solve in float64 the float32 lanes that stopped unconverged (the
    stall rule, a breakdown or the iteration cap), warm from their float32
    iterates, with the same cap and tolerance.  The lanes that start
    leaves unconverged are solved once more from the cold start, with one
    step length for primal and dual variables (`_Spec.one_step`): with
    two, the cold start stalls where the float32 one did (the primal
    steps of u and s enter the dual residual, and on rare QPs the
    iterates swing until the stall rule stops them).  A
    lane takes the first re-solve that converges, and its `iterations` is
    its float32 count plus its re-solves'; a lane neither converges keeps
    its float32 answer, and with it the caller's fallback.  One readback
    a call finds none."""
    need = ~sol.converged
    if not bool(need.any()):
        return sol
    idx = need.nonzero()[:, 0]
    capped = int((sol.iterations[idx] >= spec.max_iters).sum())
    with annotate("ipm.rescue"):
        was = timing.record(False)
        try:
            d64, spec64 = _lanes64(d, spec, idx)
            warm = tuple(t[idx].to(torch.float64)
                         for t in (sol.u, sol.s, *sol.mults))
            r = _ipm_eager(d64, spec64, warm)
            iters = sol.iterations[idx] + r.iterations
            cold = (~r.converged).nonzero()[:, 0]
            if cold.numel():
                d_c, spec_c = _lanes64(d, spec, idx[cold])
                c = _ipm_eager(d_c, spec_c._replace(one_step=True), None)
                r = MPCQPSolution(
                    *(t.index_copy(0, cold, ct) for t, ct in
                      zip(r[:-1], c[:-1])),
                    tuple(t.index_copy(0, cold, ct)
                          for t, ct in zip(r.mults, c.mults)))
                iters = iters.index_add(0, cold, c.iterations)
        finally:
            timing.record(was)
    timing.count("ipm.rescued", int(idx.numel()))
    timing.count("ipm.rescued_capped", capped)
    timing.count("ipm.rescued_cold", int(cold.numel()))
    timing.count("ipm.rescued_converged", int(r.converged.sum()))
    ok = r.converged
    if not bool(ok.any()):
        return sol
    idx, iters = idx[ok], iters[ok]

    def put(old, new):
        return old.index_copy(0, idx, new[ok].to(old.dtype))

    fields = {f: put(getattr(sol, f), getattr(r, f))
              for f in ("u", "s", "obj", "gap", "prim_res", "dual_res",
                        "converged", "merit")}
    fields["iterations"] = sol.iterations.index_copy(0, idx, iters)
    return MPCQPSolution(**fields, mults=tuple(
        put(old, new) for old, new in zip(sol.mults, r.mults)))


def solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, p_ss, q_s,
                 max_iters: int = 60, tol: float | None = None,
                 warm=None, box_theta=None) -> MPCQPSolution:
    """Solve a batch of the slack-structured QPs above.

    Shapes: q_u [B, n], h1 [B, m1], A [B, m2, n], b [B, m2];
    P_uu [n, n] and G_u [m1, n] shared by the batch, or [B, n, n] and
    [B, m1, n]; p_ss, q_s scalars or broadcastable to [B, m2].

    `box_theta` (optional, shared [hp, n]): G_u has the layout
    [I; -I; T; -T] with T = box_theta; every per-iteration product with
    G_u then uses the structure.  G_u must still be given (the polish
    and the reported residuals use its dense rows).

    `warm` (optional): a `(u, s, l1, l2, l3)` tuple, [B, ...] each,
    typically the iterates (`sol.u`, `sol.s`, `*sol.mults`) of a related
    solve (same shapes, nearby data), used as the interior-point start
    after the interiority shifts: slacks and multipliers floored at
    1e-2, multipliers clipped to [1e-6, 1e6].  Termination, best-iterate
    tracking and the polish are the same, so a bad start costs
    iterations, never accuracy.

    Each pass factors S once and solves two single right-hand sides
    (predictor, corrector), at the process's float32 matmul precision
    (the pipeline pins it to "highest").

    The IPM's answer goes through the active-set Newton polish
    (`_polish`), which takes a float32 iterate from the IPM's merit floor
    (~1e-4 relative) to linear-solve accuracy (~1e-6).

    On a CUDA tensor the loop's passes and the work after it replay from
    CUDA graphs (`_ipm_graphs`), each pass on the fused kernels where
    `use_fused_pass` takes the solve; on the CPU they run op by op.  Either
    way a float32 lane that stops unconverged is solved again in float64
    (`_rescue`).  `max_iters` caps each attempt, not the call: a lane a
    re-solve converges reports its float32 count plus the re-solves'
    (warm, then cold where the warm one did not converge), at most
    3 x max_iters; any other lane reports its float32 count.
    """
    timing.count("ipm.lanes", q_u.shape[0])
    d, spec = _prepare(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, max_iters, tol,
                       box_theta)
    if q_u.is_cuda and q_u.shape[0]:
        sol = _ipm_graphs(d, spec, warm)
    else:
        sol = _ipm_eager(d, spec, warm)
    if q_u.dtype == torch.float64:
        return sol
    return _rescue(d, spec, sol)


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
    matter.  `POLISH_REFINEMENTS` (2) KKT refinement passes follow.
    The caller keeps the polished iterate only where its merit is lower.
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
    idx = _select_rows(score, k_sel)                       # [B, k_sel]
    va = torch.gather(act.to(dtype), 1, idx)
    Eg = torch.gather(E, 1, idx[:, :, None].expand(Bsz, k_sel, n))
    eg = torch.gather(e, 1, idx)

    LK = _factor(K)
    KiEq = _solve(
        LK, torch.cat([Eg.transpose(1, 2), q_t[:, :, None]], dim=2))
    KiEg, Kiq = KiEq[:, :, :k_sel], KiEq[:, :, k_sel]
    Mg = (va[:, :, None] * (Eg @ KiEg) * va[:, None, :]
          + torch.diag_embed(1.0 - va)
          + reg * torch.eye(k_sel, dtype=dtype, device=device))
    rhs = va * (-_mv(Eg, Kiq) - eg)
    LM = _factor(Mg)
    nug = va * _solve(LM, rhs)
    u_p = -(Kiq + _mv(KiEg, nug))

    # KKT iterative refinement of u and nu against
    #     K u + q_t + E_a' nu_a = 0,   E_a u = e_a.
    Eg_h, eg_h, va_h = (t.to(acc) for t in (Eg, eg, va))
    u_h, nu_h = u_p.to(acc), nug.to(acc)
    for _ in range(POLISH_REFINEMENTS):
        r1 = (_mv(K_h, u_h) + q_h + _rmv(Eg_h, nu_h)).to(dtype)
        r2 = (va_h * (_mv(Eg_h, u_h) - eg_h)).to(dtype)
        t = _solve(LK, r1)
        dnu = va * _solve(LM, r2 - va * _mv(Eg, t))
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
