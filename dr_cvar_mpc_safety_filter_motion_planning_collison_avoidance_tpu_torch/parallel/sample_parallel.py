"""Sample-parallel DR-CVaR: the N-sample axis split over a mesh row.

Port of the JAX package's parallel/sample_parallel.py, with `psum` /
`pmax` / `pmin` over a `shard_map` axis become `all_reduce` over the
mesh's samples group.  The CVaR tail needs the k-th largest projection,
an order statistic; it comes from the JAX module's moment-seeded 3-ary
early-exit bisection, in which every round needs only COUNTS of the
samples above two pivots, and counts add up across ranks.  Per solve:

  * ONE MAX carries both extremes of the key span (the complement trick
    turns the minimum into a maximum: FULL - min), so the bounds are
    exact and correctness never rests on the seeding;
  * ONE SUM carries the two moments; the seeded first round puts its
    pivots at mu + (z -+ margin) sigma, z = Phi^-1(1 - k/N);
  * each round makes ONE SUM of both pivot counts, stacked, and cuts the
    interval in three;
  * the loop exits once every row has count(keys >= lo) == k or a
    collapsed interval; the counts are the same on every rank of the
    row, so all of them leave on the same round;
  * a final MIN gives the exact k-th value, and ONE SUM of |G| and sum_G
    (G = the samples with key >= lo) the tie-safe tail
    (sum_G + (an - |G|) v) / an.

So a solve makes rounds + 4 collectives (rounds counts the seeded
first), plus one gather when the batch is split over data.  Keys are the
float32 values' monotone uint32 keys, held in int64 (PyTorch's uint32
support has gaps); the values and the tail are float32, as in JAX.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import torch

from ..ops.halfspace import _project
from .mesh import Mesh, all_reduce, gather_batch, shard_batch

FULL = 0xFFFFFFFF


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> monotone uint32 key, in int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & FULL
    return torch.where(u >> 31 == 1, u ^ FULL, u ^ 0x80000000)


def key_floats(k: torch.Tensor) -> torch.Tensor:
    """Inverse of `float_keys`."""
    u = torch.where(k >> 31 == 1, k ^ 0x80000000, k ^ FULL)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _row_done(lo, hi, c_lo, k):
    return (c_lo == k) | (lo >= hi)


def _step(lo, hi, c_lo, m1, m2, counts, k):
    """The interval after counting the keys >= m1 and >= m2 (m1 <= m2)."""
    c1, c2 = counts[..., 0], counts[..., 1]
    ok2, ok1 = c2 >= k, c1 >= k
    lo_n = torch.where(ok2, m2, torch.where(ok1, m1, lo))
    c_n = torch.where(ok2, c2, torch.where(ok1, c1, c_lo))
    hi_n = torch.where(ok2, hi, torch.where(ok1, m2 - 1, m1 - 1))
    frozen = _row_done(lo, hi, c_lo, k)
    return (torch.where(frozen, lo, lo_n), torch.where(frozen, hi, hi_n),
            torch.where(frozen, c_lo, c_n))


def _count_ge(keys, m1, m2, mesh, axis):
    counts = torch.stack([(keys >= m1[..., None]).sum(-1),
                          (keys >= m2[..., None]).sum(-1)], dim=-1)
    return all_reduce(counts, "sum", mesh, axis)


def distributed_kth_largest(x_local, k: int, n_global: int, mesh: Mesh,
                            axis: str = "samples", max_rounds: int = 22):
    """EXACT k-th largest over the global last axis, split over `axis`.

    x_local: [..., N_local].  Returns (v float32 [...], lo int64 key
    [...], rounds), rounds = bisection rounds taken, the seeded first
    included (one collective each).
    """
    xf = x_local.to(torch.float32)
    keys = float_keys(xf)
    ext = torch.stack([keys.amax(-1), FULL - keys.amin(-1)], dim=-1)
    all_reduce(ext, "max", mesh, axis)
    hi0, lo0 = ext[..., 0], FULL - ext[..., 1]
    c0 = torch.full_like(lo0, n_global)

    # Moment-seeded first round; the pivots are clamped into (lo0, hi0],
    # so any placement keeps the interval invariants.
    mom = torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=-1)
    all_reduce(mom, "sum", mesh, axis)
    mu = mom[..., 0] / n_global
    sigp = torch.sqrt(torch.clamp(mom[..., 1] / n_global - mu * mu, min=0.0))
    qz = min(max(1.0 - k / n_global, 1e-7), 1.0 - 1e-7)
    z = NormalDist().inv_cdf(qz)
    s1 = torch.minimum(torch.maximum(float_keys(mu + (z - 0.55) * sigp),
                                     lo0 + 1), hi0)
    s2 = torch.minimum(torch.maximum(float_keys(mu + (z + 0.65) * sigp), s1),
                       hi0)
    lo, hi, c_lo = _step(lo0, hi0, c0, s1, s2,
                         _count_ge(keys, s1, s2, mesh, axis), k)

    t = 1
    while t < max_rounds and not bool(_row_done(lo, hi, c_lo, k).all()):
        third = (hi - lo) // 3
        m1 = lo + third + 1                 # lo < m1 <= m2 <= hi
        m2 = lo + third * 2 + 1
        lo, hi, c_lo = _step(lo, hi, c_lo, m1, m2,
                             _count_ge(keys, m1, m2, mesh, axis), k)
        t += 1

    # The k-th largest is the least value whose key is >= lo.
    v = torch.where(keys >= lo[..., None], xf,
                    torch.full_like(xf, math.inf)).amin(-1)
    all_reduce(v, "min", mesh, axis)
    return v, lo, t


def distributed_cvar(x_local, alpha: float, n_global: int, mesh: Mesh,
                     axis: str = "samples"):
    """Exact CVaR_alpha along the global last axis; returns (cvar in
    x_local's dtype, rounds)."""
    an = alpha * n_global
    k = max(min(int(math.ceil(an - 1e-12)), n_global), 1)
    v, lo, t = distributed_kth_largest(x_local, k, n_global, mesh, axis)
    xf = x_local.to(torch.float32)
    ge = xf >= key_floats(lo)[..., None]
    cs = torch.stack([ge.sum(-1).to(torch.float32),
                      torch.where(ge, xf, torch.zeros_like(xf)).sum(-1)],
                     dim=-1)
    all_reduce(cs, "sum", mesh, axis)
    c, s = cs[..., 0], cs[..., 1]
    return ((s + (an - c) * v) / an).to(x_local.dtype), t


def dr_cvar_g_sample_parallel(mesh: Mesh, samples, h, alpha, delta, epsilon,
                              robot_radius, obstacle_radius,
                              batch_over_data: bool = False,
                              return_rounds: bool = False):
    """DR-CVaR g* with the sample axis split over the mesh's samples axis.

    samples: [B, N, 2] and h: [B, 2], the same on every rank (the host
    value); N must divide by the samples axis.  With `batch_over_data`
    the batch is split over the data axis too (the JAX package's
    `batch_axis_spec=P("data", "samples", None)`), which on a host-aware
    mesh keeps the per-round reductions inside one host; otherwise every
    data index solves the whole batch.  Returns g* [B] on every rank
    (and the bisection rounds this rank's row took with
    `return_rounds`).  The math is ops/halfspace.dr_cvar_g_star's.
    """
    B, n_global = samples.shape[0], samples.shape[1]
    n_s = mesh.shape["samples"]
    if n_global % n_s:
        raise ValueError(f"N = {n_global} samples do not divide over "
                         f"samples = {n_s} ranks")
    if batch_over_data:
        samples, h = shard_batch(samples, mesh), shard_batch(h, mesh)
    n_local = n_global // n_s
    j = mesh.coordinate[1]
    s_local = _project(samples[:, j * n_local:(j + 1) * n_local], h)
    cvar, rounds = distributed_cvar(-s_local, alpha, n_global, mesh)
    r_tilde = ((robot_radius + obstacle_radius)
               * torch.linalg.vector_norm(h, dim=-1))
    g = cvar + r_tilde - delta + epsilon / alpha
    if batch_over_data:
        g = gather_batch(g, mesh, B)
    return (g, rounds) if return_rounds else g
