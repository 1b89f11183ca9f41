"""Attribution variants of the DR-CVaR halfspace kernel: CUDA kernels + plain forms.

Port of the Pallas kernels of the JAX package's kernel benchmark
(experiments/kbench.py): `fused` with its select swapped out
(`drcvar_variant`), the read floor `minimal_planes`, and the select's
round count `measure_prod_rounds` (`select_rounds`).  The kernel source
is `csrc/halfspace_variants.cu`; its header says what each variant
computes, what bounds it on an H100 and how it is designed: each variant
is the production kernel with one stage swapped, on the path the
production kernel takes for the same rows (`halfspace_plan`: a warp a row
with the samples in registers for N <= 1024, built from the stages of
`csrc/halfspace_warp.cuh` that the production kernel instantiates; a
block a row above).  The benchmark harness is `experiments/kbench.py` of
this package.

Each wrapper dispatches on the samples' device: on the CPU it runs the
plain PyTorch form, which follows the JAX kernels' arithmetic (any float
dtype); on a CUDA tensor it launches its kernel (float32 only) or
raises.  No fallback on the card.  The uint32 key arithmetic runs in
int64 in the plain forms: torch has no uint32 compare, shift or max on
the CPU.
"""

from __future__ import annotations

import torch

from ..core.risk import cvar_k
from . import _build
from .cuda_kernels import (BLOCK_MAX_N, BLOCK_THREADS, HalfspacePlan,
                           _check_rows, _plan_rows, float_keys,
                           fused_drcvar_halfspace, halfspace_plan,
                           radix_select_plain)
from .halfspace import Halfspace, dr_cvar_halfspace

# The constants `kbench.fused` hard-codes: alpha, delta, epsilon, r~.
ALPHA, DELTA, EPSILON, R_COMBINED = 0.2, 0.1, 0.15, 0.6
VARIANTS = ("prod", "prod_nosel", "nosel", "r3", "fixed12", "fixed22",
            "minimal")
# variant -> (kernel code, bisection rounds); see halfspace_variants.cu.
_CODES = {"nosel": (0, 0), "prod_nosel": (1, 0), "r3": (2, 22),
          "fixed12": (3, 12), "fixed22": (3, 22), "minimal": (4, 0)}
_MINIMAL_PLANES = 5
# `minimal_planes` is a block a row at any N.
BLOCK_PLAN = HalfspacePlan("block", 0, 1, BLOCK_THREADS, 0, 8)


def _plan_variant_rows(what: str, samples, ego):
    """`_plan_rows` for the variants, which have the production kernel's
    warp and block paths but no cluster path: rows of at most
    BLOCK_MAX_N samples."""
    plan, N = _plan_rows(what, samples, ego)
    if plan.entry == "cluster":
        raise ValueError(f"{what}: 1 <= N <= {BLOCK_MAX_N} samples per row "
                         f"(the variants have no cluster path), got {N}")
    return plan, N


def _select_bisect(x, k: int, alpha: float, rounds: int, early_exit: bool):
    """The TPU's `_select_r3` / `_select_fixed`: 3-ary bisection on the
    keys between the row's min and max key, then the strict-greater
    tail at v = min{x : key >= lo}.  Returns the tail's CVaR and, per
    row, the rounds that moved the row's bounds (a frozen row's state
    stays as it is, so leaving when all rows are frozen, as here, and
    when one's own row is, as a warp of the kernel does, agree)."""
    n = x.shape[-1]
    keys = float_keys(x)
    lo, hi = keys.amin(-1), keys.amax(-1)
    c_lo = torch.full_like(lo, n)
    moved = torch.zeros_like(lo)
    for _ in range(rounds):
        frozen = (c_lo == k) | (lo >= hi)
        if early_exit and bool(frozen.all()):
            break
        moved = moved + (~frozen).to(moved.dtype)
        third = (hi - lo) // 3
        m1 = lo + third + 1
        m2 = lo + third * 2 + 1
        c1 = (keys >= m1[:, None]).sum(-1)
        c2 = (keys >= m2[:, None]).sum(-1)
        ok2, ok1 = c2 >= k, c1 >= k
        lo_n = torch.where(ok2, m2, torch.where(ok1, m1, lo))
        c_n = torch.where(ok2, c2, torch.where(ok1, c1, c_lo))
        hi_n = torch.where(ok2, hi, torch.where(ok1, m2 - 1, m1 - 1))
        lo = torch.where(frozen, lo, lo_n)
        hi = torch.where(frozen, hi, hi_n)
        c_lo = torch.where(frozen, c_lo, c_n)
    inf = torch.full_like(x, float("inf"))
    v = torch.where(keys >= lo[:, None], x, inf).amin(-1)
    an = alpha * n
    gt = x > v[:, None]
    c = gt.sum(-1).to(x.dtype)
    tail = torch.where(gt, x, torch.zeros_like(x)).sum(-1)
    return (tail + (an - c) * v) / an, moved


def _unit_normal(dx, dy):
    norm = torch.sqrt(dx * dx + dy * dy)
    degen = norm < 1e-10
    safe = torch.where(degen, torch.ones_like(norm), norm)
    return (torch.where(degen, torch.ones_like(dx), dx / safe),
            torch.where(degen, torch.zeros_like(dy), dy / safe))


def _centred_projections(samples, ego):
    """(hx, hy, shift, x) of `make_kernel`'s pre-select stages."""
    inv_n = 1.0 / samples.shape[1]
    ex, ey = ego[:, 0], ego[:, 1]
    cx = samples[..., 0] - ex[:, None]
    cy = samples[..., 1] - ey[:, None]
    dx, dy = cx.sum(-1) * inv_n, cy.sum(-1) * inv_n
    hx, hy = _unit_normal(dx, dy)
    shift = hx * (ex + dx) + hy * (ey + dy)
    x = -((cx - dx[:, None]) * hx[:, None] + (cy - dy[:, None]) * hy[:, None])
    return hx, hy, shift, x


def drcvar_variant_plain(samples, ego, variant: str) -> Halfspace:
    """The JAX kernels' arithmetic (kbench.py `make_kernel`,
    `prod_nosel`, `minimal`; `prod` is the DR-CVaR closed form)."""
    if variant == "prod":
        return dr_cvar_halfspace(samples, ego, ALPHA, DELTA, EPSILON,
                                 R_COMBINED / 2, R_COMBINED / 2)
    n = samples.shape[1]
    inv_n = 1.0 / n
    sx, sy = samples[..., 0], samples[..., 1]
    if variant == "minimal":
        gx, gy = sx.sum(-1) * inv_n, sy.sum(-1) * inv_n
        return Halfspace(torch.stack([gx, gy], -1), gx + gy)
    hx, hy, shift, x = _centred_projections(samples, ego)
    if variant == "prod_nosel":
        # `_centered_stats`: projections from the raw samples, sigma.
        ex, ey = ego[:, 0], ego[:, 1]
        dx = (sx - ex[:, None]).sum(-1) * inv_n
        dy = (sy - ey[:, None]).sum(-1) * inv_n
        xv = ((ex + dx)[:, None] - sx) * hx[:, None] \
            + ((ey + dy)[:, None] - sy) * hy[:, None]
        sigma = torch.sqrt((xv * xv).sum(-1) * inv_n)
        cvar = xv.sum(-1) / n + sigma - shift
    elif variant == "nosel":
        cvar = x.sum(-1) / n - shift
    else:
        _, rounds = _CODES[variant]
        cvar = _select_bisect(x, cvar_k(n, ALPHA), ALPHA, rounds,
                              early_exit=variant == "r3")[0] - shift
    g_star = cvar + R_COMBINED - DELTA + EPSILON / ALPHA
    return Halfspace(torch.stack([hx, hy], -1), g_star - R_COMBINED)


def bisect_rounds_plain(samples, ego):
    """Per row, the rounds `r3`'s bisection needs before the row is
    frozen (at most 22): what its early exit leaves of the work."""
    x = _centred_projections(samples, ego)[3]
    return _select_bisect(x, cvar_k(samples.shape[1], ALPHA), ALPHA,
                          _CODES["r3"][1], early_exit=True)[1]


def _launch_variant(samples, ego, code: int, rounds: int, k: int,
                    plan: HalfspacePlan) -> Halfspace:
    """Launch `drcvar_variant` on rows the caller has validated."""
    B, N = samples.shape[:2]
    out = Halfspace(torch.empty((B, 2), dtype=torch.float32,
                                device=samples.device),
                    torch.empty((B,), dtype=torch.float32,
                                device=samples.device))
    if B == 0:
        return out
    _build.launch("drcvar_variant", samples.device, samples.data_ptr(),
                  ego.data_ptr(), out.h.data_ptr(), out.g_tilde.data_ptr(),
                  B, N, k, code, rounds, plan.values_per_lane,
                  plan.rows_per_block, plan.load_bytes, 1.0 / N, ALPHA * N,
                  DELTA, EPSILON / ALPHA)
    return out


def drcvar_variant(samples, ego, variant: str) -> Halfspace:
    """The DR-CVaR solve of B rows of N samples with its select swapped
    out, at kbench's constants: (h [B, 2], g [B]).

    variant: one of VARIANTS.  "prod" is the production kernel
    (`fused_drcvar_halfspace`, counted there); "minimal" returns
    h = (gx, gy) = the row means and g = gx + gy.  On a CUDA tensor the
    rows take the path `halfspace_plan` gives the production kernel.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant: one of {VARIANTS}, got {variant!r}")
    if variant == "prod":
        return fused_drcvar_halfspace(samples, ego, ALPHA, DELTA, EPSILON,
                                      R_COMBINED / 2, R_COMBINED / 2)
    if samples.device.type == "cpu":
        return drcvar_variant_plain(samples, ego, variant)
    code, rounds = _CODES[variant]
    plan, N = _plan_variant_rows("drcvar_variant", samples, ego)
    out = _launch_variant(samples, ego, code, rounds, cvar_k(N, ALPHA), plan)
    drcvar_variant.launches += 1
    return out


drcvar_variant.launches = 0


def minimal_planes_plain(samples, ego) -> Halfspace:
    """Two row means; g = gx + gy + the row's ego x."""
    inv_n = 1.0 / samples.shape[1]
    gx, gy = samples[..., 0].sum(-1) * inv_n, samples[..., 1].sum(-1) * inv_n
    return Halfspace(torch.stack([gx, gy], -1), gx + gy + ego[:, 0])


def minimal_planes(samples, ego) -> Halfspace:
    """The read floor of a block a row (at any N): one read of each
    row, two sums.

    The TPU kernel adds the first ego x of its 8-row tile (a tiling
    artefact that keeps ego live); this one adds the row's own.
    """
    if samples.device.type == "cpu":
        return minimal_planes_plain(samples, ego)
    _check_rows("minimal_planes", samples, ego)
    out = _launch_variant(samples, ego, _MINIMAL_PLANES, 0, 1, BLOCK_PLAN)
    minimal_planes.launches += 1
    return out


minimal_planes.launches = 0


def _block_sum_order(v):
    """Row sums of v [B, N] in the kernel's order: 256 strided partial
    sums, a xor butterfly within each 32-lane warp, then the 8 warps in
    turn (`block_reduce` of halfspace_common.cuh)."""
    B, N = v.shape
    acc = torch.zeros((B, 256), dtype=v.dtype, device=v.device)
    for j in range(0, N, 256):
        part = v[:, j:j + 256]
        acc = acc + torch.nn.functional.pad(part, (0, 256 - part.shape[1]))
    w = acc.view(B, 8, 32)
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lanes ^ o]
    total = w[:, 0, 0]
    for warp in range(1, 8):
        total = total + w[:, warp, 0]
    return total


def _warp_sum_order(v, values_per_lane: int):
    """Row sums of v [B, N] in the warp path's order: register r of lane l
    holds sample 64 (r // 2) + 2 l + (r % 2); a lane adds its registers
    in order, skipping the slots past N, then the 32 lanes meet in a xor
    butterfly (`warp_row_stats`, `warp_sum` of halfspace_warp.cuh)."""
    B, N = v.shape
    lanes = torch.arange(32, device=v.device)
    acc = torch.zeros((B, 32), dtype=v.dtype, device=v.device)
    for r in range(values_per_lane):
        slot = 64 * (r // 2) + 2 * lanes + (r % 2)
        valid = slot < N
        term = v[:, slot.clamp(max=N - 1)]
        acc = torch.where(valid, acc + term, acc)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0]


def select_rounds_plain(samples, ego, alpha: float):
    """The plain version of `select_rounds`, from the kernel's projections
    rebuilt bit for bit (float32, every operation rounded on its own, the
    kernel's summation order on the path `halfspace_plan` gives N).

    N <= 1024: the passes of the warp path's select, replayed by
    `radix_select_plain` on the projections padded with -inf to the
    warp's 32 * values_per_lane slots.  N > 1024: the first pass after
    which the k-th key's bucket holds only the k-th key.
    """
    s = samples.to(torch.float32)
    e = ego.to(torch.float32)
    n = s.shape[1]
    plan = halfspace_plan(s.shape[0], n, True)
    warp = plan.entry == "warp"
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=s.device)
    ex, ey = e[:, 0:1], e[:, 1:2]
    if warp:
        dx = _warp_sum_order(s[..., 0] - ex, plan.values_per_lane) * inv_n
        dy = _warp_sum_order(s[..., 1] - ey, plan.values_per_lane) * inv_n
    else:
        dx = _block_sum_order(s[..., 0] - ex) * inv_n
        dy = _block_sum_order(s[..., 1] - ey) * inv_n
    hx, hy = _unit_normal(dx, dy)
    mx, my = ex[:, 0] + dx, ey[:, 0] + dy
    x = ((mx[:, None] - s[..., 0]) * hx[:, None]
         + (my[:, None] - s[..., 1]) * hy[:, None])
    k = cvar_k(n, alpha)
    if warp:
        padded = torch.nn.functional.pad(
            x, (0, 32 * plan.values_per_lane - n), value=float("-inf"))
        return radix_select_plain(padded, k)[1].to(torch.int32)
    keys = float_keys(x)
    kth = torch.kthvalue(keys, n - k + 1, dim=-1).values
    counts = torch.stack([((keys >> sh) == (kth >> sh)[:, None]).sum(-1)
                          for sh in (24, 16, 8, 0)], -1)
    need = counts != counts[:, 3:]
    return (1 + need.sum(-1)).to(torch.int32)


def select_rounds(samples, ego, alpha: float):
    """Per row, the trip count of the production select: int32 [B].

    N <= 1024 (a warp a row): the passes, 1 to 4, that the production
    select ran on the row's projections.  It leaves when the bin it chose
    holds one key; keys tied with the k-th run all four.  This is the
    count the TPU function reports of its own select (the two selects
    differ by design: an 8-bit radix select here, a moment-seeded
    bisection there).  N > 1024 (a block a row): the block select always
    runs four passes; the count is the first pass p after which every key
    sharing the k-th key's top 8p bits is the k-th key, the room an early
    exit would have.
    """
    if samples.device.type == "cpu":
        return select_rounds_plain(samples, ego, alpha)
    plan, N = _plan_variant_rows("select_rounds", samples, ego)
    B = samples.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=samples.device)
    if B == 0:
        return out
    _build.launch("drcvar_select_rounds", samples.device, samples.data_ptr(),
                  ego.data_ptr(), out.data_ptr(), B, N, cvar_k(N, alpha),
                  plan.values_per_lane, plan.rows_per_block, plan.load_bytes,
                  1.0 / N)
    select_rounds.launches += 1
    return out


select_rounds.launches = 0
