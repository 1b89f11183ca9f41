"""Attribution variants of the DR-CVaR halfspace kernel: CUDA kernels + plain forms.

Port of the Pallas kernels of the JAX package's kernel benchmark
(experiments/kbench.py): `fused` with its select swapped out
(`drcvar_variant`), the read floor `minimal_planes`, and the select's
round count `measure_prod_rounds` (`select_rounds`).  The kernel source
is `csrc/halfspace_variants.cu`; its header says what each variant
computes, what bounds it on an H100 and how it is designed: one thread
block per row, which is the production kernel's design only for rows of
more than 1024 samples.  The benchmark harness is `experiments/kbench.py`
of this package.

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
from .cuda_kernels import (_check_rows, float_keys,
                           fused_drcvar_halfspace)
from .halfspace import Halfspace, dr_cvar_halfspace

# The constants `kbench.fused` hard-codes: alpha, delta, epsilon, r~.
ALPHA, DELTA, EPSILON, R_COMBINED = 0.2, 0.1, 0.15, 0.6
VARIANTS = ("prod", "prod_nosel", "nosel", "r3", "fixed12", "fixed22",
            "minimal")
# variant -> (kernel code, bisection rounds); see halfspace_variants.cu.
_CODES = {"nosel": (0, 0), "prod_nosel": (1, 0), "r3": (2, 22),
          "fixed12": (3, 12), "fixed22": (3, 22), "minimal": (4, 0)}
_MINIMAL_PLANES = 5


def _select_bisect(x, k: int, alpha: float, rounds: int, early_exit: bool):
    """The TPU's `_select_r3` / `_select_fixed`: 3-ary bisection on the
    keys between the row's min and max key, then the strict-greater
    tail at v = min{x : key >= lo}."""
    n = x.shape[-1]
    keys = float_keys(x)
    lo, hi = keys.amin(-1), keys.amax(-1)
    c_lo = torch.full_like(lo, n)
    for _ in range(rounds):
        frozen = (c_lo == k) | (lo >= hi)
        if early_exit and bool(frozen.all()):
            break
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
    return (tail + (an - c) * v) / an


def _unit_normal(dx, dy):
    norm = torch.sqrt(dx * dx + dy * dy)
    degen = norm < 1e-10
    safe = torch.where(degen, torch.ones_like(norm), norm)
    return (torch.where(degen, torch.ones_like(dx), dx / safe),
            torch.where(degen, torch.zeros_like(dy), dy / safe))


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
    ex, ey = ego[:, 0], ego[:, 1]
    cx, cy = sx - ex[:, None], sy - ey[:, None]
    dx, dy = cx.sum(-1) * inv_n, cy.sum(-1) * inv_n
    hx, hy = _unit_normal(dx, dy)
    shift = hx * (ex + dx) + hy * (ey + dy)
    if variant == "prod_nosel":
        # `_centered_stats`: projections from the raw samples, sigma.
        xv = ((ex + dx)[:, None] - sx) * hx[:, None] \
            + ((ey + dy)[:, None] - sy) * hy[:, None]
        sigma = torch.sqrt((xv * xv).sum(-1) * inv_n)
        cvar = xv.sum(-1) / n + sigma - shift
    else:
        x = -((cx - dx[:, None]) * hx[:, None]
              + (cy - dy[:, None]) * hy[:, None])
        if variant == "nosel":
            cvar = x.sum(-1) / n - shift
        else:
            _, rounds = _CODES[variant]
            cvar = _select_bisect(x, cvar_k(n, ALPHA), ALPHA, rounds,
                                  early_exit=variant == "r3") - shift
    g_star = cvar + R_COMBINED - DELTA + EPSILON / ALPHA
    return Halfspace(torch.stack([hx, hy], -1), g_star - R_COMBINED)


def _launch_variant(what: str, samples, ego, code: int, rounds: int,
                    k: int) -> Halfspace:
    B, N = _check_rows(what, samples, ego)
    out = Halfspace(torch.empty((B, 2), dtype=torch.float32,
                                device=samples.device),
                    torch.empty((B,), dtype=torch.float32,
                                device=samples.device))
    if B == 0:
        return out
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_variant(
            samples.data_ptr(), ego.data_ptr(), out.h.data_ptr(),
            out.g_tilde.data_ptr(), B, N, k, code, rounds, 1.0 / N,
            ALPHA * N, DELTA, EPSILON / ALPHA, stream)
    _build.check(err, what)
    return out


def drcvar_variant(samples, ego, variant: str) -> Halfspace:
    """The DR-CVaR solve of B rows of N samples with its select swapped
    out, at kbench's constants: (h [B, 2], g [B]).

    variant: one of VARIANTS.  "prod" is the production kernel
    (`fused_drcvar_halfspace`, counted there); "minimal" returns
    h = (gx, gy) = the row means and g = gx + gy.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant: one of {VARIANTS}, got {variant!r}")
    if variant == "prod":
        return fused_drcvar_halfspace(samples, ego, ALPHA, DELTA, EPSILON,
                                      R_COMBINED / 2, R_COMBINED / 2)
    if samples.device.type == "cpu":
        return drcvar_variant_plain(samples, ego, variant)
    code, rounds = _CODES[variant]
    out = _launch_variant("drcvar_variant", samples, ego, code, rounds,
                          cvar_k(samples.shape[1], ALPHA))
    drcvar_variant.launches += 1
    return out


drcvar_variant.launches = 0


def minimal_planes_plain(samples, ego) -> Halfspace:
    """Two row means; g = gx + gy + the row's ego x."""
    inv_n = 1.0 / samples.shape[1]
    gx, gy = samples[..., 0].sum(-1) * inv_n, samples[..., 1].sum(-1) * inv_n
    return Halfspace(torch.stack([gx, gy], -1), gx + gy + ego[:, 0])


def minimal_planes(samples, ego) -> Halfspace:
    """The read floor: one read of each row, two sums.

    The TPU kernel adds the first ego x of its 8-row tile (a tiling
    artefact that keeps ego live); this one adds the row's own.
    """
    if samples.device.type == "cpu":
        return minimal_planes_plain(samples, ego)
    out = _launch_variant("minimal_planes", samples, ego, _MINIMAL_PLANES,
                          0, 1)
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


def select_rounds_plain(samples, ego, alpha: float):
    """Passes of the block-wide 4-pass radix select each row needs, from the
    kernel's projections rebuilt bit for bit (float32, every operation
    rounded on its own, the kernel's summation order)."""
    s = samples.to(torch.float32)
    e = ego.to(torch.float32)
    n = s.shape[1]
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=s.device)
    ex, ey = e[:, 0:1], e[:, 1:2]
    dx = _block_sum_order(s[..., 0] - ex) * inv_n
    dy = _block_sum_order(s[..., 1] - ey) * inv_n
    hx, hy = _unit_normal(dx, dy)
    mx, my = ex[:, 0] + dx, ey[:, 0] + dy
    x = ((mx[:, None] - s[..., 0]) * hx[:, None]
         + (my[:, None] - s[..., 1]) * hy[:, None])
    keys = float_keys(x)
    k = cvar_k(n, alpha)
    kth = torch.kthvalue(keys, n - k + 1, dim=-1).values
    counts = torch.stack([((keys >> sh) == (kth >> sh)[:, None]).sum(-1)
                          for sh in (24, 16, 8, 0)], -1)
    need = counts != counts[:, 3:]
    return (1 + need.sum(-1)).to(torch.int32)


def select_rounds(samples, ego, alpha: float):
    """Per row, the first pass p in {1, 2, 3, 4} of the block-wide radix
    select after which every key sharing the k-th key's top 8p bits is
    the k-th key: int32 [B].  (The TPU function counts the rounds of the
    TPU's own select, which differs by design.)"""
    if samples.device.type == "cpu":
        return select_rounds_plain(samples, ego, alpha)
    B, N = _check_rows("select_rounds", samples, ego)
    out = torch.empty((B,), dtype=torch.int32, device=samples.device)
    if B == 0:
        return out
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_select_rounds(
            samples.data_ptr(), ego.data_ptr(), out.data_ptr(), B, N,
            cvar_k(N, alpha), 1.0 / N, stream)
    _build.check(err, "select_rounds")
    select_rounds.launches += 1
    return out


select_rounds.launches = 0
