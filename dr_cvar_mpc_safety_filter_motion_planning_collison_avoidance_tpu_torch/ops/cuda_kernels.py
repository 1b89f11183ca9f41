"""The safe halfspaces of B rows of N samples: CUDA kernels + plain forms.

Port of the JAX package's ops/pallas_kernels.py: `_all_metrics_kernel`
(entered through `fused_metric_halfspaces_planes`) becomes
`all_metrics_halfspaces`, `_drcvar_kernel` (the public
`fused_drcvar_halfspace`) keeps its name.  The kernel source is
`csrc/halfspace_kernels.cu`; its header says what bounds the kernels on
an H100 (bytes; latency held an earlier block-a-row design at a quarter
of that) and what the design does about it, on three paths by the row's
length N: one warp a row with the samples in registers for N <= 1024
(WARP_MAX_N); one block a row with its projections in shared memory up
to 49,152 (BLOCK_MAX_N); and up to 393,216 (MAX_N_SAMPLES) one
thread-block cluster of c = ceil(N / 49,152) blocks a row, each holding
a slice, the row's sums and the select's histograms added over the
cluster through distributed shared memory.  Longer rows have no kernel.

Each wrapper dispatches on the samples' device: on the CPU it runs the
plain PyTorch form (the composed closed forms of ops/halfspace.py, any
float dtype); on a CUDA tensor it launches the kernel (float32 only) or
raises.  No fallback on the card.  Which kernel a (B, N, alignment)
takes, with how many values a lane, rows a block, blocks a row and bytes
of shared memory, is decided by `halfspace_plan`, a pure function; the C
entry points check the plan against what the kernels take.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.risk import cvar_k, kth_largest as _kth_largest_plain
from ..utils import timing
from . import _build
from .halfspace import (Halfspace, cvar_halfspace, dr_cvar_halfspace,
                        mean_halfspace)

# The block path keeps one float32 of shared memory per sample (the row's
# projections); the block's own bookkeeping takes ~1 KB of the 227 KB an
# H100 block may use.
BLOCK_MAX_N = 49152
# The cluster path spreads a longer row over the blocks of one
# thread-block cluster, each holding a slice of at most BLOCK_MAX_N
# projections (and ~2.3 KB of bookkeeping); 8 blocks is the portable
# cluster size, so the kernels take rows of up to 8 x 49,152 samples.
MAX_CLUSTER_BLOCKS = 8
MAX_N_SAMPLES = MAX_CLUSTER_BLOCKS * BLOCK_MAX_N
# The warp path: a lane holds 2 ... 32 values in registers, so a warp
# takes rows of up to 1024; four warps (rows) a block, each with 256
# int32 histogram counters of shared memory.
WARP_MAX_N = 1024
WARP_VALUES_PER_LANE = (2, 4, 8, 16, 32)
WARP_ROWS_PER_BLOCK = 4
BLOCK_THREADS = 256


class HalfspacePlan(NamedTuple):
    """How the halfspace kernels (and the select alone) run B rows of N."""

    entry: str             # "warp": a warp a row; "block": a block a
                           # row; "cluster": a cluster of blocks a row
    values_per_lane: int   # registers of samples a lane; 0 on the others
    rows_per_block: int
    threads: int           # threads a block
    smem_bytes: int        # dynamic shared memory a block
    load_bytes: int        # width of a sample load: 16 (two samples) or 8
    cluster: int = 1       # blocks a row: 2 ... 8 on the cluster path

    @property
    def slice(self) -> int:
        """Samples a block holds in shared memory (the last block of a
        cluster may hold fewer); 0 on the warp path."""
        return 0 if self.entry == "warp" else self.smem_bytes // 4


def halfspace_plan(B: int, N: int, aligned16: bool) -> HalfspacePlan:
    """The launch of B rows of N samples; `aligned16` says whether the
    samples start on a 16-byte boundary.

    Rows of at most 1024 samples go to the warp path with the fewest
    values a lane that hold them; 16-byte loads need every row's base
    aligned, that is an aligned start and an even N, else the loads are
    8 bytes (one sample).  Rows of up to BLOCK_MAX_N go to the block
    path, longer ones to the cluster path: c = ceil(N / BLOCK_MAX_N)
    blocks a row, each holding ceil(N / c) samples.
    """
    if B < 0:
        raise ValueError(f"halfspace_plan: B >= 0, got {B}")
    if not 1 <= N <= MAX_N_SAMPLES:
        raise ValueError(f"halfspace_plan: 1 <= N <= {MAX_N_SAMPLES} samples "
                         f"per row, got {N}")
    if N > BLOCK_MAX_N:
        blocks = -(-N // BLOCK_MAX_N)
        return HalfspacePlan("cluster", 0, 1, BLOCK_THREADS,
                             4 * -(-N // blocks), 8, blocks)
    if N > WARP_MAX_N:
        return HalfspacePlan("block", 0, 1, BLOCK_THREADS, 4 * N, 8)
    values = next(v for v in WARP_VALUES_PER_LANE if 32 * v >= N)
    rows = WARP_ROWS_PER_BLOCK
    return HalfspacePlan("warp", values, rows, 32 * rows,
                         rows * 256 * 4,
                         16 if aligned16 and N % 2 == 0 else 8)


def float_keys(x):
    """The kernels' monotone float32 -> uint32 key map, as int64 in
    [0, 2^32): torch has no uint32 compare, shift or max on the CPU."""
    u = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def key_floats(keys):
    """The inverse of `float_keys`: float32 from int64 keys."""
    u = torch.where(keys >= 0x80000000, keys ^ 0x80000000, keys ^ 0xFFFFFFFF)
    u = torch.where(u >= 0x80000000, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def radix_select_plain(x, k: int):
    """The warp path's select, replayed with torch ops: the exact k-th
    largest along the last axis of x [B, N] and, per row, the passes it
    took.

    An 8-bit radix select on the keys from the top digit down; each pass
    histograms the digit of the keys that still match the digits chosen
    so far and walks the bins from the largest down to the one that
    holds the k-th largest.  A row leaves as soon as its chosen bin
    holds one key; keys tied with the k-th take all four passes, after
    which the chosen digits are the key.
    """
    keys = float_keys(x)
    B = keys.shape[0]
    active = torch.ones_like(keys, dtype=torch.bool)
    krem = torch.full((B,), k, dtype=torch.int64, device=keys.device)
    prefix = torch.zeros_like(krem)
    result = torch.zeros_like(krem)
    done = torch.zeros_like(krem, dtype=torch.bool)
    passes = torch.zeros_like(krem)
    for shift in (24, 16, 8, 0):
        digit = (keys >> shift) & 0xFF
        hist = torch.zeros((B, 256), dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, digit, active.to(torch.int64))
        down = hist.flip(1)                      # bin 255 first
        incl = down.cumsum(1)
        at = (incl >= krem[:, None]).to(torch.int64).argmax(1, keepdim=True)
        count = down.gather(1, at)[:, 0]
        chosen = 255 - at[:, 0]
        live = ~done
        krem = torch.where(live, krem - (incl.gather(1, at)[:, 0] - count),
                           krem)
        prefix = torch.where(live, prefix | (chosen << shift), prefix)
        active = active & (digit == chosen[:, None])
        passes = passes + live.to(torch.int64)
        last = torch.where(active, keys, torch.zeros_like(keys)).amax(1)
        leaves = live & (count == 1)
        result = torch.where(leaves, last, result)
        done = done | leaves
    return key_floats(torch.where(done, result, prefix)), passes


class MetricHalfspaces(NamedTuple):
    """Per-row halfspaces of the three metrics (cvar and dr_cvar share h)."""

    h_mean: torch.Tensor    # [B, 2]
    g_mean: torch.Tensor    # [B]
    h: torch.Tensor         # [B, 2]
    g_cvar: torch.Tensor    # [B]
    g_drcvar: torch.Tensor  # [B]


def all_metrics_halfspaces_plain(samples, ego, alpha, delta, epsilon,
                                 robot_radius, obstacle_radius
                                 ) -> MetricHalfspaces:
    """The composed closed forms; the k-th value from `torch.kthvalue`."""
    m = mean_halfspace(samples, robot_radius, obstacle_radius)
    c = cvar_halfspace(samples, ego, alpha, delta, robot_radius,
                       obstacle_radius)
    d = dr_cvar_halfspace(samples, ego, alpha, delta, epsilon, robot_radius,
                          obstacle_radius)
    return MetricHalfspaces(m.h, m.g_tilde, c.h, c.g_tilde, d.g_tilde)


def _check_f32_cuda(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got "
                         f"device {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_rows(what: str, samples, ego) -> tuple[int, int]:
    """Validate [B, N, 2] float32 samples and [B, 2] ego on one CUDA
    device; returns (B, N)."""
    if samples.dim() != 3 or samples.shape[-1] != 2:
        raise ValueError(f"samples: expected [B, N, 2], got "
                         f"{tuple(samples.shape)}")
    B, N, _ = samples.shape
    if not 1 <= N <= MAX_N_SAMPLES:
        raise ValueError(f"{what}: 1 <= N <= {MAX_N_SAMPLES} samples per "
                         f"row, got {N}")
    _check_f32_cuda("samples", samples, (B, N, 2))
    _check_f32_cuda("ego", ego, (B, 2))
    if ego.device != samples.device:
        raise ValueError("samples and ego must be on the same device")
    return B, N


def _plan_rows(what: str, samples, ego) -> tuple[HalfspacePlan, int]:
    """Validate the rows and plan their launch: (plan, N)."""
    B, N = _check_rows(what, samples, ego)
    return halfspace_plan(B, N, samples.data_ptr() % 16 == 0), N


def all_metrics_halfspaces(samples, ego, alpha: float, delta: float,
                           epsilon: float, robot_radius: float,
                           obstacle_radius: float) -> MetricHalfspaces:
    """Mean, CVaR and DR-CVaR halfspaces of B rows of N samples.

    samples: [B, N, 2]; ego: [B, 2] ego reference positions.
    Returns MetricHalfspaces (see ops/halfspace.py for the offset
    conventions; h_mean is taken from the origin).  On a CUDA tensor the
    five outputs are views of one buffer.

    With the recorder on, the rows are counted under the path that takes
    them: `halfspace.rows_warp` / `halfspace.rows_block` /
    `halfspace.rows_cluster` (the plan's entry) on a CUDA tensor,
    `halfspace.rows_plain` on the CPU.
    """
    if samples.device.type == "cpu":
        timing.count("halfspace.rows_plain", samples.shape[0])
        return all_metrics_halfspaces_plain(samples, ego, alpha, delta,
                                            epsilon, robot_radius,
                                            obstacle_radius)
    plan, N = _plan_rows("all_metrics_halfspaces", samples, ego)
    B = samples.shape[0]
    timing.count("halfspace.rows_" + plan.entry, B)
    # One allocation, the float2 outputs first (8-byte aligned for any B).
    buf = torch.empty((7 * B,), dtype=torch.float32, device=samples.device)
    out = MetricHalfspaces(buf[:2 * B].view(B, 2), buf[4 * B:5 * B],
                           buf[2 * B:4 * B].view(B, 2), buf[5 * B:6 * B],
                           buf[6 * B:])
    if B == 0:
        return out
    _build.launch("drcvar_all_metrics_halfspaces", samples.device,
                  samples.data_ptr(), ego.data_ptr(),
                  *(t.data_ptr() for t in out), B, N, cvar_k(N, alpha),
                  plan.values_per_lane, plan.rows_per_block, plan.load_bytes,
                  plan.cluster, 1.0 / N, alpha * N,
                  robot_radius + obstacle_radius, delta, epsilon / alpha)
    all_metrics_halfspaces.launches += 1
    return out


all_metrics_halfspaces.launches = 0


# The plain version: the composed DR-CVaR closed form (ops/halfspace.py).
fused_drcvar_halfspace_plain = dr_cvar_halfspace


def fused_drcvar_halfspace(samples, ego, alpha: float, delta: float,
                           epsilon: float, robot_radius: float,
                           obstacle_radius: float) -> Halfspace:
    """DR-CVaR halfspaces of B rows of N samples: (h [B, 2], g_tilde [B]).

    samples: [B, N, 2]; ego: [B, 2] ego reference positions.  The
    offset is g* - r~ = CVaR - delta + epsilon/alpha (h is unit, so the
    radii cancel).  On a CUDA tensor the kernel is the all-metrics
    kernel with the other metrics compiled out: its (h, g_tilde) equal
    `all_metrics_halfspaces`'s (h, g_drcvar) bit for bit.
    """
    if samples.device.type == "cpu":
        return fused_drcvar_halfspace_plain(samples, ego, alpha, delta,
                                            epsilon, robot_radius,
                                            obstacle_radius)
    plan, N = _plan_rows("fused_drcvar_halfspace", samples, ego)
    B = samples.shape[0]
    buf = torch.empty((3 * B,), dtype=torch.float32, device=samples.device)
    out = Halfspace(buf[:2 * B].view(B, 2), buf[2 * B:])
    if B == 0:
        return out
    _build.launch("drcvar_fused_halfspace", samples.device,
                  samples.data_ptr(), ego.data_ptr(), out.h.data_ptr(),
                  out.g_tilde.data_ptr(), B, N, cvar_k(N, alpha),
                  plan.values_per_lane, plan.rows_per_block, plan.load_bytes,
                  plan.cluster, 1.0 / N, alpha * N, delta, epsilon / alpha)
    fused_drcvar_halfspace.launches += 1
    return out


fused_drcvar_halfspace.launches = 0


def kth_largest(x, k: int):
    """Exact k-th largest along the last axis of x [B, N].

    On a CUDA tensor this runs the select of the halfspace kernels on
    its own, on the path `halfspace_plan` gives N, so the select can be
    held bit for bit against `torch.kthvalue` on identical inputs.
    """
    if x.device.type == "cpu":
        return _kth_largest_plain(x, k)
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, N], got {tuple(x.shape)}")
    B, N = x.shape
    if not 1 <= N <= MAX_N_SAMPLES or not 1 <= k <= N:
        raise ValueError(f"kth_largest: need 1 <= k <= N <= "
                         f"{MAX_N_SAMPLES}, got k={k}, N={N}")
    _check_f32_cuda("x", x, (B, N))
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    plan = halfspace_plan(B, N, False)
    _build.launch("drcvar_kth_largest", x.device, x.data_ptr(),
                  out.data_ptr(), B, N, k, plan.values_per_lane,
                  plan.rows_per_block, plan.cluster)
    kth_largest.launches += 1
    return out


kth_largest.launches = 0
