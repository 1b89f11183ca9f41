"""All three risk metrics' safe halfspaces in one pass: CUDA kernel + plain form.

Port of the JAX package's ops/pallas_kernels.py (`_all_metrics_kernel`,
entered through `fused_metric_halfspaces_planes`).  The kernel source
is `csrc/halfspace_kernels.cu`; its header says what bounds it on an
H100 and how it is designed.

`all_metrics_halfspaces` dispatches on the samples' device: on the CPU
it runs the plain PyTorch form (the composed closed forms of
ops/halfspace.py, any float dtype); on a CUDA tensor it launches the
kernel (float32 only) or raises.  No fallback on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.risk import cvar_k, kth_largest as _kth_largest_plain
from . import _build
from .halfspace import (Halfspace, cvar_halfspace, dr_cvar_halfspace,
                        mean_halfspace)

# One float32 of shared memory per sample (the row's projections); the
# block's own bookkeeping takes ~1 KB of the 227 KB an H100 block may use.
MAX_N_SAMPLES = 49152


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


def all_metrics_halfspaces(samples, ego, alpha: float, delta: float,
                           epsilon: float, robot_radius: float,
                           obstacle_radius: float) -> MetricHalfspaces:
    """Mean, CVaR and DR-CVaR halfspaces of B rows of N samples.

    samples: [B, N, 2]; ego: [B, 2] ego reference positions.
    Returns MetricHalfspaces (see ops/halfspace.py for the offset
    conventions; h_mean is taken from the origin).
    """
    if samples.device.type == "cpu":
        return all_metrics_halfspaces_plain(samples, ego, alpha, delta,
                                            epsilon, robot_radius,
                                            obstacle_radius)
    B, N = _check_rows("all_metrics_halfspaces", samples, ego)
    out = MetricHalfspaces(*(torch.empty(shape, dtype=torch.float32,
                                         device=samples.device)
                             for shape in ((B, 2), (B,), (B, 2), (B,), (B,))))
    if B == 0:
        return out
    lib = _build.load().lib
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.drcvar_all_metrics_halfspaces(
            samples.data_ptr(), ego.data_ptr(),
            *(t.data_ptr() for t in out),
            B, N, cvar_k(N, alpha), 1.0 / N, alpha * N,
            robot_radius + obstacle_radius, delta, epsilon / alpha, stream)
    _build.check(err, "all_metrics_halfspaces")
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
    B, N = _check_rows("fused_drcvar_halfspace", samples, ego)
    out = Halfspace(torch.empty((B, 2), dtype=torch.float32,
                                device=samples.device),
                    torch.empty((B,), dtype=torch.float32,
                                device=samples.device))
    if B == 0:
        return out
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_fused_halfspace(
            samples.data_ptr(), ego.data_ptr(), out.h.data_ptr(),
            out.g_tilde.data_ptr(), B, N, cvar_k(N, alpha), 1.0 / N,
            alpha * N, delta, epsilon / alpha, stream)
    _build.check(err, "fused_drcvar_halfspace")
    fused_drcvar_halfspace.launches += 1
    return out


fused_drcvar_halfspace.launches = 0


def kth_largest(x, k: int):
    """Exact k-th largest along the last axis of x [B, N].

    On a CUDA tensor this runs the select of the all-metrics kernel on
    its own (`kth_largest_kernel`), so the select can be held bit for
    bit against `torch.kthvalue` on identical inputs.
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_kth_largest(
            x.data_ptr(), out.data_ptr(), B, N, k, stream)
    _build.check(err, "kth_largest")
    kth_largest.launches += 1
    return out


kth_largest.launches = 0
