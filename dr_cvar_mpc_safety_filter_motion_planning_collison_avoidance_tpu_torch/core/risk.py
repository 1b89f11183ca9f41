"""Exact empirical CVaR (Rockafellar-Uryasev form).

Port of `cvar_rockafellar` / `cvar_from_kth` of the JAX package's
core/risk.py.  The k-th largest value comes from `torch.kthvalue`: the
JAX package's bit-bisection select exists only because XLA's SPMD
partitioner all-gathers TopK, which does not apply here.
"""

from __future__ import annotations

import math

import torch


def cvar_k(n: int, alpha: float) -> int:
    """Order-statistic index k = clamp(ceil(alpha N), 1, N)."""
    return max(min(int(math.ceil(alpha * n - 1e-12)), n), 1)


def kth_largest(x, k: int):
    """Exact k-th largest element along the last axis."""
    return torch.kthvalue(x, x.shape[-1] - k + 1, dim=-1).values


def cvar_rockafellar(x, alpha: float):
    """Exact empirical CVaR_alpha along the last axis.

    CVaR_alpha(x) = min_tau tau + 1/(alpha*N) sum_i (x_i - tau)_+
                  = (sum_{x_i > v} x_i + (alpha*N - #{x_i > v}) v)/(alpha*N)

    with v the k-th largest sample, k = ceil(alpha * N).
    """
    v = kth_largest(x, cvar_k(x.shape[-1], alpha))
    return cvar_from_kth(x, v, alpha)


def cvar_from_kth(x, kth_value, alpha: float):
    """CVaR from a known k-th largest value (tie-safe masked form).

    With v = x_[k] and c = #{x_i > v}:
        CVaR = (sum_{x_i > v} x_i + (alpha*N - c) * v) / (alpha*N)
    """
    an = alpha * x.shape[-1]
    gt = x > kth_value[..., None]
    c = gt.sum(-1).to(x.dtype)
    tail_sum = torch.where(gt, x, torch.zeros_like(x)).sum(-1)
    return (tail_sum + (an - c) * kth_value) / an
