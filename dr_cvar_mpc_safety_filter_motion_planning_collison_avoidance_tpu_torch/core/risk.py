"""Empirical risk metrics: mean, VaR, CVaR.

Port of the JAX package's core/risk.py.  Two CVaR conventions, on
purpose: `var_metric` / `cvar_metric` are the reference's standalone
estimators with their index convention (sort ascending, element
ceil(N (1 - alpha)) - 1; the tail mean over samples >= VaR), and
`cvar_rockafellar` is the exact Rockafellar-Uryasev value the halfspace
solvers use.  The k-th largest value comes from `torch.kthvalue`: the
JAX package's bit-bisection select exists only because XLA's SPMD
partitioner all-gathers TopK, which does not apply here.
"""

from __future__ import annotations

import math

import torch


def expected_value(samples, axis: int = 0):
    """Sample mean along `axis`."""
    return samples.mean(dim=axis)


def var_metric(samples, alpha: float):
    """Empirical VaR along the last axis, the reference's convention:
    sorted ascending, the element at index ceil(N (1 - alpha)) - 1."""
    index = int(math.ceil(samples.shape[-1] * (1.0 - alpha)))
    return torch.sort(samples, dim=-1).values[..., index - 1]


def cvar_metric(samples, alpha: float):
    """Empirical CVaR as the mean of the samples >= VaR (the VaR itself
    when that tail is empty)."""
    var = var_metric(samples, alpha)
    mask = samples >= var[..., None]
    count = mask.sum(-1)
    tail_mean = (torch.where(mask, samples, torch.zeros_like(samples)).sum(-1)
                 / count.clamp(min=1))
    return torch.where(count == 0, var, tail_mean)


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
