"""Safety evaluation metrics.

Port of the JAX package's evaluation/metrics.py.  Where torch's defaults
differ from jnp's: `jnp.std` is the population std (`correction=0`
here), `jnp.percentile` interpolates linearly (`torch.quantile`'s
"linear"), and the mean of booleans needs a float cast.
"""

from __future__ import annotations

import torch


def collision_rate(distances, axis=None):
    """Fraction of runs with distance < 0, in float32 whatever the
    distances' dtype (as `jnp.mean` of booleans)."""
    hit = (distances < 0).to(torch.float32)
    return hit.mean() if axis is None else hit.mean(axis)


def expectation_of_shortfall(distances, threshold: float = 0.0, axis=-1):
    """Mean shortfall below threshold; 0 when no shortfalls."""
    mask = distances < threshold
    count = mask.sum(axis)
    total = torch.where(mask, distances - threshold,
                        torch.zeros_like(distances)).sum(axis)
    return torch.where(count == 0, torch.zeros_like(total),
                       total / count.clamp(min=1))


def safety_metrics(distances, threshold: float = 0.0):
    """Summary-statistic dict of a 1-D (or flattened) distance array."""
    d = torch.as_tensor(distances).flatten()

    def q(p):
        return torch.quantile(d, p / 100.0, interpolation="linear")

    return {
        "mean": d.mean(),
        "min": d.min(),
        "max": d.max(),
        "std": d.std(correction=0),
        "collision_rate": collision_rate(d),
        "expected_shortfall": expectation_of_shortfall(d, threshold),
        "q10": q(10),
        "q25": q(25),
        "median": q(50),
        "q75": q(75),
        "q90": q(90),
    }
