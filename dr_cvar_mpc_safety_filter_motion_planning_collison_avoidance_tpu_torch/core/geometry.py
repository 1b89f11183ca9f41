"""Geometric primitives for collision avoidance (batched over leading axes).

Port of the JAX package's core/geometry.py.
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def support_function_circle(direction, radius):
    """Support function of a circle: r * ||d||, 0 for ~zero directions."""
    norm = torch.linalg.vector_norm(direction, dim=-1)
    return torch.where(norm < _EPS, torch.zeros_like(norm), radius * norm)


def minkowski_difference_circle_circle(radius_a, radius_b):
    """Combined radius of two circles."""
    return radius_a + radius_b


def normalize_or_fallback(diff):
    """diff / ||diff|| along the last axis; [1, 0] where ||diff|| < 1e-10
    (the reference's degenerate fallback)."""
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    degen = norm < _EPS
    fallback = torch.zeros_like(diff)
    fallback[..., 0] = 1.0
    return torch.where(degen, fallback,
                       diff / torch.where(degen, torch.ones_like(norm), norm))


def compute_separating_vector(ego_pos, obstacle_pos):
    """Unit vector from ego toward obstacle; [1, 0] if nearly coincident."""
    return normalize_or_fallback(obstacle_pos - ego_pos)


def signed_distance(obstacle_pos, h, g_tilde):
    """Paper Eq. 3 signed distance: -(h . p + g_tilde)."""
    return -((h * obstacle_pos).sum(-1) + g_tilde)
