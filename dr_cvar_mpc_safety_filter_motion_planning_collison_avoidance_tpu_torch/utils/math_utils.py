"""Small math helpers, batched over leading axes.

Port of the JAX package's utils/math_utils.py.
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def normalize_vector(vector):
    """Unit-normalize along the last axis; ~zero vectors map to zero."""
    norm = torch.linalg.vector_norm(vector, dim=-1, keepdim=True)
    degen = norm < _EPS
    return torch.where(degen, torch.zeros_like(vector),
                       vector / torch.where(degen, torch.ones_like(norm),
                                            norm))


def is_point_in_halfspace(point, h, g):
    """h . p + g <= 0."""
    return (h * point).sum(-1) + g <= 0


def project_point_to_halfspace(point, h, g):
    """Euclidean projection onto {x : h.x + g <= 0}, with the reference's
    use of the UN-normalized offset g beside a normalized normal."""
    h_unit = normalize_vector(h)
    signed_dist = (h_unit * point).sum(-1) + g
    proj = point - h_unit * signed_dist[..., None]
    return torch.where((signed_dist <= 0)[..., None], point, proj)
