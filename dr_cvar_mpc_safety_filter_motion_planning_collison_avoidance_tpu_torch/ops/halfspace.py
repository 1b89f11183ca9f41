"""Safe-halfspace closed forms under mean / CVaR / DR-CVaR risk metrics.

Port of the JAX package's ops/halfspace.py (see its module docstring
for the derivation of the closed forms from the reference's convex
programs).  For samples s_i = h . xi_i and combined radius r~:

  * CVaR    : g* = CVaR_alpha(-s) + r~ - delta
  * DR-CVaR : g* = CVaR_alpha(-s) + r~ - delta + epsilon/alpha

Offset conventions (the reference's, quirks included):
  * mean    : g~ = -(h . mu - r * ||h||), h taken from the ORIGIN
  * cvar    : the offset is g* itself
  * dr_cvar : the offset is g* - r~

These are the plain (composed) form of the halfspace CUDA kernels
(ops/cuda_kernels.py) and the port's CPU / float64 path.
`dr_cvar_g_star` / `cvar_g_star` are the closed forms for a GIVEN normal
h, which the timing sweep (evaluation/timing_analysis.py) times.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry import compute_separating_vector, normalize_or_fallback
from ..core.risk import cvar_rockafellar


def _project(samples, h):
    """s_i = h . xi_i along the last axis of `samples` [..., N, 2]."""
    return (samples * h[..., None, :]).sum(-1)


def _centered_diff(samples, ego_ref_pos):
    """mean(samples) - ego computed as mean(samples - ego).

    Numerically load-bearing: near closest approach the difference is
    O(1e-3) while the positions are O(10).  Subtracting first keeps
    every summand O(sample spread), so the f32 rounding of the mean
    stays ~1e-8 instead of the ~5e-7 that the normalisation of h would
    amplify to ~1e-3.
    Returns (centered_samples [..., N, 2], diff [..., 2]).
    """
    centered = samples - ego_ref_pos[..., None, :]
    return centered, centered.mean(-2)


def _centered_cvar_neg_proj(centered, diff, h, ego_ref_pos, alpha):
    """CVaR_alpha(-h . xi) on doubly-centred projections.

    Exact shift identity CVaR(-h.xi) = CVaR(-h.(xi - c)) - h.c with
    c = ego + mean(xi - ego): the centred projections are O(sample
    spread), so the tail sums round at ~1e-8.
    """
    s_c = _project(centered - diff[..., None, :], h)
    shift = (h * (ego_ref_pos + diff)).sum(-1)
    return cvar_rockafellar(-s_c, alpha) - shift


class Halfspace(NamedTuple):
    """Safe halfspace {y : h . y + g_tilde <= 0}; leading batch axes."""

    h: torch.Tensor        # [..., 2] normal, ego -> obstacle
    g_tilde: torch.Tensor  # [...]    offset


def mean_halfspace(samples, robot_radius, obstacle_radius):
    """Mean-risk halfspace; the normal is taken from the ORIGIN toward
    the sample mean (the reference's quirk).

    samples: [..., N, 2] -> Halfspace with batch shape [...].
    """
    mean_pos = samples.mean(-2)
    h = compute_separating_vector(torch.zeros_like(mean_pos), mean_pos)
    r = robot_radius + obstacle_radius
    h_norm = torch.linalg.vector_norm(h, dim=-1)
    return Halfspace(h, -((h * mean_pos).sum(-1) - r * h_norm))


def _ego_halfspace(samples, ego_ref_pos, alpha, robot_radius,
                   obstacle_radius):
    ego = ego_ref_pos.expand(samples.shape[:-2] + samples.shape[-1:])
    centered, diff = _centered_diff(samples, ego)
    h = normalize_or_fallback(diff)
    r_tilde = ((robot_radius + obstacle_radius)
               * torch.linalg.vector_norm(h, dim=-1))
    return h, r_tilde, _centered_cvar_neg_proj(centered, diff, h, ego, alpha)


def cvar_halfspace(samples, ego_ref_pos, alpha, delta,
                   robot_radius, obstacle_radius):
    """CVaR-risk halfspace, closed form; the offset is g* itself.

    samples: [..., N, 2]; ego_ref_pos: [..., 2] (broadcastable).
    """
    h, r_tilde, cvar = _ego_halfspace(samples, ego_ref_pos, alpha,
                                      robot_radius, obstacle_radius)
    return Halfspace(h, cvar + r_tilde - delta)


def dr_cvar_halfspace(samples, ego_ref_pos, alpha, delta, epsilon,
                      robot_radius, obstacle_radius):
    """DR-CVaR (Wasserstein-robust) halfspace, closed form:
    g* = CVaR_alpha(-s) + r~ - delta + epsilon/alpha, offset g* - r~."""
    h, r_tilde, cvar = _ego_halfspace(samples, ego_ref_pos, alpha,
                                      robot_radius, obstacle_radius)
    g_star = cvar + r_tilde - delta + epsilon / alpha
    return Halfspace(h, g_star - r_tilde)


def _cvar_neg_proj_meancentered(samples, h, alpha):
    """CVaR_alpha(-h . xi) centred on the sample mean (exact shift
    identity; see `_centered_cvar_neg_proj` for why centring matters)."""
    c = samples.mean(-2)
    s_c = _project(samples - c[..., None, :], h)
    shift = (h * c).sum(-1)
    return cvar_rockafellar(-s_c, alpha) - shift


def dr_cvar_g_star(samples, h, alpha, delta, epsilon,
                   robot_radius, obstacle_radius):
    """Raw (g*, g_tilde) pair for a given normal h [..., 2]."""
    r_tilde = ((robot_radius + obstacle_radius)
               * torch.linalg.vector_norm(h, dim=-1))
    g_star = (_cvar_neg_proj_meancentered(samples, h, alpha)
              + r_tilde - delta + epsilon / alpha)
    return g_star, g_star - r_tilde


def cvar_g_star(samples, h, alpha, delta, robot_radius, obstacle_radius):
    """Raw g* for a given normal h [..., 2]."""
    r_tilde = ((robot_radius + obstacle_radius)
               * torch.linalg.vector_norm(h, dim=-1))
    return _cvar_neg_proj_meancentered(samples, h, alpha) + r_tilde - delta
