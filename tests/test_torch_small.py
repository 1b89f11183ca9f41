"""PyTorch port: the small functions of core/ and utils/math_utils.py,
each against its JAX counterpart on the same numpy inputs (float64, to
1e-12) and against the properties tests/test_risk.py and
tests/test_evaluation.py hold the JAX functions to.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu import (
    core as jcore, utils as jutils)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

tcore, tutils = pt.core, pt.utils


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _same(ours, theirs, tol=1e-12):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=tol)


def _ref_var(samples, alpha):
    s = np.sort(samples)
    return s[int(math.ceil(len(samples) * (1 - alpha))) - 1]


@pytest.mark.parametrize("alpha", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("n", [7, 20, 101])
def test_var_metric(alpha, n):
    x = np.random.default_rng(0).normal(size=n)
    assert float(tcore.var_metric(_t(x), alpha)) == _ref_var(x, alpha)
    _same(tcore.var_metric(_t(x), alpha),
          jcore.var_metric(jnp.asarray(x), alpha), 0)
    batch = np.random.default_rng(n).normal(size=(3, 4, n))
    _same(tcore.var_metric(_t(batch), alpha),
          jcore.var_metric(jnp.asarray(batch), alpha), 0)


@pytest.mark.parametrize("alpha", [0.1, 0.2, 0.5])
def test_cvar_metric(alpha):
    x = np.random.default_rng(1).normal(size=50)
    expected = x[x >= _ref_var(x, alpha)].mean()
    assert float(tcore.cvar_metric(_t(x), alpha)) == pytest.approx(expected)
    batch = np.random.default_rng(2).normal(size=(5, 50))
    batch[0] = np.round(batch[0])              # ties at the VaR
    _same(tcore.cvar_metric(_t(batch), alpha),
          jcore.cvar_metric(jnp.asarray(batch), alpha))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_expected_value(axis):
    x = np.arange(24.0).reshape(2, 3, 4)
    _same(tcore.expected_value(_t(x), axis),
          jcore.expected_value(jnp.asarray(x), axis))
    _same(tcore.expected_value(_t(x)), x.mean(0))


def test_rollout_positions():
    start, vel = np.array([1.0, -2.0]), np.array([0.5, 0.25])
    ours = tcore.rollout_positions(_t(start), _t(vel), 7, 0.2)
    _same(ours, jcore.dynamics.rollout_positions(jnp.asarray(start),
                                                 jnp.asarray(vel), 7, 0.2))
    assert ours.shape == (8, 2)
    _same(ours[-1], start + 7 * 0.2 * vel)
    # Leading batch axes ride along.
    starts = np.random.default_rng(0).normal(size=(3, 2))
    batch = tcore.rollout_positions(_t(starts), _t(vel).expand(3, 2), 7, 0.2)
    assert batch.shape == (3, 8, 2)
    for i in range(3):
        _same(batch[i], tcore.rollout_positions(_t(starts[i]), _t(vel), 7,
                                                0.2))
    assert tcore.rollout_positions(_t(start).float(), _t(vel).float(), 2,
                                   0.1).dtype == torch.float32


def test_minkowski_difference_circle_circle():
    assert tcore.minkowski_difference_circle_circle(0.3, 0.45) == \
        jcore.minkowski_difference_circle_circle(0.3, 0.45) == 0.75
    _same(tcore.minkowski_difference_circle_circle(_t([0.1, 0.2]), _t(0.3)),
          np.array([0.4, 0.5]))


def test_normalize_vector():
    _same(tutils.normalize_vector(_t([3.0, 4.0])), [0.6, 0.8])
    _same(tutils.normalize_vector(torch.zeros(2, dtype=torch.float64)),
          [0.0, 0.0], 0)
    v = np.random.default_rng(0).normal(size=(4, 5, 2))
    v[1, 2] = 0.0
    v[2, 3] = 1e-12
    _same(tutils.normalize_vector(_t(v)),
          jutils.normalize_vector(jnp.asarray(v)))


def test_halfspace_membership_and_projection():
    h, g = _t([1.0, 0.0]), -1.0              # halfspace: x <= 1
    assert bool(tutils.is_point_in_halfspace(_t([0.5, 7.0]), h, g))
    assert not bool(tutils.is_point_in_halfspace(_t([2.0, 0.0]), h, g))
    _same(tutils.project_point_to_halfspace(_t([2.0, 3.0]), h, g),
          [1.0, 3.0])
    _same(tutils.project_point_to_halfspace(_t([0.2, 3.0]), h, g),
          [0.2, 3.0])
    rng = np.random.default_rng(1)
    pts, hs, gs = (rng.normal(size=(6, 2)), 3.0 * rng.normal(size=(6, 2)),
                   rng.normal(size=6))
    assert tutils.is_point_in_halfspace(_t(pts), _t(hs), _t(gs)).tolist() == \
        np.asarray(jutils.is_point_in_halfspace(
            jnp.asarray(pts), jnp.asarray(hs), jnp.asarray(gs))).tolist()
    _same(tutils.project_point_to_halfspace(_t(pts), _t(hs), _t(gs)),
          jutils.project_point_to_halfspace(jnp.asarray(pts), jnp.asarray(hs),
                                            jnp.asarray(gs)))


def test_exports_match_the_jax_package():
    for name in ("expected_value", "var_metric", "cvar_metric",
                 "rollout_positions", "minkowski_difference_circle_circle"):
        assert callable(getattr(tcore, name)), name
    for name in ("normalize_vector", "is_point_in_halfspace",
                 "project_point_to_halfspace"):
        assert getattr(tutils, name) is getattr(tutils.math_utils, name)
        assert callable(getattr(jutils, name))
