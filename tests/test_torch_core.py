"""PyTorch port, core/ and simulation/obstacles.py, against the JAX package
(float64, 1e-12)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core import (
    dynamics as jdyn, geometry as jgeo, risk as jrisk)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core import (
    dynamics as tdyn, geometry as tgeo, risk as trisk)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    obstacles as tobs)

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("make", ["create_double_integrator_matrices",
                                  "create_single_integrator_matrices"])
@pytest.mark.parametrize("dt", [0.2, 0.05])
def test_integrator_matrices(make, dt):
    ours = getattr(tdyn, make)(dt, dtype=F64, device="cpu")
    theirs = getattr(jdyn, make)(dt, dtype=jnp.float64)
    for a, b in zip(ours, theirs):
        assert a.dtype == F64
        _close(a, b, 0.0)


def test_simulate_linear_system_batched():
    rng = np.random.default_rng(0)
    A, B, C = jdyn.create_double_integrator_matrices(0.2, dtype=jnp.float64)
    x0 = rng.normal(size=(3, 4))
    u = rng.normal(size=(3, 30, 2))
    xs, ys = tdyn.simulate_linear_system(_t(x0), _t(u), _t(A), _t(B), _t(C))
    for i in range(3):
        jx, jy = jdyn.simulate_linear_system(jnp.asarray(x0[i]),
                                             jnp.asarray(u[i]), A, B, C)
        _close(xs[i], jx, 1e-11)
        _close(ys[i], jy, 1e-11)


@pytest.mark.parametrize("horizon", [1, 5, 30])
def test_condensed_dynamics(horizon):
    A, B, _ = tdyn.create_double_integrator_matrices(0.2, dtype=F64,
                                                    device="cpu")
    Phi, Gamma = tdyn.condensed_dynamics(A, B, horizon)
    jA, jB, _ = jdyn.create_double_integrator_matrices(0.2, dtype=jnp.float64)
    jPhi, jGamma = jdyn.condensed_dynamics(jA, jB, horizon)
    _close(Phi, jPhi, 0.0)
    _close(Gamma, jGamma, 0.0)
    # float32 statics: float64 host computation from the float32
    # matrices, rounded once -- as in the JAX package.
    Phi32, Gamma32 = tdyn.condensed_dynamics(A.float(), B.float(), horizon)
    jPhi32, jGamma32 = jdyn.condensed_dynamics(jA.astype(jnp.float32),
                                               jB.astype(jnp.float32),
                                               horizon)
    assert Phi32.dtype == torch.float32
    np.testing.assert_array_equal(Phi32.numpy(), np.asarray(jPhi32))
    np.testing.assert_array_equal(Gamma32.numpy(), np.asarray(jGamma32))


def test_geometry():
    rng = np.random.default_rng(1)
    ego = rng.normal(size=(6, 2))
    obs = rng.normal(size=(6, 2))
    obs[0] = ego[0]                       # degenerate -> [1, 0] fallback
    obs[1] = ego[1] + 1e-12
    h = tgeo.compute_separating_vector(_t(ego), _t(obs))
    _close(h, jgeo.compute_separating_vector(jnp.asarray(ego),
                                             jnp.asarray(obs)))
    assert h[0].tolist() == [1.0, 0.0] and h[1].tolist() == [1.0, 0.0]
    d = obs - ego
    d[2] = 0.0
    _close(tgeo.support_function_circle(_t(d), 0.3),
           jgeo.support_function_circle(jnp.asarray(d), 0.3))
    g = rng.normal(size=6)
    _close(tgeo.signed_distance(_t(obs), h, _t(g)),
           jgeo.signed_distance(jnp.asarray(obs), jnp.asarray(np.asarray(h)),
                                jnp.asarray(g)))


@pytest.mark.parametrize("alpha", [0.2, 0.1, 0.5, 0.37, 1.0])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_cvar_rockafellar(alpha, kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 53))
    if kind == "ties":
        x = np.round(x * 2) / 2
    _close(trisk.cvar_rockafellar(_t(x), alpha),
           jrisk.cvar_rockafellar(jnp.asarray(x), alpha))
    k = trisk.cvar_k(53, alpha)
    assert k == max(min(int(math.ceil(alpha * 53 - 1e-12)), 53), 1)
    v = trisk.kth_largest(_t(x), k)
    _close(trisk.cvar_from_kth(_t(x), v, alpha),
           jrisk.cvar_from_kth(jnp.asarray(x), jnp.asarray(v.numpy()), alpha))


def test_obstacle_generation_distribution():
    """torch generators cannot replay JAX's streams: the contract is the
    law.  Shared noise-free t = 0 start; Gaussian samples of variance
    noise_var; Laplace realizations of scale sqrt(var/2) (variance
    noise_var); nominal equal to the JAX closed form."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
        obstacles as jobs)

    starts = np.array([[0.0, 2.0], [-3.0, 0.5], [1.0, 1.0]])
    dirs = np.array([[0.0, -0.5], [0.7, 0.0], [0.0, 0.0]])   # last: static
    speeds = np.array([0.8, 0.6, 1.0])
    gen = torch.Generator().manual_seed(0)
    out = tobs.generate_obstacle_scenarios(
        gen, _t(starts), _t(dirs), _t(speeds), n_steps=30, dt=0.2,
        n_samples=400, noise_var=0.01, n_scenarios=50)
    assert out.samples.shape == (50, 3, 400, 31, 2)
    assert out.nominal.shape == out.realization.shape == (50, 3, 31, 2)
    _close(out.nominal[0], jobs.generate_nominal_trajectories(
        jnp.asarray(starts), jnp.asarray(dirs), jnp.asarray(speeds), 30, 0.2))
    assert torch.equal(out.samples[:, :, :, 0],
                       out.nominal[:, :, None, 0].expand(-1, -1, 400, -1))
    assert torch.equal(out.realization[:, :, 0], out.nominal[:, :, 0])
    noise = (out.samples - out.nominal[:, :, None])[:, :, :, 1:]
    assert abs(float(noise.mean())) < 2e-4
    assert float(noise.var()) == pytest.approx(0.01, rel=0.02)
    lap = (out.realization - out.nominal)[:, :, 1:]
    assert float(lap.var()) == pytest.approx(0.01, rel=0.05)
    # Laplace(b): E|X| = b, with b = sqrt(var / 2).
    assert float(lap.abs().mean()) == pytest.approx(math.sqrt(0.005),
                                                    rel=0.05)
    # Same generator state -> same draw.
    again = tobs.generate_obstacle_scenarios(
        torch.Generator().manual_seed(0), _t(starts), _t(dirs), _t(speeds),
        30, 0.2, 400, 0.01, 50)
    assert torch.equal(again.samples, out.samples)
