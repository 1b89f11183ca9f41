"""PyTorch port: the generic batched IPM (ops/qp_ipm.py) against the JAX
solver and the scipy oracle.

The cases and tolerances of tests/test_qp_ipm.py, on the same numpy
problems: the oracle to 5e-6, an inactive box to 1e-7, a tight box to
1e-8, batched against single to 1e-9, float32 to 5e-4, the healthy lanes
beside a stalling one to 2e-3 (the stalling lane exits before
max_iters // 2).  `converged` and `iterations` are held to the JAX
solver's on the same problems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    qp_ipm as jqp)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    qp_ipm as tqp)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_linalg)

from test_qp_ipm import _random_qp, _scipy_solve


def _t(*arrays, dtype=torch.float64):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float64):
    return [jnp.asarray(a, dtype) for a in arrays]


def _same_exit(ours, theirs, iterations=True):
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(theirs.converged))
    if iterations:
        np.testing.assert_array_equal(ours.iterations.numpy(),
                                      np.asarray(theirs.iterations))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_qp_matches_scipy_and_jax(seed):
    P, q, G, h = _random_qp(seed, 15, 30)
    sol = tqp.solve_qp(*_t(P, q, G, h))
    z_ref, f_ref = _scipy_solve(P, q, G, h)
    assert bool(sol.converged)
    assert float(sol.obj) <= f_ref + 1e-7
    np.testing.assert_allclose(sol.z.numpy(), z_ref, atol=5e-6)
    jsol = jqp.solve_qp(*_j(P, q, G, h))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), atol=5e-6)
    np.testing.assert_allclose(sol.lam.numpy(), np.asarray(jsol.lam),
                               atol=5e-6)
    _same_exit(sol, jsol)


def test_solve_qp_unconstrained_active():
    P, q, _, _ = _random_qp(10, 8, 1)
    G = np.zeros((1, 8))
    G[0, 0] = 1.0
    h = np.array([1e6])
    sol = tqp.solve_qp(*_t(P, q, G, h))
    np.testing.assert_allclose(sol.z.numpy(), -np.linalg.solve(P, q),
                               atol=1e-7)
    # Iterations are not compared here: with a slack of 1e6 the merit's
    # last digits are rounding, and the JAX solver sits on a plateau
    # (2.07e-7, iterations 12-21, then 23 in all) that the port's order
    # of operations passes (14 in all); both converge.
    _same_exit(sol, jqp.solve_qp(*_j(P, q, G, h)), iterations=False)


def test_solve_qp_batched_matches_single():
    probs = [_random_qp(seed + 100, 12, 20) for seed in range(5)]
    P, q, G, h = (np.stack(a) for a in zip(*probs))
    batch = tqp.solve_qp_batched(*_t(P, q, G, h))
    for i in range(5):
        single = tqp.solve_qp(*_t(P[i], q[i], G[i], h[i]))
        np.testing.assert_allclose(batch.z[i].numpy(), single.z.numpy(),
                                   atol=1e-9)
        assert int(batch.iterations[i]) == int(single.iterations)
    jbatch = jqp.solve_qp_batched(*_j(P, q, G, h))
    np.testing.assert_allclose(batch.z.numpy(), np.asarray(jbatch.z),
                               atol=1e-9)
    _same_exit(batch, jbatch)


def test_solve_qp_tight_constraints():
    n = 6
    P, q, G, h = 2 * np.eye(n), -4 * np.ones(n), np.eye(n), np.ones(n)
    sol = tqp.solve_qp(*_t(P, q, G, h))
    np.testing.assert_allclose(sol.z.numpy(), np.ones(n), atol=1e-8)
    assert bool(sol.converged)
    _same_exit(sol, jqp.solve_qp(*_j(P, q, G, h)))


def _nasty_batch():
    probs = [_random_qp(seed + 200, 12, 20) for seed in range(4)]
    rng = np.random.default_rng(99)
    L = rng.normal(size=(12, 2))
    Pn = L @ L.T + 1e-6 * np.eye(12)
    qn = rng.normal(size=12)
    Gn = rng.normal(size=(20, 12))
    Gn[10:] = Gn[:10]                      # duplicated rows
    hn = rng.uniform(0.1, 0.5, size=20)
    hn[10:] = hn[:10]
    probs.append((Pn, qn, Gn, hn))
    return probs


def test_solve_qp_nasty_lane_exits_early():
    """A stalling float32 lane (near-singular P, duplicated degenerate
    rows) stops on its own exits long before max_iters, and the healthy
    lanes beside it stay oracle-accurate."""
    probs = _nasty_batch()
    P, q, G, h = (np.stack(a) for a in zip(*probs))
    max_iters = 200
    batch = tqp.solve_qp_batched(*_t(P, q, G, h, dtype=torch.float32),
                                 max_iters=max_iters)
    iters = batch.iterations.numpy()
    assert iters.max() < max_iters // 2, iters
    for i in range(4):
        assert bool(batch.converged[i])
        z_ref, _ = _scipy_solve(*probs[i])
        np.testing.assert_allclose(batch.z[i].numpy(), z_ref, atol=2e-3)
    jbatch = jqp.solve_qp_batched(*_j(P, q, G, h, dtype=jnp.float32),
                                  max_iters=max_iters)
    np.testing.assert_array_equal(batch.converged.numpy(),
                                  np.asarray(jbatch.converged))
    assert np.asarray(jbatch.iterations).max() < max_iters // 2


def test_solve_qp_float32():
    P, q, G, h = _random_qp(7, 15, 30)
    z_ref, _ = _scipy_solve(P, q, G, h)
    sol = tqp.solve_qp(*_t(P, q, G, h, dtype=torch.float32), tol=3e-5)
    assert bool(sol.converged)
    assert sol.z.dtype == torch.float32
    np.testing.assert_allclose(sol.z.numpy(), z_ref, atol=5e-4)
    jsol = jqp.solve_qp(*_j(P, q, G, h, dtype=jnp.float32), tol=3e-5)
    assert bool(jsol.converged)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), atol=5e-4)


def test_factorisations_go_through_the_dispatch(monkeypatch):
    """Every factorisation and solve takes the structured solver's
    `_factor` / `_solve`: float32 n <= 64 to the kernel wrappers (their
    plain forms on the CPU), float64 to the plain versions."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        qp_ipm_structured as qs)
    monkeypatch.setattr(qs, "batched_cholesky",
                        spy("kernel", cuda_linalg.batched_cholesky))
    monkeypatch.setattr(qs, "batched_cho_solve",
                        spy("kernel", cuda_linalg.batched_cho_solve))
    monkeypatch.setattr(qs, "batched_cholesky_plain",
                        spy("plain", cuda_linalg.batched_cholesky_plain))
    monkeypatch.setattr(qs, "batched_cho_solve_plain",
                        spy("plain", cuda_linalg.batched_cho_solve_plain))
    P, q, G, h = _random_qp(3, 15, 30)
    sol = tqp.solve_qp(*_t(P, q, G, h, dtype=torch.float32))
    n_iter = int(sol.iterations)
    assert calls and set(calls) == {"kernel"}
    calls.clear()
    tqp.solve_qp(*_t(P, q, G, h))
    assert calls and set(calls) == {"plain"}
    assert n_iter > 0
