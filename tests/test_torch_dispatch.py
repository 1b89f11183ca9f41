"""PyTorch port: which systems and rows go to the hand kernels.

The selectors (`use_linalg_kernels`, `use_halfspace_kernel`) are pure
functions of dtype and shape; every branch is held here, and the call
sites are watched through spies.  Then the shapes and the dtype that
leave the kernels (float64, more than 49,152 samples a row, horizons 31
and 33) run through `run_single_scenario` on the CPU and are held to the
JAX pipeline, which takes its library path for them as its own tests do:
controls to 1e-6 in float64, halfspaces to 1e-9, equal iteration counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models import (
    pipeline as jpipe)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.obstacles import (
    ObstacleData as JObstacleData)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck, cuda_linalg as cl, qp_ipm_structured as qp)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    environment as tenv)

torch.set_num_threads(1)

F64, F32 = torch.float64, torch.float32


@pytest.mark.parametrize("dtype,n,k,want", [
    (F32, 60, 1, True), (F32, 64, 65, True), (F32, 64, 256, True),
    (F32, 1, 1, True),
    (F32, 65, 1, False),       # horizon 33: n = 66
    (F32, 66, 1, False),       # horizon 31's polish: k_sel = 66
    (F32, 62, 67, True),       # horizon 31's K system with its 67 columns
    (F32, 64, 257, False),
    (F64, 60, 1, False), (torch.float16, 60, 1, False),
])
def test_use_linalg_kernels(dtype, n, k, want):
    assert qp.use_linalg_kernels(dtype, n, k) is want
    assert (cl.N_MAX, cl.MAX_RHS) == (64, 256)


@pytest.mark.parametrize("dtype,n,want", [
    (F32, 1, True), (F32, 1000, True), (F32, 49152, True),
    (F32, 49153, True), (F32, 393216, True), (F32, 393217, False),
    (F64, 1000, False), (F64, 49153, False), (torch.float16, 20, False),
])
def test_use_halfspace_kernel(dtype, n, want):
    assert tenv.use_halfspace_kernel(dtype, n) is want
    assert (ck.BLOCK_MAX_N, ck.MAX_N_SAMPLES) == (49152, 393216)


def test_the_selectors_agree_with_what_the_wrappers_take():
    """A shape the selector sends to a kernel passes the wrapper's own
    check, and one it keeps away is one the wrapper refuses."""
    def factor_ok(dtype, n):
        try:
            cl.check_factor("S", "cuda", dtype, (2, n, n), (n * n, n, 1))
            return True
        except (TypeError, ValueError):
            return False

    def solve_ok(dtype, n, k):
        L = ("cuda", dtype, (2, n, n), (n * n, n, 1))
        r = ("cuda", dtype, (2, n, k), (n * k, k, 1))
        try:
            cl.check_solve(L, r)
            return True
        except (TypeError, ValueError):
            return False

    for dtype in (F32, F64):
        for n in (1, 60, 62, 64, 65, 66, 80):
            assert factor_ok(dtype, n) is qp.use_linalg_kernels(dtype, n)
            for k in (1, 65, 67, 256, 257):
                assert solve_ok(dtype, n, k) is \
                    qp.use_linalg_kernels(dtype, n, k)
    for n in (1, 1024, 1025, 49152, 49153, 393216):
        ck.halfspace_plan(4, n, True)
    with pytest.raises(ValueError):
        ck.halfspace_plan(4, 393217, True)


@pytest.fixture
def linalg_calls(monkeypatch):
    """Names of the factor / solve functions the solver called, with
    their sizes."""
    calls = []
    for name in ("batched_cholesky", "batched_cholesky_plain",
                 "batched_cho_solve", "batched_cho_solve_plain"):
        real = getattr(qp, name)

        def spy(*args, _name=name, _real=real):
            k = (1 if "solve" not in _name or args[1].dim() == 2
                 else args[1].shape[-1])
            calls.append((_name, args[0].shape[-1], k))
            return _real(*args)
        monkeypatch.setattr(qp, name, spy)
    return calls


def _random_qp(n, m2, dtype, seed=0, B=2):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n)) / np.sqrt(n)
    t = lambda v: torch.as_tensor(v, dtype=dtype)   # noqa: E731
    return (t(L @ L.T + np.eye(n)), t(rng.normal(size=(B, n))),
            t(np.zeros((0, n))), t(np.zeros((B, 0))),
            t(rng.normal(size=(B, m2, n))),
            t(rng.uniform(-1.0, 1.0, size=(B, m2))), 100.0, 50.0)


@pytest.mark.parametrize("dtype,n,m2,plain", [
    # (name suffix "" = the kernel wrapper, "_plain" = the plain version)
    (F32, 12, 30, set()),                         # all systems to the kernels
    (F32, 62, 80, {("batched_cholesky_plain", 66, 1),      # the polish's
                   ("batched_cho_solve_plain", 66, 1)}),   # k_sel system
    (F32, 66, 80, "all"),
    (F64, 12, 30, "all"),
])
def test_solver_call_sites_follow_the_selector(linalg_calls, dtype, n, m2,
                                               plain):
    sol = qp.solve_mpc_qp(*_random_qp(n, m2, dtype))
    assert bool(torch.isfinite(sol.u).all())
    seen = set(linalg_calls)
    went_plain = {c for c in seen if c[0].endswith("_plain")}
    if plain == "all":
        assert went_plain == seen and seen
    else:
        assert went_plain == plain
        assert {c[0] for c in seen - went_plain} == {"batched_cholesky",
                                                     "batched_cho_solve"}
    for name, size, k in seen:
        assert name.endswith("_plain") is not \
            qp.use_linalg_kernels(dtype, size, k)


def _small(preset="custom", **changes):
    return dataclasses.replace(pt.config.get_parameters(preset), **changes)


def _run_both(params, scenario, dtype=F64, seed=7):
    """The port's `run_single_scenario` on the CPU, and the JAX pipeline
    on the obstacles the port drew."""
    ours = pt.models.run_single_scenario(scenario, params, seed=seed,
                                         dtype=dtype, device="cpu")
    obs = pt.convert.obstacle_data_numpy(ours.obstacles)
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    theirs = jpipe.run_scenario_with_obstacles(
        jpipe.make_statics(scenario, params, jdt),
        JObstacleData(**{k: jnp.asarray(v[0], jdt) for k, v in obs.items()}),
        jnp.asarray(scenario.ego_start), jnp.asarray(scenario.ego_goal),
        params.ego_velocity)
    return ours, theirs


def _hold_to_jax(ours, theirs, u_tol=1e-6, hs_tol=1e-9):
    assert ours.qp_converged[0].tolist() == \
        np.asarray(theirs.qp_converged).tolist() == [True] * 3
    np.testing.assert_allclose(ours.filtered_u[0].numpy(),
                               np.asarray(theirs.filtered_u), rtol=0,
                               atol=u_tol)
    for m in pt.models.METRICS:
        for field in ("h", "g_tilde"):
            np.testing.assert_allclose(
                getattr(ours.halfspaces.by_metric(m), field)[0].numpy(),
                np.asarray(getattr(theirs.halfspaces.by_metric(m), field)),
                rtol=0, atol=hs_tol, err_msg=f"{m}.{field}")


@pytest.fixture
def halfspace_calls(monkeypatch):
    calls = []
    for name in ("all_metrics_halfspaces", "all_metrics_halfspaces_plain"):
        real = getattr(tenv, name)

        def spy(rows, *args, _name=name, _real=real):
            calls.append((_name, rows.dtype, rows.shape[1]))
            return _real(rows, *args)
        monkeypatch.setattr(tenv, name, spy)
    return calls


def test_float64_runs_through_the_pipeline(halfspace_calls, linalg_calls):
    scenario = pt.config.get_scenario_config("multi_obstacle")
    ours, theirs = _run_both(_small(num_samples=16), scenario)
    _hold_to_jax(ours, theirs)
    assert ours.qp_iterations[0].tolist() == \
        np.asarray(theirs.qp_iterations).tolist()
    assert halfspace_calls == [("all_metrics_halfspaces_plain", F64, 16)]
    assert linalg_calls and all(c[0].endswith("_plain")
                                for c in linalg_calls)


def test_float32_at_supported_shapes_takes_every_kernel_wrapper(
        halfspace_calls, linalg_calls):
    scenario = pt.config.get_scenario_config("head_on")
    ours = pt.models.run_single_scenario(
        scenario, _small(num_samples=16), seed=7, dtype=F32, device="cpu")
    assert bool(ours.qp_converged.all())
    assert halfspace_calls == [("all_metrics_halfspaces", F32, 16)]
    assert {c[0] for c in linalg_calls} == {"batched_cholesky",
                                            "batched_cho_solve"}
    assert {c[1] for c in linalg_calls} == {60, 64}


def test_rows_longer_than_the_kernel_takes(halfspace_calls):
    """N = 393,217 samples a row, one more than the cluster path takes
    (one obstacle, T + 1 = 6 steps), in float32 and float64: the closed
    forms, equal to the JAX pipeline's."""
    scenario = pt.config.get_scenario_config("head_on")
    params = _small(num_samples=ck.MAX_N_SAMPLES + 1, sim_time=1.0)
    ours, theirs = _run_both(params, scenario)
    _hold_to_jax(ours, theirs)
    ours32, theirs32 = _run_both(params, scenario, F32)
    _hold_to_jax(ours32, theirs32, u_tol=1e-4, hs_tol=2e-5)
    assert halfspace_calls == [
        ("all_metrics_halfspaces_plain", F64, 393217),
        ("all_metrics_halfspaces_plain", F32, 393217)]


@pytest.mark.parametrize("horizon,plain_sizes", [(31, {66}), (33, {66, 70})])
def test_long_horizons_run_through_the_pipeline(linalg_calls, horizon,
                                                plain_sizes):
    """Horizon 31 (n = 62, the polish's system 66 wide) and 33 (n = 66):
    float64 against the JAX pipeline, then float32 against float64 with
    the systems the selector keeps away from the kernels."""
    scenario = pt.config.get_scenario_config("head_on")
    params = _small(num_samples=16, horizon=horizon)
    ours, theirs = _run_both(params, scenario)
    _hold_to_jax(ours, theirs)
    assert ours.filtered_u.shape == (1, 3, horizon, 2)
    assert ours.qp_iterations[0].tolist() == \
        np.asarray(theirs.qp_iterations).tolist()
    linalg_calls.clear()
    # The same obstacles in float32 (a float32 generator draws others).
    ours32 = pt.models.run_scenario_with_obstacles(
        pt.models.make_statics(scenario, params, F32, "cpu"),
        pt.simulation.ObstacleData(*(t.float() for t in ours.obstacles)),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    assert bool(ours32.qp_converged.all())
    np.testing.assert_allclose(ours32.filtered_u.numpy(),
                               ours.filtered_u.numpy(), rtol=0, atol=1e-4)
    assert {c[1] for c in linalg_calls
            if c[0].endswith("_plain")} == plain_sizes
    assert {c[1] for c in linalg_calls
            if not c[0].endswith("_plain")} == {2 * horizon} - plain_sizes
