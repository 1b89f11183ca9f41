"""PyTorch port: the batched structured IPM and the MPC filter against the
JAX package's `solve_mpc_qp` / `_filter_core`, and the convert.py round
trips.

Tolerances: controls and slacks to 1e-6 in float64 (both solvers stop at
merit 1e-9 and polish to the active-set solution) with IPM iteration
counts within +-1; 1e-4 in float32 on the dense instances.  On random
box-layout instances float32 agreement is bounded by the problems'
input sensitivity instead (see test_box_theta_filter_core_f32_...).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.dynamics import (
    create_double_integrator_matrices as j_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.mpc_filter import (
    _filter_core as j_filter_core, build_mpc_problem as j_build)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
    solve_mpc_qp as j_solve)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
    convert)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.dynamics import (
    create_double_integrator_matrices as t_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.mpc_filter import (
    _filter_core as t_filter_core, build_mpc_problem as t_build)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops.qp_ipm_structured import (
    solve_mpc_qp as t_solve)

torch.set_num_threads(1)

TOL = {torch.float64: 1e-6, torch.float32: 1e-4}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
U_MIN, P_MIN = np.array([-5.0, -5.0]), np.array([-10.0, -10.0])


def _structured_instance(seed, n=12, m1=10, m2=8):
    """tests/test_qp_structured.py's dense instances."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P_uu = L @ L.T + np.eye(n)
    q_u = rng.normal(size=n)
    G_u = rng.normal(size=(m1, n))
    h1 = rng.uniform(0.2, 2.0, size=m1)
    A = rng.normal(size=(m2, n))
    b = rng.uniform(-1.0, 1.0, size=m2)
    return P_uu, q_u, G_u, h1, A, b


def _check_batch(sol, jsols, dtype):
    tol = TOL[dtype]
    for i, js in enumerate(jsols):
        assert bool(sol.converged[i]) and bool(js.converged)
        np.testing.assert_allclose(sol.u[i].numpy(), np.asarray(js.u),
                                   atol=tol)
        np.testing.assert_allclose(sol.s[i].numpy(), np.asarray(js.s),
                                   atol=tol)
        assert float(sol.obj[i]) == pytest.approx(float(js.obj),
                                                  rel=tol, abs=tol)
        if dtype == torch.float64:
            assert abs(int(sol.iterations[i]) - int(js.iterations)) <= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m1", [10, 0])
def test_dense_instances_batched_match_jax(dtype, m1):
    """Five instances with their own P_uu and G_u, solved as ONE batch
    (per-lane done/stall masks) against five JAX solves."""
    data = [_structured_instance(seed, m1=m1) for seed in range(5)]
    stacked = [torch.as_tensor(np.stack(col), dtype=dtype)
               for col in zip(*data)]
    sol = t_solve(*stacked, 100.0, 50.0)
    jsols = [j_solve(*[jnp.asarray(x, JDT[dtype]) for x in d], 100.0, 50.0)
             for d in data]
    _check_batch(sol, jsols, dtype)


def _box_problem_data(seed, B, H=30, n_obs=3):
    """Random MPC instances in the pipeline's box_theta layout, as
    bench.py's MPC benchmark draws them."""
    rng = np.random.default_rng(seed)
    x0 = 0.1 * rng.normal(size=(B, 4))
    x_ref = np.cumsum(0.2 * rng.normal(size=(B, H + 1, 4)), axis=1)
    hs_h = rng.normal(size=(B, H, n_obs, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = rng.uniform(-1.5, 0.2, size=(B, H, n_obs))
    return x0, x_ref, hs_h, hs_g


def _box_solves(data, dtype, bounds=(U_MIN, -U_MIN, P_MIN, -P_MIN)):
    """Port (one batch) and JAX (per instance) `_filter_core` solves."""
    A, Bm, C = j_matrices(0.2, dtype=JDT[dtype])
    jprob = j_build(A, Bm, C, 2.0, 1.0, 30, 3)
    tprob = t_build(*t_matrices(0.2, dtype=dtype, device="cpu"), 2.0, 1.0, 30, 3)
    ours = t_filter_core(
        tprob, *[torch.as_tensor(x, dtype=dtype) for x in data],
        *[torch.as_tensor(v, dtype=dtype) for v in bounds], 60, None)
    theirs = [j_filter_core(jprob, *[jnp.asarray(x[i], JDT[dtype])
                                     for x in data],
                            *[jnp.asarray(v, JDT[dtype]) for v in bounds],
                            60, None)
              for i in range(data[0].shape[0])]
    return ours, theirs


def test_box_theta_filter_core_matches_jax_f64():
    data = _box_problem_data(0, 4)
    (u, slack, sol, obj), theirs = _box_solves(data, torch.float64)
    for i, (ju, js, jsol, jobj) in enumerate(theirs):
        np.testing.assert_allclose(u[i].numpy(), np.asarray(ju), atol=1e-6)
        np.testing.assert_allclose(slack[i].numpy(), np.asarray(js),
                                   atol=1e-6)
        assert float(obj[i]) == pytest.approx(float(jobj), rel=1e-9)
    _check_batch(sol, [t[2] for t in theirs], torch.float64)


def test_box_theta_filter_core_f32_as_accurate_as_jax():
    """Random bench-style halfspaces make degenerate active sets: there
    the float32 optimum of BOTH implementations lies up to ~2e-2 from
    the float64 one (input sensitivity, measured), so the two float32
    solutions cannot agree to 1e-4.  The gate is parity in accuracy:
    per instance the port's float32 controls are no further from the
    float64 optimum than max(1e-4, 1.25x) the JAX package's, and the
    objectives agree to 1e-4 relative."""
    data = _box_problem_data(0, 4)
    (u64, _, _, _), _ = _box_solves(data, torch.float64)
    (u, _, sol, obj), theirs = _box_solves(data, torch.float32)
    for i, (ju, _, jsol, jobj) in enumerate(theirs):
        assert bool(sol.converged[i]) and bool(jsol.converged)
        err = np.abs(u[i].numpy() - u64[i].numpy()).max()
        jerr = np.abs(np.asarray(ju) - u64[i].numpy()).max()
        assert err <= max(1e-4, 1.25 * jerr), (i, err, jerr)
        assert float(obj[i]) == pytest.approx(float(jobj), rel=1e-4)


def test_iteration_cap_freezes_lanes():
    """With a cap below convergence every lane stops at the cap, still
    reports finite iterates, and a lane solved alone in a batch of one
    gives the same result as inside the batch."""
    B = 3
    data = _box_problem_data(1, B)
    tprob = t_build(*t_matrices(0.2, dtype=torch.float64, device="cpu"), 2.0, 1.0, 30, 3)
    args = [torch.as_tensor(v) for v in (U_MIN, -U_MIN, P_MIN, -P_MIN)]
    tdata = [torch.as_tensor(x) for x in data]
    _, _, capped, _ = t_filter_core(tprob, *tdata, *args, 3, None)
    assert capped.iterations.tolist() == [3, 3, 3]
    assert torch.isfinite(capped.u).all()
    u_all, _, sol_all, _ = t_filter_core(tprob, *tdata, *args, 60, None)
    u_one, _, sol_one, _ = t_filter_core(tprob, *[x[1:2] for x in tdata],
                                         *args, 60, None)
    assert int(sol_one.iterations[0]) == int(sol_all.iterations[1])
    np.testing.assert_allclose(u_one[0].numpy(), u_all[1].numpy(),
                               atol=1e-12)


def test_convert_round_trips_and_build_matches_jax():
    A, Bm, C = j_matrices(0.2, dtype=jnp.float64)
    jprob = j_build(A, Bm, C, 2.0, 1.0, 30, 3)
    from_jax = convert.mpc_problem(jprob, torch.float64, "cpu")
    ours = t_build(*t_matrices(0.2, dtype=torch.float64, device="cpu"), 2.0, 1.0, 30, 3)
    for f in convert.MPC_ARRAYS:
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   getattr(from_jax, f).numpy(), rtol=0,
                                   atol=1e-12, err_msg=f)
    for f in convert.MPC_SCALARS:
        assert getattr(ours, f) == getattr(from_jax, f), f
    back = convert.mpc_problem_numpy(from_jax)
    for f in convert.MPC_ARRAYS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jprob, f)))
    again = convert.mpc_problem(back, torch.float64, "cpu")
    assert all(torch.equal(getattr(again, f), getattr(from_jax, f))
               for f in convert.MPC_ARRAYS)

    rng = np.random.default_rng(0)
    obs = {"nominal": rng.normal(size=(2, 7, 2)),
           "samples": rng.normal(size=(2, 5, 7, 2)),
           "realization": rng.normal(size=(2, 7, 2))}
    tobs = convert.obstacle_data(obs, torch.float64, "cpu",
                                 add_batch=True)
    assert tobs.samples.shape == (1, 2, 5, 7, 2)
    back = convert.obstacle_data_numpy(tobs)
    for f, v in obs.items():
        np.testing.assert_array_equal(back[f][0], v)
    jobs_like = jax.tree_util.tree_map(jnp.asarray, obs)
    assert torch.equal(convert.obstacle_data(jobs_like, torch.float64,
                                             "cpu", add_batch=True).samples,
                       tobs.samples)
