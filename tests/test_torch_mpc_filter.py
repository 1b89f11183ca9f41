"""PyTorch port: `filter_trajectory`, `filter_core_batched` and the optional
bounds of `_filter_core`, mirroring tests/test_mpc_filter.py and held to
the JAX package's `filter_trajectory` on the same numpy inputs.

Tolerances: controls to 1e-6 of the scipy oracle and to 1e-8 of the JAX
function in float64 (both solvers stop at merit 1e-9 and polish to the
active-set solution), 1e-4 in float32; `status` and `used_fallback`
equal; chunked against flat to 1e-12 (float64) / 1e-6 (float32) with
equal per-lane `iterations`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.dynamics import (
    create_double_integrator_matrices as j_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.mpc_filter import (
    build_mpc_problem as j_build, filter_trajectory as j_filter)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.mpc_filter import (
    _filter_core, _trim_bounds, build_mpc_problem, filter_core_batched,
    filter_trajectory)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops.qp_ipm_structured import (
    solve_mpc_qp)
from oracle import mpc_qp_oracle
from torch_port_streams import double_integrator

torch.set_num_threads(1)

DT, H = 0.2, 12  # short horizon keeps the scipy oracle fast
Q_W, R_W = 2.0, 1.0
F64, F32 = torch.float64, torch.float32
JDT = {F64: jnp.float64, F32: jnp.float32}
U_BOUNDS = (np.array([-5.0, -5.0]), np.array([5.0, 5.0]))
P_BOUNDS = (np.array([-10.0, -10.0]), np.array([10.0, 10.0]))


def _problem(n_obs, dtype=F64):
    A, B, C = pt.core.create_double_integrator_matrices(DT, dtype=dtype,
                                                        device="cpu")
    return build_mpc_problem(A, B, C, Q_W, R_W, H, n_obs)


def _setup(n_obs=1, seed=0, dtype=F64):
    """tests/test_mpc_filter.py's instance, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x0 = np.array([-4.0, 0.0, 0.0, 0.0])
    x_ref = np.zeros((H + 1, 4))
    x_ref[:, 0] = -4.0 + 0.3 * np.arange(H + 1)
    x_ref[:, 2] = 1.5
    u_ref = np.zeros((H, 2))
    hs_h = rng.normal(size=(H, n_obs, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = rng.uniform(-1.0, 0.5, size=(H, n_obs))
    return _problem(n_obs, dtype), x0, x_ref, u_ref, hs_h, hs_g


def _filter(prob, *arrays, **kwargs):
    return filter_trajectory(prob, *arrays, device="cpu", **kwargs)


def _jax_filter(n_obs, dtype, arrays, **kwargs):
    jdt = JDT[dtype]
    jprob = j_build(*j_matrices(DT, dtype=jdt), Q_W, R_W, H, n_obs)
    if kwargs.get("last_optimal_u") is not None:
        kwargs["last_optimal_u"] = jnp.asarray(kwargs["last_optimal_u"], jdt)
    return j_filter(jprob, *(jnp.asarray(a, jdt) for a in arrays), **kwargs)


def _rollout_holds(res):
    A, B, _ = double_integrator(DT)
    x, u = res.x_filtered.numpy(), res.u_filtered.numpy()
    for t in range(H):
        np.testing.assert_allclose(x[t + 1], A @ x[t] + B @ u[t], atol=1e-10)


@pytest.mark.parametrize("n_obs", [1, 3])
def test_filter_matches_scipy_oracle(n_obs):
    prob, x0, x_ref, u_ref, hs_h, hs_g = _setup(n_obs)
    res = _filter(prob, x0, x_ref, u_ref, hs_h, hs_g,
                  input_bounds=U_BOUNDS, position_bounds=P_BOUNDS)
    u_oracle, _, obj_oracle = mpc_qp_oracle(
        *double_integrator(DT), Q_W, R_W, H, x0, x_ref, hs_h, hs_g,
        U_BOUNDS[0], U_BOUNDS[1], P_BOUNDS[0], P_BOUNDS[1])
    assert res.u_filtered.shape == (H, 2) and res.status.shape == ()
    assert bool(res.status) and not bool(res.used_fallback)
    np.testing.assert_allclose(res.u_filtered.numpy(), u_oracle, atol=1e-6)
    assert float(res.objective) == pytest.approx(obj_oracle, rel=1e-6)


def test_filtered_trajectory_satisfies_dynamics():
    prob, *arrays = _setup()
    res = _filter(prob, *arrays)
    assert res.x_filtered.shape == (H + 1, 4)
    _rollout_holds(res)


def test_input_bounds_respected():
    prob, *arrays = _setup(seed=3)
    res = _filter(prob, *arrays,
                  input_bounds=(np.array([-0.5, -0.5]), np.array([0.5, 0.5])))
    u = res.u_filtered.numpy()
    assert bool(res.status)
    assert (u <= 0.5 + 1e-7).all() and (u >= -0.5 - 1e-7).all()


def test_slack_nonnegative_and_consistent():
    """Slacks equal max(0, violation) at the optimum (they are penalised,
    so the QP never inflates them)."""
    prob, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=4)
    res = _filter(prob, x0, x_ref, u_ref, hs_h, hs_g)
    s = res.slack.numpy()
    assert (s >= -1e-8).all()
    pos = res.x_filtered.numpy()[1:, :2]
    viol = np.einsum("tjd,td->tj", hs_h, pos) + hs_g
    np.testing.assert_allclose(s, np.maximum(viol, 0.0), atol=1e-5)


def test_bounds_trimming_quirk():
    """4-vector bounds passed as position bounds are trimmed to 2 dims."""
    prob, *arrays = _setup(seed=5)
    full = (np.array([-10.0, -10.0, -5.0, -5.0]),
            np.array([10.0, 10.0, 5.0, 5.0]))
    res4 = _filter(prob, *arrays, position_bounds=full)
    res2 = _filter(prob, *arrays,
                   position_bounds=(full[0][:2], full[1][:2]))
    np.testing.assert_allclose(res4.u_filtered.numpy(),
                               res2.u_filtered.numpy(), atol=1e-12)
    lo, hi = _trim_bounds((torch.tensor(full[0]), list(full[1])), 2)
    assert lo.tolist() == [-10.0, -10.0] and hi.tolist() == [10.0, 10.0]
    assert _trim_bounds(None, 2) is None


def test_fallback_replays_shifted_last_u():
    """max_iters=1 forces non-convergence; the fallback shifts the
    previous optimal sequence and pads it with u_ref's last step."""
    prob, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=6)
    u_ref = np.random.default_rng(2).normal(size=(H, 2))
    last_u = np.random.default_rng(0).normal(size=(H, 2))
    res = _filter(prob, x0, x_ref, u_ref, hs_h, hs_g, last_optimal_u=last_u,
                  has_last=True, max_iters=1)
    assert bool(res.used_fallback) and not bool(res.status)
    expected = np.concatenate([last_u[1:], u_ref[H - 1:H]], axis=0)
    np.testing.assert_array_equal(res.u_filtered.numpy(), expected)
    _rollout_holds(res)
    # has_last=False ignores the history.
    res = _filter(prob, x0, x_ref, u_ref, hs_h, hs_g, last_optimal_u=last_u,
                  has_last=False, max_iters=1)
    np.testing.assert_array_equal(res.u_filtered.numpy(), u_ref)


def test_fallback_without_history_uses_u_ref():
    prob, x0, x_ref, _, hs_h, hs_g = _setup(seed=7)
    u_ref = np.random.default_rng(1).normal(size=(H, 2))
    res = _filter(prob, x0, x_ref, u_ref, hs_h, hs_g, max_iters=1)
    assert bool(res.used_fallback)
    np.testing.assert_array_equal(res.u_filtered.numpy(), u_ref)


def _flat_batch(B_total, dtype):
    prob, x0, x_ref, _, hs_h, _ = _setup(n_obs=1, seed=3, dtype=dtype)
    rng = np.random.default_rng(9)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype)   # noqa: E731
    data = (as_t(x0[None] + 0.05 * rng.normal(size=(B_total, 4))),
            as_t(np.broadcast_to(x_ref, (B_total,) + x_ref.shape).copy()),
            as_t(np.broadcast_to(hs_h, (B_total,) + hs_h.shape).copy()),
            as_t(rng.uniform(-1.0, 0.5, size=(B_total, H, 1))))
    bounds = tuple(as_t(v) for v in (U_BOUNDS[0], U_BOUNDS[1],
                                     P_BOUNDS[0], P_BOUNDS[1]))
    return prob, data, bounds


# (batch, chunk): a batch that divides into chunks, ones with a short last
# chunk, B <= chunk.  In float32 no chunk holds one lane alone: a BLAS
# chooses its kernel from the batch size (here a matrix-vector path for a
# batch of one), its rounding then differs, and a float32 lane whose merit
# sits at the threshold stops two iterations apart (1e-5 in the controls,
# the float32 solver's own floor).  float64 takes every cut.
CHUNKINGS = {F64: ((6, 2), (7, 2), (7, 3), (7, 1), (2, 4), (7, 7)),
             F32: ((6, 2), (7, 4), (6, 3), (7, 5), (2, 4), (7, 7))}


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-6)],
                         ids=["f64", "f32"])
def test_filter_core_batched_matches_flat(dtype, tol):
    """Chunking is a scheduling change only: every lane's controls,
    objective and iteration count equal the flat solve's."""
    prob, data, bounds = _flat_batch(7, dtype)
    iters = 40
    u_f, s_f, sol_f, obj_f = _filter_core(prob, *data, *bounds, iters, None)
    assert bool(sol_f.converged.all())
    assert len(set(sol_f.iterations.tolist())) > 1   # lanes do differ
    for n, chunk in CHUNKINGS[dtype]:
        sub = tuple(t[:n] for t in data)
        u_c, s_c, sol_c, obj_c = filter_core_batched(
            prob, *sub, *bounds, iters, None, chunk=chunk)
        assert u_c.shape == (n, H, 2) and s_c.shape == (n, H, 1)
        torch.testing.assert_close(u_c, u_f[:n], rtol=0, atol=tol)
        torch.testing.assert_close(obj_c, obj_f[:n], rtol=tol, atol=tol)
        assert sol_c.iterations.tolist() == sol_f.iterations[:n].tolist()
        assert sol_c.converged.tolist() == [True] * n
        for name in sol_f._fields:
            if name != "mults":
                assert getattr(sol_c, name).shape == \
                    getattr(sol_f, name)[:n].shape, name
        for ours, flat in zip(sol_c.mults, sol_f.mults):
            assert ours.shape == flat[:n].shape


def test_box_theta_structured_matches_dense():
    """The [I; -I; Theta; -Theta] structured G_u operators give the dense
    products' solution."""
    rng = np.random.default_rng(11)
    n, hp, m2 = 8, 6, 5
    L = rng.normal(size=(n, n))
    T = rng.normal(size=(hp, n))
    t = lambda v: torch.as_tensor(v, dtype=F64)   # noqa: E731
    args = (t(L @ L.T + np.eye(n)), t(rng.normal(size=(1, n))),
            t(np.vstack([np.eye(n), -np.eye(n), T, -T])),
            t(rng.uniform(0.5, 2.0, size=(1, 2 * n + 2 * hp))),
            t(rng.normal(size=(1, m2, n))),
            t(rng.uniform(-1.0, 1.0, size=(1, m2))), 100.0, 50.0)
    dense = solve_mpc_qp(*args)
    struct = solve_mpc_qp(*args, box_theta=t(T))
    assert bool(dense.converged) and bool(struct.converged)
    np.testing.assert_allclose(struct.u.numpy(), dense.u.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert float(struct.obj) == pytest.approx(float(dense.obj), abs=1e-7)


BOUND_CASES = {
    "both": dict(input_bounds=U_BOUNDS, position_bounds=P_BOUNDS),
    "inputs": dict(input_bounds=(np.array([-0.5, -0.5]),
                                 np.array([0.5, 0.5]))),
    "positions": dict(position_bounds=(np.array([-3.0, -0.4, -5.0, -5.0]),
                                       np.array([3.0, 0.4, 5.0, 5.0]))),
    "none": dict(),
}


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-8), (F32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("bounds", list(BOUND_CASES))
def test_filter_trajectory_matches_jax(bounds, dtype, tol):
    """Every bounds layout (structured, dense with one family, no box
    rows at all) against the JAX function on the same inputs."""
    n_obs = 2
    prob, *arrays = _setup(n_obs, seed=8, dtype=dtype)
    kwargs = BOUND_CASES[bounds]
    res = _filter(prob, *arrays, **kwargs)
    jres = _jax_filter(n_obs, dtype, arrays, **kwargs)
    ours = pt.convert.mpc_result_numpy(res)
    assert set(ours) == set(jres._fields)
    assert ours["u_filtered"].dtype == np.dtype(
        "float64" if dtype == F64 else "float32")
    assert bool(ours["status"]) == bool(jres.status) is True
    assert bool(ours["used_fallback"]) == bool(jres.used_fallback) is False
    for name in ("u_filtered", "x_filtered", "slack"):
        np.testing.assert_allclose(ours[name], np.asarray(getattr(jres, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(ours["objective"], float(jres.objective),
                               rtol=1e-9 if dtype == F64 else 1e-4)
    if dtype == F64:
        assert int(ours["qp_iterations"]) == int(jres.qp_iterations)


@pytest.mark.parametrize("has_last", [True, False])
def test_filter_trajectory_fallbacks_match_jax(has_last):
    prob, x0, x_ref, _, hs_h, hs_g = _setup(seed=6)
    u_ref = np.random.default_rng(2).normal(size=(H, 2))
    last_u = np.random.default_rng(0).normal(size=(H, 2))
    kwargs = dict(last_optimal_u=last_u if has_last else None,
                  has_last=has_last, max_iters=1,
                  position_bounds=(np.array([-10.0, -10.0, -5.0, -5.0]),
                                   np.array([10.0, 10.0, 5.0, 5.0])))
    arrays = (x0, x_ref, u_ref, hs_h, hs_g)
    res = _filter(prob, *arrays, **kwargs)
    jres = _jax_filter(1, F64, arrays, **kwargs)
    assert bool(res.used_fallback) == bool(jres.used_fallback) is True
    assert bool(res.status) == bool(jres.status) is False
    np.testing.assert_allclose(res.u_filtered.numpy(),
                               np.asarray(jres.u_filtered), atol=1e-12)
    np.testing.assert_allclose(res.x_filtered.numpy(),
                               np.asarray(jres.x_filtered), atol=1e-12)


def test_filter_trajectory_batch_equals_single_calls():
    """A leading batch axis: each lane is its own single call, fallback
    selection included (lane 1 has a history, lane 2 none)."""
    prob, x0, x_ref, _, hs_h, _ = _setup(n_obs=1, seed=3)
    rng = np.random.default_rng(4)
    Bn = 3
    x0_b = x0[None] + 0.05 * rng.normal(size=(Bn, 4))
    hs_g_b = rng.uniform(-1.0, 0.5, size=(Bn, H, 1))
    u_ref_b = rng.normal(size=(Bn, H, 2))
    last_b = rng.normal(size=(Bn, H, 2))
    has_last = np.array([False, True, False])
    stack = lambda a: np.broadcast_to(a, (Bn,) + a.shape).copy()  # noqa: E731
    for max_iters in (60, 1):
        batch = _filter(prob, x0_b, stack(x_ref), u_ref_b, stack(hs_h),
                        hs_g_b, input_bounds=U_BOUNDS, last_optimal_u=last_b,
                        has_last=has_last, max_iters=max_iters)
        assert batch.u_filtered.shape == (Bn, H, 2)
        assert batch.used_fallback.tolist() == [max_iters == 1] * Bn
        for i in range(Bn):
            one = _filter(prob, x0_b[i], x_ref, u_ref_b[i], hs_h, hs_g_b[i],
                          input_bounds=U_BOUNDS, last_optimal_u=last_b[i],
                          has_last=bool(has_last[i]), max_iters=max_iters)
            for a, b in zip(batch, one):
                torch.testing.assert_close(a[i], b, rtol=0, atol=1e-12)


def test_filter_trajectory_refuses_a_problem_on_another_device():
    prob, *arrays = _setup()
    with pytest.raises(ValueError, match="MPCProblem is on cpu"):
        filter_trajectory(prob, *arrays, device="cuda")


def test_exports():
    for name in ("MPCResult", "filter_trajectory", "filter_core_batched"):
        assert getattr(pt, name) is getattr(pt.models, name)
        assert getattr(pt.models, name) is getattr(pt.models.mpc_filter, name)


def test_one_box_family_float32_equals_jax_float32_and_tol_1e5_reaches_f64():
    """The seed-42 multi_obstacle QPs (H = 30) with the input bounds
    dropped.  At the default float32 tol a lane can stop on an iterate
    whose polish is rejected and then sits well above 1e-4 from float64;
    the port is held to the JAX package in float32 on the same inputs
    (1e-4, the same stop), and at tol 1e-5 to float64 (1e-4)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.pipeline import (
        STATE_BOUNDS)
    from torch_port_streams import reference_rng_obstacles

    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                  params.num_samples)
    statics = {d: pt.models.make_statics(scenario, params, d, "cpu")
               for d in (F32, F64)}
    run = pt.models.run_scenario_with_obstacles(
        statics[F32], pt.convert.obstacle_data(obs, F32, "cpu", True),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    x0 = np.zeros(4)
    x0[:2] = scenario.ego_start
    jprob = j_build(*j_matrices(params.dt, dtype=jnp.float32),
                    params.q_weight, params.r_weight, params.horizon, 3)
    gaps = []
    for m in pt.models.METRICS:
        hs = run.halfspaces.by_metric(m)
        arrays = [x0, run.x_ref[0].numpy(), run.u_ref[0].numpy(),
                  hs.h[0].numpy(), hs.g_tilde[0].numpy()]
        kwargs = dict(position_bounds=STATE_BOUNDS)
        ours = _filter(statics[F32].mpc, *arrays, **kwargs)
        theirs = j_filter(jprob, *(jnp.asarray(a, jnp.float32)
                                   for a in arrays), **kwargs)
        exact = _filter(statics[F64].mpc, *arrays, **kwargs)
        tight = _filter(statics[F32].mpc, *arrays, tol=1e-5, **kwargs)
        assert bool(ours.status) and bool(theirs.status) and bool(tight.status)
        np.testing.assert_allclose(ours.u_filtered.numpy(),
                                   np.asarray(theirs.u_filtered), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tight.u_filtered.double().numpy(),
                                   exact.u_filtered.numpy(), rtol=0,
                                   atol=1e-4)
        gaps.append(float((ours.u_filtered.double() - exact.u_filtered)
                          .abs().max()))
    print("default-tol float32 against float64, per metric:", gaps)
