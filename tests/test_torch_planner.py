"""PyTorch port: `plan_trajectory` (the goal-tracking QP planner) against
the JAX package's, on the cases of tests/test_planner.py.

Float64, tolerance 1e-6 on the states and inputs (the unconstrained plan
is one linear solve; the bounded plan is the generic IPM at tol 1e-9 on
both sides).  The float32 plan, whose IPM systems (n = 60) take the
batched Cholesky / solve dispatch, is held to the JAX float32 plan at
1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.dynamics import (
    create_double_integrator_matrices as j_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.planner import (
    Planner as JPlanner, plan_trajectory as j_plan)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.dynamics import (
    create_double_integrator_matrices as t_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.planner import (
    Planner, plan_trajectory)

DT, H = 0.2, 30
U_LIM = np.array([0.3, 0.3])
X_MIN, X_MAX = np.array([-10.0, -10.0, -5.0, -5.0]), np.array([10.0, 10.0,
                                                                 5.0, 5.0])
CASES = [([-4.0, 0.0, 0.0, 0.0], [4.0, 0.0, 0.0, 0.0]),
         ([0.0, -3.0, 0.5, 0.0], [2.0, 3.0, 0.0, 0.0]),
         ([1.0, 1.0, -1.0, 0.5], [-2.0, 0.5, 0.0, 0.0])]


def _planners(dtype=torch.float64):
    jA, jB, jC = j_matrices(DT, dtype=jnp.float64)
    tA, tB, tC = t_matrices(DT, dtype=dtype, device="cpu")
    return (JPlanner(jA, jB, jC, 2.0, 1.0, H, DT),
            Planner(tA, tB, tC, 2.0, 1.0, H, DT))


def _bounds(as_array):
    return dict(input_bounds=(as_array(-U_LIM), as_array(U_LIM)),
                state_bounds=(as_array(X_MIN), as_array(X_MAX)),
                has_bounds=True)


def _check_dynamics(planner, x, u):
    A, B = planner.A.numpy(), planner.B.numpy()
    for t in range(H):
        np.testing.assert_allclose(x[t + 1], A @ x[t] + B @ u[t], atol=1e-9)


@pytest.mark.parametrize("x0,goal", CASES)
def test_plan_trajectory_unconstrained_matches_jax(x0, goal):
    jp, tp = _planners()
    x_ref, u_ref, info = plan_trajectory(tp, torch.tensor(x0),
                                         torch.tensor(goal))
    jx, ju, jinfo = j_plan(jp, jnp.asarray(x0), jnp.asarray(goal))
    assert bool(info["converged"]) and bool(jinfo["converged"])
    assert x_ref.shape == (H + 1, 4) and u_ref.shape == (H, 2)
    np.testing.assert_allclose(x_ref.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(u_ref.numpy(), np.asarray(ju), atol=1e-6)
    _check_dynamics(tp, x_ref.numpy(), u_ref.numpy())
    assert np.linalg.norm(x_ref[-1].numpy() - np.asarray(goal)) < 0.5


@pytest.mark.parametrize("x0,goal", CASES)
def test_plan_trajectory_with_bounds_matches_jax(x0, goal):
    jp, tp = _planners()
    x_ref, u_ref, info = plan_trajectory(tp, torch.tensor(x0),
                                         torch.tensor(goal),
                                         **_bounds(torch.tensor))
    jx, ju, jinfo = j_plan(jp, jnp.asarray(x0), jnp.asarray(goal),
                           **_bounds(jnp.asarray))
    assert bool(info["converged"]) and bool(jinfo["converged"])
    np.testing.assert_allclose(x_ref.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(u_ref.numpy(), np.asarray(ju), atol=1e-6)
    assert (np.abs(u_ref.numpy()) <= 0.3 + 1e-7).all()
    _check_dynamics(tp, x_ref.numpy(), u_ref.numpy())


@pytest.mark.parametrize("x0,goal", CASES)
def test_plan_trajectory_float32_with_bounds_matches_jax(x0, goal):
    """Float32: the IPM systems (n = 60) take the batched Cholesky /
    solve dispatch.  Both solvers stop ~1e-2 from the float64 plan (no
    polish in the generic IPM), at the same place: within 1e-4 of each
    other."""
    jA, jB, jC = j_matrices(DT, dtype=jnp.float32)
    jp = JPlanner(jA, jB, jC, 2.0, 1.0, H, DT)
    _, tp = _planners(torch.float32)
    x32, u32, info = plan_trajectory(tp, torch.tensor(x0),
                                     torch.tensor(goal),
                                     **_bounds(torch.tensor))
    jx, ju, jinfo = j_plan(jp, jnp.asarray(x0, jnp.float32),
                           jnp.asarray(goal, jnp.float32),
                           **_bounds(lambda a: jnp.asarray(a, jnp.float32)))
    assert bool(info["converged"]) and bool(jinfo["converged"])
    assert x32.dtype == u32.dtype == torch.float32
    np.testing.assert_allclose(u32.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(x32.numpy(), np.asarray(jx), atol=1e-4)
