"""PyTorch port: `solve_mpc_qp(warm=...)` and the empty box block, against
the cold solve and the JAX package's solver on the same numpy instances
(tests/test_qp_structured.py's).

Tolerances, float64: the warm solve reaches the cold optimum to 1e-6 in
the controls and the objective and takes `<=` the cold solve's
iterations (a strict `<` can flake on an instance whose cold solve is
already short); against the JAX warm solve controls to 1e-6 and the
iteration counts within +-1.  Float32: 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
    solve_mpc_qp as j_solve)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.mpc_filter import (
    _filter_core)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops.qp_ipm_structured import (
    solve_mpc_qp as t_solve)

torch.set_num_threads(1)

F64, F32 = torch.float64, torch.float32
P_SS, Q_S = 100.0, 50.0


def _instance(seed, n=12, m1=10, m2=8):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    return (L @ L.T + np.eye(n), rng.normal(size=n),
            rng.normal(size=(m1, n)), rng.uniform(0.2, 2.0, size=m1),
            rng.normal(size=(m2, n)), rng.uniform(-1.0, 1.0, size=m2))


def _t_args(data, dtype=F64):
    """The port's batched layout: P_uu and G_u shared, the rest [1, ...]."""
    P_uu, q_u, G_u, h1, A, b = (torch.as_tensor(x, dtype=dtype) for x in data)
    return [P_uu, q_u[None], G_u, h1[None], A[None], b[None], P_SS, Q_S]


def _j_args(data, jdt=jnp.float64):
    return [jnp.asarray(x, jdt) for x in data] + [P_SS, Q_S]


def _warm_of(sol):
    return (sol.u, sol.s, *sol.mults)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_warm_start_same_optimum_no_more_iterations(seed):
    data = list(_instance(seed))
    base = t_solve(*_t_args(data))
    assert bool(base.converged)
    # Perturb the soft-constraint offsets (the metric axis changes only
    # hs_g, which lands in b).
    data[5] = data[5] + 0.05
    cold = t_solve(*_t_args(data))
    warm = t_solve(*_t_args(data), warm=_warm_of(base))
    assert bool(cold.converged) and bool(warm.converged)
    np.testing.assert_allclose(warm.u.numpy(), cold.u.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(warm.obj) == pytest.approx(float(cold.obj), abs=1e-6)
    assert int(warm.iterations) <= int(cold.iterations)


@pytest.mark.parametrize("seed", [0, 3])
def test_warm_start_matches_jax_warm_solve(seed):
    data = list(_instance(seed))
    base, jbase = t_solve(*_t_args(data)), j_solve(*_j_args(data))
    data[5] = data[5] + 0.05
    warm = t_solve(*_t_args(data), warm=_warm_of(base))
    jwarm = j_solve(*_j_args(data), warm=(jbase.u, jbase.s, *jbase.mults))
    assert bool(warm.converged) and bool(jwarm.converged)
    np.testing.assert_allclose(warm.u[0].numpy(), np.asarray(jwarm.u),
                               atol=1e-6)
    np.testing.assert_allclose(warm.s[0].numpy(), np.asarray(jwarm.s),
                               atol=1e-6)
    assert abs(int(warm.iterations) - int(jwarm.iterations)) <= 1
    # The same start fed to both: the JAX iterates into the port.
    fed = t_solve(*_t_args(data), warm=tuple(
        torch.as_tensor(np.array(x))[None]
        for x in (jbase.u, jbase.s, *jbase.mults)))
    np.testing.assert_allclose(fed.u[0].numpy(), np.asarray(jwarm.u),
                               atol=1e-6)
    assert abs(int(fed.iterations) - int(jwarm.iterations)) <= 1


def test_warm_start_floors_a_boundary_start():
    """A start ON the boundary (zero slacks and multipliers, the cold
    optimum's u) is moved into the interior and still converges to the
    cold optimum."""
    data = _instance(2)
    cold = t_solve(*_t_args(data))
    zeros = tuple(torch.zeros_like(t) for t in (cold.s, *cold.mults))
    warm = t_solve(*_t_args(data), warm=(cold.u, *zeros))
    assert bool(warm.converged)
    np.testing.assert_allclose(warm.u.numpy(), cold.u.numpy(), atol=1e-6)


def test_warm_start_per_lane_in_a_batch():
    """Two lanes, each warm-started from its own base solve, equal the
    two single warm solves: the start is per lane."""
    datas = [list(_instance(s)) for s in (0, 3)]
    singles, warms = [], []
    for data in datas:
        base = t_solve(*_t_args(data))
        data[5] = data[5] + 0.05
        warms.append(_warm_of(base))
        singles.append(t_solve(*_t_args(data), warm=warms[-1]))
    stack = lambda i: torch.as_tensor(   # noqa: E731
        np.stack([d[i] for d in datas]))
    batch = t_solve(stack(0), stack(1), stack(2), stack(3), stack(4),
                    stack(5), P_SS, Q_S,
                    warm=tuple(torch.cat(ws) for ws in zip(*warms)))
    for i, single in enumerate(singles):
        assert int(batch.iterations[i]) == int(single.iterations)
        np.testing.assert_allclose(batch.u[i].numpy(), single.u[0].numpy(),
                                   atol=1e-12)


def test_warm_start_float32():
    data = list(_instance(0))
    base = t_solve(*_t_args(data, F32))
    data[5] = data[5] + 0.05
    cold = t_solve(*_t_args(data, F32))
    warm = t_solve(*_t_args(data, F32), warm=_warm_of(base))
    ref = t_solve(*_t_args(data))
    assert warm.u.dtype == F32 and bool(warm.converged)
    np.testing.assert_allclose(warm.u.numpy(), ref.u.numpy(), atol=1e-4)
    assert int(warm.iterations) <= int(cold.iterations)


@pytest.mark.parametrize("dtype,tol", [(F64, 2e-6), (F32, 1e-4)],
                         ids=["f64", "f32"])
def test_no_box_rows(dtype, tol):
    """m1 = 0 (no bounds): an empty G_u block through the loop, the
    polish and the reported residuals, against the JAX solve."""
    data = list(_instance(7, m1=0))
    sol = t_solve(*_t_args(data, dtype))
    jsol = j_solve(*_j_args(data))
    assert sol.mults[0].shape == (1, 0)
    assert bool(sol.converged) and bool(jsol.converged)
    for name in ("u", "s"):
        np.testing.assert_allclose(getattr(sol, name)[0].numpy(),
                                   np.asarray(getattr(jsol, name)), atol=tol)
    assert all(bool(torch.isfinite(getattr(sol, f)).all())
               for f in ("obj", "gap", "prim_res", "dual_res", "merit"))
    # With fewer soft rows than n + 4 the polish selects them all.
    few = list(_instance(7, m1=0, m2=3))
    sol = t_solve(*_t_args(few, dtype))
    jsol = j_solve(*_j_args(few))
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.u[0].numpy(), np.asarray(jsol.u), atol=tol)


def test_filter_core_passes_warm_through():
    """`_filter_core(warm=...)` from its own cold solution: the same
    controls in no more iterations."""
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

    H = 8
    A, B, C = pt.core.create_double_integrator_matrices(0.2, dtype=F64,
                                                        device="cpu")
    prob = pt.models.build_mpc_problem(A, B, C, 2.0, 1.0, H, 1)
    rng = np.random.default_rng(5)
    t = lambda v: torch.as_tensor(v, dtype=F64)   # noqa: E731
    x_ref = np.zeros((2, H + 1, 4))
    x_ref[:, :, 0] = -4.0 + 0.3 * np.arange(H + 1)
    hs_h = rng.normal(size=(2, H, 1, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    args = (t([[-4.0, 0, 0, 0]] * 2), t(x_ref), t(hs_h),
            t(rng.uniform(-1.0, 0.5, size=(2, H, 1))),
            t([-5.0, -5.0]), t([5.0, 5.0]), t([-10.0, -10.0]),
            t([10.0, 10.0]), 60, None)
    u_c, _, sol_c, _ = _filter_core(prob, *args)
    u_w, _, sol_w, _ = _filter_core(prob, *args, warm=_warm_of(sol_c))
    assert bool(sol_w.converged.all())
    torch.testing.assert_close(u_w, u_c, rtol=0, atol=1e-6)
    assert (sol_w.iterations <= sol_c.iterations).all()
