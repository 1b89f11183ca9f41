"""PyTorch port: `solve_mpc_qp`, the port's one solve (one Cholesky
factorisation and two solves a pass), against the JAX solver's S^-1
route ("inv") and its three matmul precision settings on the same numpy
instances (tests/test_qp_structured.py's), the dispatch of the Newton
solves at horizons 31 and 33, and the process-wide TF32 state.

Tolerances: controls (and slacks) to 1e-6 in float64 and 1e-4 in
float32.  On the CPU the JAX solver's precision settings are bit-equal
(XLA:CPU computes full float32 whatever the setting).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
    solve_mpc_qp as j_solve)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.dynamics import (
    create_double_integrator_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
    qpbench)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.mpc_filter import (
    build_mpc_problem)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    qp_ipm_structured as qps)

torch.set_num_threads(1)

F64, F32 = torch.float64, torch.float32
P_SS, Q_S = 100.0, 50.0


def _instance(seed, n=12, m1=10, m2=8):
    """tests/test_qp_structured.py::_structured_instance's draw."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    return (L @ L.T + np.eye(n), rng.normal(size=n),
            rng.normal(size=(m1, n)), rng.uniform(0.2, 2.0, size=m1),
            rng.normal(size=(m2, n)), rng.uniform(-1.0, 1.0, size=m2))


def _box_instance(seed, n=12, hp=6, m2=8):
    """A QP with the [I; -I; T; -T] box layout, and T."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    T = rng.normal(size=(hp, n))
    G = np.vstack([np.eye(n), -np.eye(n), T, -T])
    h1 = rng.uniform(0.5, 2.0, size=2 * n + 2 * hp)
    return (L @ L.T + np.eye(n), rng.normal(size=n), G, h1,
            rng.normal(size=(m2, n)), rng.uniform(-1.0, 1.0, size=m2)), T


def _t_args(data, dtype=F64):
    """The port's batched layout: P_uu and G_u shared, the rest [1, ...]."""
    P_uu, q_u, G_u, h1, A, b = (torch.as_tensor(x, dtype=dtype) for x in data)
    return [P_uu, q_u[None], G_u, h1[None], A[None], b[None], P_SS, Q_S]


def _j_args(data, jdt=jnp.float64):
    return [jnp.asarray(x, jdt) for x in data] + [P_SS, Q_S]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv_matches_chol_and_the_jax_inv_solve(seed):
    """The port's solve against the JAX solver's S^-1 route, float64."""
    data = _instance(seed)
    sol = qps.solve_mpc_qp(*_t_args(data))
    jinv = j_solve(*_j_args(data), linsolve="inv")
    assert bool(sol.converged) and bool(jinv.converged)
    np.testing.assert_allclose(sol.u[0].numpy(), np.asarray(jinv.u),
                               atol=1e-6)
    np.testing.assert_allclose(sol.s[0].numpy(), np.asarray(jinv.s),
                               atol=1e-6)
    assert float(sol.obj) == pytest.approx(float(jinv.obj), abs=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv_float32_matches_the_jax_inv_solve(seed):
    data = _instance(seed)
    sol = qps.solve_mpc_qp(*_t_args(data, F32))
    jinv = j_solve(*_j_args(data, jnp.float32), linsolve="inv")
    assert bool(sol.converged) and bool(jinv.converged)
    np.testing.assert_allclose(sol.u[0].numpy(), np.asarray(jinv.u),
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 4])
def test_inv_with_box_theta(seed):
    """The box structure (box_theta) against the dense G_u and against
    the JAX solver's S^-1 route with box_theta."""
    data, T = _box_instance(seed)
    args = _t_args(data)
    dense = qps.solve_mpc_qp(*args)
    box = qps.solve_mpc_qp(*args, box_theta=torch.as_tensor(T))
    jinv = j_solve(*_j_args(data), linsolve="inv", box_theta=jnp.asarray(T))
    assert bool(dense.converged) and bool(box.converged)
    np.testing.assert_allclose(box.u.numpy(), dense.u.numpy(), atol=1e-6)
    np.testing.assert_allclose(box.u[0].numpy(), np.asarray(jinv.u),
                               atol=1e-6)


def _mpc_qps(horizon, batch=3, dtype=F64):
    """qpbench's QP laws at another horizon (n = 2 H controls)."""
    A, B, C = create_double_integrator_matrices(0.2, dtype=dtype,
                                                device="cpu")
    prob = build_mpc_problem(A, B, C, 2.0, 1.0, horizon, qpbench.N_OBS)
    gen = torch.Generator().manual_seed(horizon)
    f = dict(dtype=dtype, generator=gen)
    x0 = 0.1 * torch.randn(batch, 4, **f)
    x_ref = torch.cumsum(0.2 * torch.randn(batch, horizon + 1, 4, **f), 1)
    hs_h = torch.randn(batch, horizon, qpbench.N_OBS, 2, **f)
    hs_h = hs_h / hs_h.norm(dim=-1, keepdim=True)
    hs_g = -1.5 + 1.7 * torch.rand(batch, horizon, qpbench.N_OBS, **f)
    return qpbench.assemble(prob, x0, x_ref, hs_h, hs_g)


def _j_vmapped(qp, **kwargs):
    """The JAX solver under vmap on the port's batched float64 QPs."""
    P, q, G, h1, A, b, pss, qs = qp
    solve = jax.vmap(lambda qq, hh, aa, bb: j_solve(
        jnp.asarray(P.numpy()), qq, jnp.asarray(G.numpy()), hh, aa, bb,
        pss, qs, **kwargs))
    return solve(*(jnp.asarray(t.numpy()) for t in (q, h1, A, b)))


@pytest.mark.parametrize("horizon,to_kernel", [(31, True), (33, False)])
def test_inv_dispatch_at_long_horizons(monkeypatch, horizon, to_kernel):
    """The Newton solves (n = 2 H, one right-hand side) go through
    `_solve`: float32 n = 62 to the kernel wrapper, n = 66 to the plain
    version (what the kernels take decides); in float64 the solve agrees
    with the JAX solver's S^-1 route.  Only the float32 solves are looked
    at: a lane rescued in float64 runs on the plain version."""
    seen = []
    for name in ("batched_cho_solve", "batched_cho_solve_plain"):
        real = getattr(qps, name)

        def spy(L, r, name=name, real=real):
            if L.dtype == F32:
                seen.append((name, L.shape[-1],
                             1 if r.dim() == 2 else r.shape[-1]))
            return real(L, r)

        monkeypatch.setattr(qps, name, spy)
    n = 2 * horizon
    sol = qps.solve_mpc_qp(*_mpc_qps(horizon, dtype=F32), max_iters=35,
                           tol=3e-5)
    assert bool(torch.isfinite(sol.u).all())
    want = "batched_cho_solve" if to_kernel else "batched_cho_solve_plain"
    newton = [call for call in seen if call[1:] == (n, 1)]
    assert newton and {call[0] for call in newton} == {want}

    qp64 = _mpc_qps(horizon)
    sol64 = qps.solve_mpc_qp(*qp64)
    jinv = _j_vmapped(qp64, linsolve="inv")
    assert bool(sol64.converged.all()) and bool(np.all(jinv.converged))
    np.testing.assert_allclose(sol64.u.numpy(), np.asarray(jinv.u),
                               atol=1e-6)


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_precision_settings_bit_equal_on_the_cpu(dtype, prec):
    """The port's solve against the JAX solver at each of its matmul
    precision settings, which are bit-equal to each other on the CPU."""
    data = _instance(1)
    jdt, atol = (jnp.float32, 1e-4) if dtype == F32 else (jnp.float64, 1e-6)
    sol = qps.solve_mpc_qp(*_t_args(data, dtype))
    jsol = j_solve(*_j_args(data, jdt), ipm_precision=prec)
    highest = j_solve(*_j_args(data, jdt))
    for a, b in zip(jsol[:-1], highest[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert bool(sol.converged) and bool(jsol.converged)
    np.testing.assert_allclose(sol.u[0].numpy(), np.asarray(jsol.u),
                               atol=atol)


def _tf32_state():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def test_the_cpu_touches_no_global_state():
    before = _tf32_state()
    seen = []
    real = qps._factor

    def spy(S):
        seen.append(_tf32_state())
        return real(S)

    qps._factor = spy
    try:
        qps.solve_mpc_qp(*_t_args(_instance(0), F32))
    finally:
        qps._factor = real
    assert set(seen) == {before} and _tf32_state() == before


def test_inv_matches_the_jax_inv_solve_on_a_vmapped_batch():
    """A batch of the bench's QPs (H = 30, n = 60) in float64 against the
    JAX solver's S^-1 route under vmap."""
    qp = _mpc_qps(30, batch=4)
    sol = qps.solve_mpc_qp(*qp)
    jinv = _j_vmapped(qp, linsolve="inv")
    assert bool(sol.converged.all()) and bool(np.all(jinv.converged))
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(jinv.u), atol=1e-6)
