"""PyTorch port: `solve_mpc_qp(linsolve=..., ipm_precision=...)` against
"chol" and the JAX solver on the same numpy instances
(tests/test_qp_structured.py's), the dispatch of "inv"'s S^-1 solve at
horizons 31 and 33, the argument errors, and the process-wide TF32 state.

Tolerances: against the JAX `linsolve="inv"` solve, controls to 1e-6 in
float64 and 1e-4 in float32; inv against chol, the JAX test's 3e-4 in the
controls and 1e-5 in the objective (float64).  On the CPU the three
`ipm_precision` settings are bit-equal (nothing global is touched).
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
    data = _instance(seed)
    chol = qps.solve_mpc_qp(*_t_args(data))
    inv = qps.solve_mpc_qp(*_t_args(data), linsolve="inv")
    jinv = j_solve(*_j_args(data), linsolve="inv")
    assert bool(chol.converged) and bool(inv.converged)
    assert bool(jinv.converged)
    # The JAX test's bounds, inv against chol.
    np.testing.assert_allclose(inv.u.numpy(), chol.u.numpy(), atol=3e-4)
    assert float(inv.obj) == pytest.approx(float(chol.obj), abs=1e-5)
    # Against the JAX solver's own inv path.
    np.testing.assert_allclose(inv.u[0].numpy(), np.asarray(jinv.u),
                               atol=1e-6)
    np.testing.assert_allclose(inv.s[0].numpy(), np.asarray(jinv.s),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv_float32_matches_the_jax_inv_solve(seed):
    data = _instance(seed)
    inv = qps.solve_mpc_qp(*_t_args(data, F32), linsolve="inv")
    jinv = j_solve(*_j_args(data, jnp.float32), linsolve="inv")
    assert bool(inv.converged) and bool(jinv.converged)
    np.testing.assert_allclose(inv.u[0].numpy(), np.asarray(jinv.u),
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 4])
def test_inv_with_box_theta(seed):
    data, T = _box_instance(seed)
    args = _t_args(data)
    dense = qps.solve_mpc_qp(*args)
    inv = qps.solve_mpc_qp(*args, linsolve="inv",
                           box_theta=torch.as_tensor(T))
    jinv = j_solve(*_j_args(data), linsolve="inv", box_theta=jnp.asarray(T))
    assert bool(dense.converged) and bool(inv.converged)
    np.testing.assert_allclose(inv.u.numpy(), dense.u.numpy(), atol=1e-6)
    np.testing.assert_allclose(inv.u[0].numpy(), np.asarray(jinv.u),
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


@pytest.mark.parametrize("horizon,to_kernel", [(31, True), (33, False)])
def test_inv_dispatch_at_long_horizons(monkeypatch, horizon, to_kernel):
    """S^-1 is one solve with n = 2 H right-hand sides through `_solve`:
    float32 n = 62 goes to the kernel wrapper, n = 66 to the plain
    version (what the kernels take decides, as for every other solve);
    in float64 inv and chol agree.  Only the float32 solves are looked
    at: a lane rescued in float64 runs its S^-1 on the plain version."""
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
                           tol=3e-5, linsolve="inv")
    assert bool(torch.isfinite(sol.u).all())
    want = "batched_cho_solve" if to_kernel else "batched_cho_solve_plain"
    inv_solves = [call for call in seen if call[1:] == (n, n)]
    assert inv_solves and {call[0] for call in inv_solves} == {want}

    qp64 = _mpc_qps(horizon)
    chol = qps.solve_mpc_qp(*qp64)
    inv = qps.solve_mpc_qp(*qp64, linsolve="inv")
    assert bool(chol.converged.all()) and bool(inv.converged.all())
    torch.testing.assert_close(inv.u, chol.u, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kwargs", [{"linsolve": "lu"}, {"linsolve": "Chol"},
                                    {"ipm_precision": "medium"},
                                    {"ipm_precision": "HIGHEST"}])
def test_unknown_settings_raise(kwargs):
    with pytest.raises(ValueError, match=next(iter(kwargs))):
        qps.solve_mpc_qp(*_t_args(_instance(0)), **kwargs)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_precision_settings_bit_equal_on_the_cpu(dtype):
    args = _t_args(_instance(1), dtype)
    plain = qps.solve_mpc_qp(*args)
    for prec in qps.IPM_PRECISIONS:
        sol = qps.solve_mpc_qp(*args, ipm_precision=prec)
        for a, b in zip(plain[:-1], sol[:-1]):
            assert torch.equal(a, b)


def test_defaults_are_chol_and_highest():
    args = _t_args(_instance(2), F32)
    plain = qps.solve_mpc_qp(*args)
    explicit = qps.solve_mpc_qp(*args, linsolve="chol",
                                ipm_precision="highest")
    for a, b in zip(plain[:-1], explicit[:-1]):
        assert torch.equal(a, b)


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
        qps.solve_mpc_qp(*_t_args(_instance(0), F32), ipm_precision="high")
    finally:
        qps._factor = real
    assert set(seen) == {before} and _tf32_state() == before


@pytest.mark.parametrize("prec", ["high", "default"])
def test_loop_precision_on_a_card_restores_the_pinned_state(prec):
    """The context the loop runs in, as on a CUDA tensor: TF32 allowed
    inside, the pinned state back after, also when the loop raises."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    pinned = _tf32_state()
    with qps._loop_precision(prec, F32, "cuda"):
        assert _tf32_state() == (True, "high")
    assert _tf32_state() == pinned
    with pytest.raises(RuntimeError, match="in the loop"):
        with qps._loop_precision(prec, F32, "cuda"):
            raise RuntimeError("in the loop")
    assert _tf32_state() == pinned
    for args in (("highest", F32, "cuda"), (prec, F64, "cuda"),
                 (prec, F32, "cpu")):
        with qps._loop_precision(*args):
            assert _tf32_state() == pinned


def test_inv_matches_the_jax_inv_solve_on_a_vmapped_batch():
    """A batch of the bench's QPs (H = 30, n = 60) in float64 against the
    JAX solver's inv path under vmap."""
    P, q, G, h1, A, b, pss, qs = _mpc_qps(30, batch=4)
    inv = qps.solve_mpc_qp(P, q, G, h1, A, b, pss, qs, linsolve="inv")
    solve = jax.vmap(lambda qq, hh, aa, bb: j_solve(
        jnp.asarray(P.numpy()), qq, jnp.asarray(G.numpy()), hh, aa, bb,
        pss, qs, linsolve="inv"))
    jinv = solve(*(jnp.asarray(t.numpy()) for t in (q, h1, A, b)))
    assert bool(inv.converged.all()) and bool(np.all(jinv.converged))
    np.testing.assert_allclose(inv.u.numpy(), np.asarray(jinv.u), atol=1e-6)
