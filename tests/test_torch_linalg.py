"""PyTorch port: the batched Cholesky plain form against the JAX Pallas
kernel in interpret mode (float32), at the shapes of
tests/test_pallas_linalg.py with its tolerances; dtype and device
rules of the kernel wrappers.  The solve is in test_torch_linalg_solve.py
(its interpret-mode reference is slow, so xdist runs it on another
worker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_linalg import (
    batched_cholesky as j_chol)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_linalg as cl)

torch.set_num_threads(1)


def _spd_batch(rng, B, n):
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", A, A)
            + 3.0 * np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("B,n", [(1, 60), (5, 60), (3, 64), (4, 17)])
def test_cholesky_plain_matches_pallas(B, n):
    S = _spd_batch(np.random.default_rng(0), B, n)
    L = cl.batched_cholesky(torch.as_tensor(S))
    L_ref = j_chol(jnp.asarray(S), interpret=True)
    assert L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=2e-5,
                               atol=2e-5)
    assert np.abs(np.triu(L.numpy(), k=1)).max() == 0.0


def test_plain_float64_and_not_positive_definite():
    """The CPU plain forms take float64 (the port's f64 path), and a
    matrix that is not positive definite factors to NaN, as the JAX
    factorisation does (the IPM's breakdown test reads it)."""
    rng = np.random.default_rng(2)
    S = torch.as_tensor(_spd_batch(rng, 3, 12), dtype=torch.float64)
    S[1] = -S[1]
    L = cl.batched_cholesky(S)
    assert L.dtype == torch.float64
    assert torch.isnan(L[1]).all() and torch.isfinite(L[[0, 2]]).all()
    r = torch.as_tensor(rng.normal(size=(3, 12)))
    x = cl.batched_cho_solve(L[[0, 2]], r[[0, 2]])
    np.testing.assert_allclose((S[[0, 2]] @ x[..., None])[..., 0].numpy(),
                               r[[0, 2]].numpy(), atol=1e-10)
    assert (cl.batched_cholesky.launches,
            cl.batched_cho_solve.launches) == (0, 0)


def test_kernels_reject_non_f32():
    """The kernels are float32-only (as the Pallas kernels): off the CPU a
    float64 input raises TypeError instead of being cast, and anything
    but a CUDA tensor raises.  Checked on the `meta` device."""
    S64 = torch.zeros((2, 16, 16), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError):
        cl.batched_cholesky(S64)
    L32 = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(TypeError):
        cl.batched_cho_solve(L32, torch.zeros((2, 16), dtype=torch.float64,
                                              device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cl.batched_cholesky(L32)
    with pytest.raises(ValueError, match="CUDA"):
        cl.batched_cho_solve(L32, torch.zeros((2, 16), device="meta"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# 1e-5 relative in norm: both sides are float32 and sum the same
# products in another order (the Pallas kernel right-looking over
# 8-aligned blocks with 1 / sqrt, LAPACK blocked), so they differ by a
# few roundings of 6e-8 a term, not bit for bit.
RTOL = 1e-5


@pytest.mark.parametrize("n", [1, 2, 33, 60, 64])
def test_cholesky_matches_pallas_over_sizes(n):
    """The wrapper (on the CPU it is the plain version) against the JAX
    kernel in interpret mode, on sizes on both sides of 32 and at the
    MPC's 60 and 64."""
    S = _spd_batch(np.random.default_rng(n), 3, n)
    L = cl.batched_cholesky(torch.as_tensor(S))
    assert torch.equal(L, cl.batched_cholesky_plain(torch.as_tensor(S)))
    L_ref = np.asarray(j_chol(jnp.asarray(S), interpret=True))
    assert L.shape == (3, n, n) and L.dtype == torch.float32
    assert _rel(L.numpy(), L_ref) < RTOL
    assert np.abs(np.triu(L.numpy(), k=1)).max() == 0.0
    assert _rel(L.numpy() @ L.numpy().transpose(0, 2, 1), S) < RTOL


def test_not_positive_definite_in_a_batch():
    """A matrix that is not positive definite, mixed into a batch.  The
    plain version gives NaN in every entry of its factor; the JAX kernel
    gives NaN from the failing column on (the columns before it are
    finite) -- for -S that is the whole lower triangle.  The IPM's
    breakdown test needs less than either: a solve with that factor is
    not finite, so the lane's merit is not finite, and the other lanes
    are what they are without it."""
    rng = np.random.default_rng(4)
    S = _spd_batch(rng, 4, 12)
    bad = S.copy()
    bad[1] = -S[1]
    bad[2, 6, 6] = -1.0
    r = rng.normal(size=(4, 12)).astype(np.float32)
    good = [0, 3]

    L = cl.batched_cholesky(torch.as_tensor(bad))
    L_clean = cl.batched_cholesky(torch.as_tensor(S))
    assert torch.isnan(L[[1, 2]]).all()
    assert torch.equal(L[good], L_clean[good])
    x = cl.batched_cho_solve(L, torch.as_tensor(r))
    assert not torch.isfinite(x[[1, 2]]).any()
    assert torch.equal(x[good],
                       cl.batched_cho_solve(L_clean, torch.as_tensor(r))[good])

    jL = np.asarray(j_chol(jnp.asarray(bad), interpret=True))
    jL_clean = np.asarray(j_chol(jnp.asarray(S), interpret=True))
    assert np.isnan(np.tril(jL[1])[np.tril_indices(12)]).all()
    assert np.isfinite(jL[2][:, :6]).all() and np.isnan(jL[2][6:, 6:]).any()
    assert np.array_equal(jL[good], jL_clean[good])


F32, F64 = torch.float32, torch.float64
_OK = ("cuda", F32, (5, 60, 60), (3600, 60, 1))


@pytest.mark.parametrize("desc,error,match", [
    (("cuda", F64, (5, 60, 60), (3600, 60, 1)), TypeError, "float32"),
    (("meta", F32, (5, 60, 60), (3600, 60, 1)), ValueError, "CUDA"),
    (("cuda", F32, (5, 65, 65), (4225, 65, 1)), ValueError, "n <= 64"),
    (("cuda", F32, (5, 60, 59), (3540, 59, 1)), ValueError, r"\[B, n, n\]"),
    (("cuda", F32, (60, 60), (60, 1)), ValueError, r"\[B, n, n\]"),
    (("cuda", F32, (2, 5, 60, 60), (18000, 3600, 60, 1)), ValueError,
     r"\[B, n, n\]"),
    (("cuda", F32, (5, 60, 60), (3600, 1, 60)), ValueError, "contiguous"),
    (("cuda", F32, (5, 60, 60), (7200, 120, 2)), ValueError, "contiguous"),
])
def test_check_factor_refuses(desc, error, match):
    """What the kernels do not take, from device type, dtype, shape and
    strides alone (no card needed)."""
    assert cl.check_factor("S", *_OK) == (5, 60)
    with pytest.raises(error, match=match):
        cl.check_factor("S", *desc)


@pytest.mark.parametrize("r_desc,error,match", [
    (("cuda", F64, (5, 60), (60, 1)), TypeError, "float32"),
    (("cpu", F32, (5, 60), (60, 1)), ValueError, "CUDA"),
    (("cuda", F32, (5, 60, 257), (15420, 257, 1)), ValueError, "k <= 256"),
    (("cuda", F32, (5, 60, 0), (0, 0, 1)), ValueError, "1 <= k"),
    (("cuda", F32, (4, 60), (60, 1)), ValueError, r"\[5, 60\]"),
    (("cuda", F32, (5, 59, 3), (177, 3, 1)), ValueError, r"\[5, 60\]"),
    (("cuda", F32, (5,), (1,)), ValueError, r"\[B, n\] or \[B, n, k\]"),
    (("cuda", F32, (5, 60, 2, 2), (240, 4, 2, 1)), ValueError,
     r"\[B, n\] or \[B, n, k\]"),
    (("cuda", F32, (5, 60, 65), (3900, 1, 60)), ValueError, "contiguous"),
])
def test_check_solve_refuses(r_desc, error, match):
    assert cl.check_solve(_OK, ("cuda", F32, (5, 60), (60, 1))) == (5, 60, 1)
    assert cl.check_solve(_OK, ("cuda", F32, (5, 60, 65),
                                (3900, 65, 1))) == (5, 60, 65)
    assert cl.check_solve(_OK, ("cuda", F32, (5, 60, 256),
                                (15360, 256, 1))) == (5, 60, 256)
    with pytest.raises(error, match=match):
        cl.check_solve(_OK, r_desc)
    with pytest.raises(ValueError, match="n <= 64"):
        cl.check_solve(("cuda", F32, (5, 65, 65), (4225, 65, 1)),
                       ("cuda", F32, (5, 65), (65, 1)))


@pytest.mark.parametrize("shape", [(5, 60, 60), (1, 64, 64), (3, 1, 1),
                                   (4, 60, 1), (0, 8, 8)])
def test_is_contiguous_agrees_with_torch(shape):
    t = torch.zeros(shape)
    views = [t, t.transpose(-1, -2), t[..., ::2], t[:1], t[:, :1]]
    if t.dim() == 3:
        views.append(t.permute(1, 0, 2))
    for v in views:
        assert cl.is_contiguous(v.shape, v.stride()) == v.is_contiguous(), \
            (tuple(v.shape), v.stride())
