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
