"""PyTorch port: the batched Cholesky solve's plain form against the JAX
Pallas kernel in interpret mode (float32), at the shapes of
tests/test_pallas_linalg.py (k = 65 included) with its tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_linalg import (
    batched_cho_solve as j_solve)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_linalg as cl)

from test_torch_linalg import _spd_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("B,n,k", [(4, 60, 0), (2, 60, 5), (3, 64, 65),
                                   (5, 33, 0)])
def test_cho_solve_plain_matches_pallas(B, n, k):
    rng = np.random.default_rng(1)
    S = _spd_batch(rng, B, n)
    L = np.linalg.cholesky(S.astype(np.float64)).astype(np.float32)
    shape = (B, n) if k == 0 else (B, n, k)
    r = rng.normal(size=shape).astype(np.float32)
    x = cl.batched_cho_solve(torch.as_tensor(L), torch.as_tensor(r))
    x_ref = j_solve(jnp.asarray(L), jnp.asarray(r), interpret=True)
    assert x.shape == shape
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=3e-4,
                               atol=3e-4)


# 1e-5 relative in norm, float32 on both sides: the Pallas kernel
# substitutes column by column with a division a row, LAPACK's blocked
# triangular solves sum the same products in another order.
RTOL = 1e-5


@pytest.mark.parametrize("n,k", [(1, 1), (2, 2), (33, 1), (33, 33),
                                 (60, 1), (60, 2), (60, 33), (60, 65),
                                 (64, 1), (64, 65)])
def test_cho_solve_matches_pallas_over_sizes(n, k):
    """The wrapper (on the CPU it is the plain version) against the JAX
    kernel in interpret mode: sizes on both sides of 32, the MPC's 60
    and 64, and right-hand side counts on both sides of the CUDA
    kernels' threshold; k = 1 as a [B, n] vector and as [B, n, 1]."""
    rng = np.random.default_rng(100 * n + k)
    S = _spd_batch(rng, 3, n)
    L = np.linalg.cholesky(S.astype(np.float64)).astype(np.float32)
    r = rng.normal(size=(3, n, k)).astype(np.float32)
    x = cl.batched_cho_solve(torch.as_tensor(L), torch.as_tensor(r))
    assert torch.equal(x, cl.batched_cho_solve_plain(torch.as_tensor(L),
                                                     torch.as_tensor(r)))
    x_ref = np.asarray(j_solve(jnp.asarray(L), jnp.asarray(r),
                               interpret=True), np.float64)
    assert x.shape == (3, n, k) and x.dtype == torch.float32
    rel = np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < RTOL, rel
    if k == 1:
        vec = cl.batched_cho_solve(torch.as_tensor(L),
                                   torch.as_tensor(r[:, :, 0]))
        assert vec.shape == (3, n)
        assert torch.equal(vec, x[:, :, 0])
