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
