"""PyTorch port: the DR-CVaR solve API against the JAX package.

* `fused_drcvar_halfspace` on a CPU tensor (its plain version, the
  composed closed form) against the JAX Pallas kernel
  `ops.pallas_kernels.fused_drcvar_halfspace` in interpret mode, in
  float32: h to 1e-5, g to atol 2e-4 / rtol 1e-5 (the bound the kernel
  is held to on the card);
* `dr_cvar_g_star` / `cvar_g_star`, the closed forms for a given normal,
  against the JAX closed forms in float64, to 1e-10;
* the wrapper's dispatch: the plain version on a CPU tensor with no
  launch counted, and a raise off the CPU on what the kernel does not
  take (checked on the `meta` device, where no kernel runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    halfspace as jhs, pallas_kernels as jpk)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck, halfspace as ths)

from torch_port_streams import adversarial_samples

torch.set_num_threads(1)

ALPHA, DELTA, EPS, RR, RO = 0.2, 0.1, 0.15, 0.3, 0.3


def _check_against_pallas(x, ego, alpha):
    tx = torch.as_tensor(np.asarray(x), dtype=torch.float32)
    te = torch.as_tensor(np.asarray(ego), dtype=torch.float32)
    h, g = ck.fused_drcvar_halfspace(tx, te, alpha, DELTA, EPS, RR, RO)
    jh, jg = jpk.fused_drcvar_halfspace(
        jnp.asarray(x, jnp.float32), jnp.asarray(ego, jnp.float32), alpha,
        DELTA, EPS, RR, RO, interpret=True)
    assert h.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=2e-4)


@pytest.mark.parametrize("case", ["ties", "constant", "outlier", "negative",
                                  "laplace", "alpha_mid"])
def test_drcvar_plain_matches_pallas_adversarial(case):
    rng = np.random.default_rng(17)
    alpha = 0.5 if case == "alpha_mid" else ALPHA
    x = adversarial_samples(case, rng, 8, 64)
    _check_against_pallas(x, rng.normal(size=(8, 2)), alpha)


@pytest.mark.parametrize("B,N", [(3, 20), (13, 1001), (4, 4096)])
def test_drcvar_plain_matches_pallas_sizes(B, N):
    rng = np.random.default_rng(B * N)
    x = np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(B, N, 2))
    _check_against_pallas(x, 0.1 * rng.normal(size=(B, 2)), ALPHA)


def test_drcvar_equals_all_metrics_drcvar_outputs_on_cpu():
    """The DR-CVaR solve is the all-metrics solve's (h, g_drcvar)."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(6, 50, 2)), dtype=torch.float32)
    e = torch.as_tensor(rng.normal(size=(6, 2)), dtype=torch.float32)
    h, g = ck.fused_drcvar_halfspace(x, e, ALPHA, DELTA, EPS, RR, RO)
    allm = ck.all_metrics_halfspaces(x, e, ALPHA, DELTA, EPS, RR, RO)
    assert torch.equal(h, allm.h) and torch.equal(g, allm.g_drcvar)


def test_drcvar_is_exported_with_the_jax_name():
    assert pt.ops.fused_drcvar_halfspace is ck.fused_drcvar_halfspace
    assert pt.ops.dr_cvar_g_star is ths.dr_cvar_g_star
    assert pt.ops.cvar_g_star is ths.cvar_g_star


@pytest.mark.parametrize("case", ["normal", "ties", "near_ego", "constant"])
@pytest.mark.parametrize("alpha", [0.2, 0.05, 0.5])
def test_g_star_closed_forms_match_jax_f64(case, alpha):
    rng = np.random.default_rng(31)
    x = np.asarray(adversarial_samples(case, rng, 5, 40), np.float64)
    h = rng.normal(size=(5, 2))
    h[0] = [1.0, 1.0] / np.sqrt(2.0)
    h[1] *= 3.0                       # a normal that is not unit: r~ scales
    tx, th = torch.as_tensor(x), torch.as_tensor(h)
    jx, jh = jnp.asarray(x), jnp.asarray(h)
    g_star, g_tilde = ths.dr_cvar_g_star(tx, th, alpha, DELTA, EPS, RR, RO)
    jg_star, jg_tilde = jhs.dr_cvar_g_star(jx, jh, alpha, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(g_star.numpy(), np.asarray(jg_star),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(g_tilde.numpy(), np.asarray(jg_tilde),
                               rtol=0, atol=1e-10)
    cvar = ths.cvar_g_star(tx, th, alpha, DELTA, RR, RO)
    np.testing.assert_allclose(
        cvar.numpy(), np.asarray(jhs.cvar_g_star(jx, jh, alpha, DELTA, RR,
                                                  RO)), rtol=0, atol=1e-10)


def test_g_star_with_one_normal_for_a_batch():
    """The timing sweep's call: one h [2] for a batch [B, N, 2]."""
    rng = np.random.default_rng(2)
    x = np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(7, 30, 2))
    h = np.array([1.0, 1.0]) / np.sqrt(2.0)
    ours, _ = ths.dr_cvar_g_star(torch.as_tensor(x), torch.as_tensor(h),
                                 ALPHA, DELTA, EPS, RR, RO)
    theirs, _ = jhs.dr_cvar_g_star(jnp.asarray(x), jnp.asarray(h), ALPHA,
                                   DELTA, EPS, RR, RO)
    assert ours.shape == (7,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-10)


def test_drcvar_cpu_dispatch_counts_no_launch():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(5, 30, 2)), dtype=torch.float32)
    e = torch.as_tensor(rng.normal(size=(5, 2)), dtype=torch.float32)
    before = ck.fused_drcvar_halfspace.launches
    out = ck.fused_drcvar_halfspace(x, e, ALPHA, DELTA, EPS, RR, RO)
    plain = ck.fused_drcvar_halfspace_plain(x, e, ALPHA, DELTA, EPS, RR, RO)
    assert torch.equal(out.h, plain.h) and torch.equal(out.g_tilde,
                                                       plain.g_tilde)
    assert ck.fused_drcvar_halfspace.launches == before == 0


def test_drcvar_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 16, 2), device="meta")
    ego = torch.zeros((4, 2), device="meta")
    args = (ALPHA, DELTA, EPS, RR, RO)
    with pytest.raises(TypeError):
        ck.fused_drcvar_halfspace(x.double(), ego, *args)
    with pytest.raises(ValueError, match="CUDA"):
        ck.fused_drcvar_halfspace(x, ego, *args)
    with pytest.raises(ValueError, match=r"\[B, N, 2\]"):
        ck.fused_drcvar_halfspace(x[..., :1], ego, *args)
    too_wide = torch.zeros((1, ck.MAX_N_SAMPLES + 1, 2), device="meta")
    with pytest.raises(ValueError, match="samples per row"):
        ck.fused_drcvar_halfspace(too_wide, ego[:1], *args)
    assert ck.fused_drcvar_halfspace.launches == 0
