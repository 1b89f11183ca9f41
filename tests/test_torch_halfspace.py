"""PyTorch port: the halfspace closed forms, the all-metrics kernel's plain
form and the environment, against the JAX package.

* closed forms against the JAX closed forms in float64, to 1e-10;
* the kernel's plain form against the JAX Pallas kernels in interpret
  mode, in float32: h to 1e-5, g to atol 2e-4 / rtol 1e-5 (the bound
  tests/test_evaluation.py holds the Pallas kernel to);
* the k-th value bit-equal to JAX's radix select (-0.0 == +0.0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    halfspace as jhs)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
    fused_drcvar_halfspace, fused_metric_halfspaces)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
    environment as jenv)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.risk import (
    cvar_k)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck, halfspace as ths)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    environment as tenv)

from torch_port_streams import adversarial_samples

torch.set_num_threads(1)

ALPHA, DELTA, EPS, RR, RO = 0.2, 0.1, 0.15, 0.3, 0.3


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(ours, theirs, atol, rtol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", ["normal", "ties", "near_ego",
                                  "constant"])
@pytest.mark.parametrize("alpha", [0.2, 0.1, 0.5])
def test_closed_forms_match_jax_f64(case, alpha):
    rng = np.random.default_rng(0)
    x = np.asarray(adversarial_samples(case, rng, 5, 40), np.float64)
    ego = rng.normal(size=(5, 2))
    if case == "near_ego":
        ego = 5.0 + 1e-3 * rng.normal(size=(5, 2))
    if case == "constant":
        ego[0] = x[0, 0]          # degenerate normal -> [1, 0] fallback
    tx, te, jx, je = _t(x), _t(ego), jnp.asarray(x), jnp.asarray(ego)
    pairs = [
        (ths.mean_halfspace(tx, RR, RO), jhs.mean_halfspace(jx, RR, RO)),
        (ths.cvar_halfspace(tx, te, alpha, DELTA, RR, RO),
         jhs.cvar_halfspace(jx, je, alpha, DELTA, RR, RO)),
        (ths.dr_cvar_halfspace(tx, te, alpha, DELTA, EPS, RR, RO),
         jhs.dr_cvar_halfspace(jx, je, alpha, DELTA, EPS, RR, RO)),
    ]
    for ours, theirs in pairs:
        _close(ours.h, theirs.h, 1e-10)
        _close(ours.g_tilde, theirs.g_tilde, 1e-10)
    if case == "constant":
        assert pairs[1][0].h[0].tolist() == [1.0, 0.0]


def _check_plain_vs_pallas(x, ego, alpha):
    """Plain form (float32, CPU) against both Pallas kernels (interpret)."""
    tx, te = _t(x, torch.float32), _t(ego, torch.float32)
    jx, je = jnp.asarray(x, jnp.float32), jnp.asarray(ego, jnp.float32)
    ours = ck.all_metrics_halfspaces(tx, te, alpha, DELTA, EPS, RR, RO)
    theirs = fused_metric_halfspaces(jx, je, alpha, DELTA, EPS, RR, RO,
                                     interpret=True)
    for name, a, b in zip(ours._fields, ours, theirs):
        if name.startswith("h"):
            _close(a, b, 1e-5)
        else:
            _close(a, b, 2e-4, 1e-5)
    h_d, g_d = fused_drcvar_halfspace(jx, je, alpha, DELTA, EPS, RR, RO,
                                      interpret=True)
    _close(ours.h, h_d, 1e-5)
    _close(ours.g_drcvar, g_d, 2e-4, 1e-5)


@pytest.mark.parametrize("case", ["ties", "constant", "outlier", "negative",
                                  "laplace", "alpha_mid"])
def test_plain_matches_pallas_adversarial(case):
    rng = np.random.default_rng(7)
    alpha = 0.5 if case == "alpha_mid" else ALPHA
    x = adversarial_samples(case, rng, 8, 64)
    _check_plain_vs_pallas(x, rng.normal(size=(8, 2)), alpha)


@pytest.mark.parametrize("B,N", [(4, 4096), (11, 50), (13, 1001), (3, 20)])
def test_plain_matches_pallas_sizes(B, N):
    rng = np.random.default_rng(23)
    x = np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(B, N, 2))
    _check_plain_vs_pallas(x, 0.1 * rng.normal(size=(B, 2)), ALPHA)


@pytest.mark.parametrize("case", ["normal", "ties", "negative", "zeros",
                                  "constant"])
@pytest.mark.parametrize("N,alpha", [(20, 0.2), (1000, 0.2), (64, 0.5),
                                     (33, 0.1)])
def test_kth_value_bit_equal_to_jax_radix_select(case, N, alpha):
    rng = np.random.default_rng(11)
    if case == "ties":
        x = rng.choice(np.asarray([-1.0, 0.0, 0.25, 2.0]), size=(6, N))
    elif case == "negative":
        x = -10.0 + 0.1 * rng.normal(size=(6, N))
    elif case == "zeros":      # mixed signed zeros
        x = rng.choice(np.asarray([-0.0, 0.0, 1.0]), size=(6, N))
    elif case == "constant":
        x = np.broadcast_to(rng.normal(size=(6, 1)), (6, N))
    else:
        x = rng.normal(size=(6, N))
    x = np.asarray(x, np.float32)
    k = cvar_k(N, alpha)
    ours = ck.kth_largest(torch.as_tensor(x), k).numpy()
    theirs = np.asarray(jhs.kth_largest_radix_select(jnp.asarray(x), k))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)   # -0.0 == +0.0


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(5, 30, 2)), torch.float32)
    ego = _t(rng.normal(size=(5, 2)), torch.float32)
    before = (ck.all_metrics_halfspaces.launches, ck.kth_largest.launches)
    out = ck.all_metrics_halfspaces(x, ego, ALPHA, DELTA, EPS, RR, RO)
    plain = ck.all_metrics_halfspaces_plain(x, ego, ALPHA, DELTA, EPS, RR,
                                            RO)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    ck.kth_largest(x[..., 0], 4)
    assert (ck.all_metrics_halfspaces.launches,
            ck.kth_largest.launches) == before == (0, 0)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """Off the CPU the wrapper takes the kernel or raises (checked here
    on the `meta` device, which no kernel runs on)."""
    x = torch.zeros((4, 16, 2), dtype=torch.float64, device="meta")
    ego = torch.zeros((4, 2), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError):
        ck.all_metrics_halfspaces(x, ego, ALPHA, DELTA, EPS, RR, RO)
    with pytest.raises(ValueError, match="CUDA"):
        ck.all_metrics_halfspaces(x.float(), ego.float(), ALPHA, DELTA, EPS,
                                  RR, RO)
    too_wide = torch.zeros((1, ck.MAX_N_SAMPLES + 1, 2), device="meta")
    with pytest.raises(ValueError, match="samples per row"):
        ck.all_metrics_halfspaces(too_wide, ego[:1].float(), ALPHA, DELTA,
                                  EPS, RR, RO)
    assert ck.all_metrics_halfspaces.launches == 0


def _env_pair(horizon):
    kw = dict(robot_radius=RR, obstacle_radius=RO, horizon=horizon, dt=0.2,
              alpha=ALPHA, delta=DELTA, epsilon=EPS)
    return (tenv.Environment(**kw, dtype=torch.float64, device="cpu"),
            jenv.Environment(**kw, dtype=jnp.float64))


@pytest.mark.parametrize("T1,horizon", [(7, 6), (4, 6)])
def test_environment_halfspaces_and_distances_match_jax(T1, horizon):
    """Batched [S, n_steps, n_obs] halfspaces (with the n_steps clamp to
    the obstacle data when sim_time < horizon) and distances."""
    rng = np.random.default_rng(4)
    S, n_obs, N = 2, 3, 20
    samples = rng.normal(size=(S, n_obs, N, T1, 2))
    x_ref = np.cumsum(rng.normal(size=(S, horizon + 1, 4)), axis=1)
    real = rng.normal(size=(S, n_obs, T1, 2))
    tenv_, jenv_ = _env_pair(horizon)
    hs = tenv.compute_safe_halfspaces_for_trajectory(tenv_, _t(samples),
                                                     _t(x_ref))
    n_steps = min(horizon + 1, horizon, T1)
    assert hs.mean.h.shape == (S, n_steps, n_obs, 2)
    for s in range(S):
        ref = jenv.compute_safe_halfspaces_for_trajectory(
            jenv_, jnp.asarray(samples[s]), jnp.asarray(x_ref[s]),
            use_pallas=False)
        for m in ("mean", "cvar", "dr_cvar"):
            _close(hs.by_metric(m).h[s], ref.by_metric(m).h, 1e-10)
            _close(hs.by_metric(m).g_tilde[s], ref.by_metric(m).g_tilde,
                   1e-10)
        d_ref = jenv.compute_distance_to_collision(
            jenv_, jnp.asarray(x_ref[s]), jnp.asarray(real[s]))
        d = tenv.compute_distance_to_collision(tenv_, _t(x_ref), _t(real))
        _close(d[s], d_ref, 1e-12)
