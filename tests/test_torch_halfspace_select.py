"""PyTorch port: the warp path of the halfspace kernels, as far as the CPU
reaches it.

* `radix_select_plain`, the torch replay of the kernels' per-warp radix
  select (int64 keys, early exit when the chosen bin holds one key),
  bit-equal to `torch.kthvalue` and to the JAX package's radix select;
* `halfspace_plan`, the pure function that decides which kernel a
  (B, N, alignment) takes, over a grid;
* the wrappers refuse what the kernels do not take (on the `meta`
  device, which no kernel runs on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    halfspace as jhs)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.risk import (
    cvar_k)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck)

from torch_port_streams import adversarial_samples

torch.set_num_threads(1)

ALPHA, DELTA, EPS, RR, RO = 0.2, 0.1, 0.15, 0.3, 0.3
SIZES = [1, 20, 33, 1000, 1001, 1024, 1025, 4096]


def _ranks(N):
    return sorted({1, cvar_k(N, ALPHA), N})


def _assert_select(x):
    """The replay against torch.kthvalue and the JAX radix select, at
    k = 1, ceil(alpha N) and N; returns the passes of the middle rank."""
    x = np.ascontiguousarray(x, np.float32)
    N = x.shape[1]
    tx = torch.as_tensor(x)
    for k in _ranks(N):
        ours, passes = ck.radix_select_plain(tx, k)
        assert ours.dtype == torch.float32
        ref = torch.kthvalue(tx, N - k + 1, dim=-1).values
        assert torch.equal(ours, ref), (N, k)        # -0.0 == +0.0
        theirs = np.asarray(jhs.kth_largest_radix_select(jnp.asarray(x), k))
        np.testing.assert_array_equal(ours.numpy(), theirs)
        assert 1 <= int(passes.min()) and int(passes.max()) <= 4
    return ck.radix_select_plain(tx, cvar_k(N, ALPHA))[1]


@pytest.mark.parametrize("N", SIZES)
def test_select_replay_bit_equal_on_gaussian_rows(N):
    rng = np.random.default_rng(N)
    _assert_select(rng.normal(size=(6, N)))


@pytest.mark.parametrize("case", ["ties", "constant", "outlier", "negative",
                                  "laplace", "near_ego"])
@pytest.mark.parametrize("N", [20, 64, 1000])
def test_select_replay_bit_equal_on_adversarial_rows(case, N):
    rng = np.random.default_rng(7)
    vals = adversarial_samples(case, rng, 8, N)
    _assert_select(vals[..., 0])
    # The kernels select among doubly-centred projections: centre them.
    _assert_select(vals[..., 1] - vals[..., 1].mean(1, keepdims=True))


@pytest.mark.parametrize("N", [1, 20, 33, 1000, 1025])
def test_select_replay_signed_zeros_and_infinities(N):
    rng = np.random.default_rng(N + 1)
    zeros = rng.choice(np.asarray([-0.0, 0.0, 1.0, -1.0], np.float32),
                       size=(6, N))
    _assert_select(zeros)
    mixed = rng.normal(size=(6, N)).astype(np.float32)
    mixed[:, ::3] = np.inf
    mixed[:, 1::5] = -np.inf
    _assert_select(mixed)


def test_select_replay_leaves_early_and_ties_take_four_passes():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 1000)).astype(np.float32)
    passes = _assert_select(x)
    assert float(passes.float().mean()) < 3.5      # continuous data leave
    constant = np.full((3, 50), 0.25, np.float32)  # all keys tied
    assert _assert_select(constant).tolist() == [4, 4, 4]
    alone = np.asarray([[3.0, -1.0, 2.0 ** -130, -2.0]], np.float32)
    value, passes = ck.radix_select_plain(torch.as_tensor(alone), 1)
    assert value.tolist() == [3.0] and passes.tolist() == [1]


def test_key_map_is_monotone_and_inverts():
    x = torch.tensor([-np.inf, -2.5, -1e-40, -0.0, 0.0, 1e-40, 0.3, np.inf],
                     dtype=torch.float32)
    keys = ck.float_keys(x)
    assert bool((keys[1:] > keys[:-1]).all())
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    back = ck.key_floats(keys)
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("N,values", [(1, 2), (20, 2), (64, 2), (65, 4),
                                      (128, 4), (129, 8), (256, 8),
                                      (257, 16), (512, 16), (513, 32),
                                      (999, 32), (1000, 32), (1024, 32)])
@pytest.mark.parametrize("B", [0, 1, 4, 5, 23040])
def test_plan_warp_path(B, N, values):
    for aligned in (True, False):
        plan = ck.halfspace_plan(B, N, aligned)
        assert plan.entry == "warp"
        assert plan.values_per_lane == values
        assert 32 * values >= N and (values == 2 or 16 * values < N)
        assert plan.rows_per_block == ck.WARP_ROWS_PER_BLOCK
        assert plan.threads == 32 * plan.rows_per_block <= 256
        assert plan.smem_bytes == plan.rows_per_block * 1024   # counters
        # 16-byte loads need every row's base aligned: even N, aligned start.
        assert plan.load_bytes == (16 if aligned and N % 2 == 0 else 8)


@pytest.mark.parametrize("N", [1025, 1026, 4096, ck.MAX_N_SAMPLES])
@pytest.mark.parametrize("B", [0, 1, 7])
def test_plan_block_path(B, N):
    for aligned in (True, False):
        plan = ck.halfspace_plan(B, N, aligned)
        assert plan == ck.HalfspacePlan("block", 0, 1, 256, 4 * N, 8)
        assert plan.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("B,N", [(1, 0), (1, ck.MAX_N_SAMPLES + 1), (-1, 20)])
def test_plan_refuses_what_no_kernel_takes(B, N):
    with pytest.raises(ValueError):
        ck.halfspace_plan(B, N, True)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU a wrapper takes its kernel or raises."""
    x = torch.zeros((4, 16, 2), device="meta")
    ego = torch.zeros((4, 2), device="meta")
    for fn in (ck.all_metrics_halfspaces, ck.fused_drcvar_halfspace):
        with pytest.raises(TypeError):
            fn(x.double(), ego, ALPHA, DELTA, EPS, RR, RO)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, ego, ALPHA, DELTA, EPS, RR, RO)
        with pytest.raises(ValueError, match=r"\[B, N, 2\]"):
            fn(x[..., 0], ego, ALPHA, DELTA, EPS, RR, RO)
        wide = torch.zeros((1, ck.MAX_N_SAMPLES + 1, 2), device="meta")
        with pytest.raises(ValueError, match="samples per row"):
            fn(wide, ego[:1], ALPHA, DELTA, EPS, RR, RO)
    keys = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ck.kth_largest(keys, 3)
    with pytest.raises(TypeError):
        ck.kth_largest(keys.double(), 3)
    for k in (0, 17):
        with pytest.raises(ValueError, match="1 <= k <= N"):
            ck.kth_largest(keys, k)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        ck.kth_largest(x, 1)
    assert (ck.all_metrics_halfspaces.launches,
            ck.fused_drcvar_halfspace.launches,
            ck.kth_largest.launches) == (0, 0, 0)
