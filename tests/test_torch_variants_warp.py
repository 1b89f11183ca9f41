"""PyTorch port: the warp path of the kernel benchmark's variants, on the CPU.

What the CPU can hold of a kernel that runs on the card only: the plain
versions and the launch's plan.

* `select_rounds_plain` for N <= 1024 is the pass count of
  `radix_select_plain` (the torch replay of the warp path's select) on
  the projections rebuilt in the kernel's order; `_warp_sum_order`
  follows the kernel's register map (register r of lane l holds sample
  64 (r // 2) + 2 l + (r % 2)), checked against a literal loop.
* The 3-ary bisection of the plain versions leaves when ALL rows are
  frozen, a warp of the kernel when ITS row is; both freeze a finished
  row's state, so row by row and all at once agree bit for bit.
* The plan that `drcvar_variant` and `select_rounds` hand their C entry
  points is `halfspace_plan`'s, on a grid of (N, alignment): the launch
  is intercepted, the tensors live on the meta device.
"""

import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.core.risk import (
    cvar_k)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    _build, cuda_kernels as ck, cuda_variants as cv)

torch.set_num_threads(1)


def _rows(B, N, seed):
    rng = np.random.default_rng(seed)
    x = np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(B, N, 2))
    return (torch.as_tensor(x, dtype=torch.float32),
            torch.as_tensor(0.1 * rng.normal(size=(B, 2)),
                            dtype=torch.float32))


@pytest.mark.parametrize("N", [20, 65, 1000])
def test_warp_sum_order_follows_the_register_map(N):
    rng = np.random.default_rng(N)
    v = np.asarray(rng.normal(size=(3, N)), np.float32)
    values = ck.halfspace_plan(3, N, True).values_per_lane
    want = []
    for row in v:
        lanes = []
        for lane in range(32):
            acc = np.float32(0.0)
            for r in range(values):
                i = 64 * (r // 2) + 2 * lane + (r % 2)
                if i < N:
                    acc = np.float32(acc + row[i])
            lanes.append(acc)
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[l] + lanes[l ^ o]) for l in range(32)]
        assert len(set(lanes)) == 1          # every lane holds the sum
        want.append(lanes[0])
    got = cv._warp_sum_order(torch.as_tensor(v), values)
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    np.testing.assert_allclose(got.numpy(), v.astype(np.float64).sum(-1),
                               atol=1e-4)


@pytest.mark.parametrize("N", [20, 64, 65, 999, 1000, 1024])
def test_select_rounds_plain_is_the_replay_of_the_production_select(N):
    """The passes come from `radix_select_plain` on the rebuilt
    projections, padded with -inf to the warp's slots as the kernel
    holds them; rows of constant samples (every key tied) run all four."""
    s, e = _rows(24, N, N)
    s[:4] = torch.round(s[:4] * 4) / 4          # repeated samples
    s[4:8] = s[4:8, :1]                          # constant rows
    rounds = cv.select_rounds_plain(s, e, cv.ALPHA)
    assert rounds.dtype == torch.int32 and rounds.shape == (24,)
    values = ck.halfspace_plan(24, N, True).values_per_lane
    inv_n = torch.tensor(1.0 / N, dtype=torch.float32)
    dx = cv._warp_sum_order(s[..., 0] - e[:, :1], values) * inv_n
    dy = cv._warp_sum_order(s[..., 1] - e[:, 1:], values) * inv_n
    hx, hy = cv._unit_normal(dx, dy)
    mx, my = e[:, 0] + dx, e[:, 1] + dy
    x = ((mx[:, None] - s[..., 0]) * hx[:, None]
         + (my[:, None] - s[..., 1]) * hy[:, None])
    k = cvar_k(N, cv.ALPHA)
    kth, passes = ck.radix_select_plain(x, k)
    assert torch.equal(rounds, passes.to(torch.int32))
    assert torch.equal(kth, torch.kthvalue(x, N - k + 1, dim=-1).values)
    pad = torch.nn.functional.pad(x, (0, 32 * values - N),
                                  value=float("-inf"))
    assert torch.equal(rounds, ck.radix_select_plain(pad, k)[1].int())
    assert rounds[4:8].tolist() == [4] * 4
    assert 1 <= int(rounds.min()) and int(rounds.max()) <= 4
    # The projections are the composed closed form's to rounding.
    ref = -(((s - e[:, None, :]) - (s - e[:, None, :]).mean(1, keepdim=True))
            * torch.stack([hx, hy], -1)[:, None, :]).sum(-1)
    torch.testing.assert_close(x, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["r3", "fixed12", "fixed22"])
def test_bisection_row_by_row_equals_all_rows_at_once(variant):
    """The plain bisection leaves when all rows are frozen, the warp
    kernel when its own row is: frozen rows keep their state, so the
    results agree bit for bit (rows that freeze after 1 round beside
    rows that need many)."""
    s, e = _rows(12, 300, 7)
    s[:3] = s[:3, :1]                            # constant: frozen at once
    s[3:6] = torch.round(s[3:6] * 8) / 8         # ties
    together = cv.drcvar_variant(s, e, variant)
    for i in range(12):
        alone = cv.drcvar_variant(s[i:i + 1], e[i:i + 1], variant)
        assert torch.equal(alone.h, together.h[i:i + 1])
        assert torch.equal(alone.g_tilde, together.g_tilde[i:i + 1])


@pytest.mark.parametrize("offset", [0, 2, 4])
@pytest.mark.parametrize("N", [1, 20, 64, 65, 999, 1000, 1024, 1025, 4096])
def test_variant_entry_points_get_the_plan_of_halfspace_plan(monkeypatch, N,
                                                             offset):
    """`offset` floats into the storage: 0 and 4 start on 16 bytes, 2 on
    8, which with an odd N decides the width of the loads."""
    calls = []
    monkeypatch.setattr(ck, "_check_f32_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda entry, device, *args: calls.append(
                            (entry, args)))
    B = 5
    flat = torch.empty(B * N * 2 + offset, device="meta")
    samples = flat[offset:].view(B, N, 2)
    ego = torch.empty((B, 2), device="meta")
    aligned = (4 * offset) % 16 == 0
    assert (samples.data_ptr() % 16 == 0) == aligned
    plan = ck.halfspace_plan(B, N, aligned)
    assert plan.entry == ("warp" if N <= 1024 else "block")
    assert plan.load_bytes == (16 if aligned and N % 2 == 0 else 8) or \
        plan.entry == "block"
    want = (plan.values_per_lane, plan.rows_per_block, plan.load_bytes)

    before = cv.drcvar_variant.launches, cv.select_rounds.launches
    cv.drcvar_variant(samples, ego, "r3")
    cv.select_rounds(samples, ego, cv.ALPHA)
    cv.minimal_planes(samples, ego)
    (e1, a1), (e2, a2), (e3, a3) = calls
    assert e1 == "drcvar_variant" and e2 == "drcvar_select_rounds"
    # (samples, ego, h, g, B, N, k, code, rounds, plan..., floats...)
    assert a1[4:9] == (B, N, cvar_k(N, cv.ALPHA), 2, 22)
    assert a1[9:12] == want
    # (samples, ego, out, B, N, k, plan..., 1 / N)
    assert a2[3:6] == (B, N, cvar_k(N, cv.ALPHA)) and a2[6:9] == want
    # minimal_planes: a block a row whatever N
    assert e3 == "drcvar_variant" and a3[7] == 5 and a3[9:12] == (0, 1, 8)
    assert (cv.drcvar_variant.launches, cv.select_rounds.launches) == \
        (before[0] + 1, before[1] + 1)
    cv.drcvar_variant.launches, cv.select_rounds.launches = before
    cv.minimal_planes.launches -= 1
