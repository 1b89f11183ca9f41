"""PyTorch port: the kernel benchmark's attribution variants.

* Each `drcvar_variant` plain version against the JAX harness
  `experiments.kbench.fused(variant=..., tile_b=8)`, and
  `minimal_planes` against `experiments.kbench.minimal_planes`, run in
  Pallas interpret mode (`pl.pallas_call` patched inside the test; the
  harness itself is unchanged), at B = 16, N = 300, float32: h to 1e-5,
  g to atol 2e-4 / rtol 1e-5.  `"prod"` goes through
  `pallas_kernels.fused_drcvar_halfspace(interpret=True)` directly.
* `select_rounds` has no JAX counterpart to agree with: the TPU function
  counts the trips of the TPU's moment-seeded select, the port's counts
  the passes of its own 8-bit radix select, and the two selects differ
  by design.  Its plain version is checked on rows whose answer is
  known, on both paths: for N <= 1024 the passes the warp path's select
  runs (tied keys run all four), for N > 1024 the first pass after which
  the k-th key's bucket holds only the k-th key.  The kernel is held to
  the plain version on the card (tests/test_torch_cuda.py); the warp
  path's order of sums and its plan are in
  tests/test_torch_variants_warp.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    pallas_kernels as jpk)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
    kbench as tkb)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_variants as cv)

torch.set_num_threads(1)

B, N, TILE = 16, 300, 8


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(12)
    x = np.asarray(np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(B, N, 2)),
                   np.float32)
    # One ego per 8-row tile: the TPU `minimal_planes` adds the first ego
    # x of its tile, the port the row's own; equal within a tile, they
    # agree.
    ego = np.repeat(0.1 * rng.normal(size=(B // TILE, 2)), TILE, axis=0)
    return x, np.asarray(ego, np.float32)


@pytest.fixture
def jax_kbench(monkeypatch):
    import experiments.kbench as jkb
    monkeypatch.setattr(jkb.pl, "pallas_call",
                        functools.partial(jkb.pl.pallas_call,
                                          interpret=True))
    return jkb


def _close(ours, theirs):
    h, g = ours
    jh, jg = theirs
    assert h.shape == (B, 2) and g.shape == (B,)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=2e-4)


@pytest.mark.parametrize("variant", ["prod_nosel", "nosel", "r3", "fixed12",
                                     "fixed22", "minimal"])
def test_variant_plain_matches_jax_kbench(rows, jax_kbench, variant):
    x, ego = rows
    ours = cv.drcvar_variant(torch.as_tensor(x), torch.as_tensor(ego),
                             variant)
    theirs = jax_kbench.fused(jnp.asarray(x), jnp.asarray(ego),
                              variant=variant, tile_b=TILE)
    _close(ours, theirs)


def test_prod_variant_matches_the_pallas_kernel(rows):
    x, ego = rows
    ours = cv.drcvar_variant(torch.as_tensor(x), torch.as_tensor(ego),
                             "prod")
    theirs = jpk.fused_drcvar_halfspace(
        jnp.asarray(x), jnp.asarray(ego), cv.ALPHA, cv.DELTA, cv.EPSILON,
        cv.R_COMBINED / 2, cv.R_COMBINED / 2, tile_b=TILE, interpret=True)
    _close(ours, theirs)


def test_minimal_planes_plain_matches_jax_kbench(rows, jax_kbench):
    x, ego = rows
    n_pad = 384                            # the TPU's 128-lane padding
    sx = np.zeros((B, n_pad), np.float32)
    sy = np.zeros((B, n_pad), np.float32)
    sx[:, :N], sy[:, :N] = x[..., 0], x[..., 1]
    ours = cv.minimal_planes(torch.as_tensor(x), torch.as_tensor(ego))
    theirs = jax_kbench.minimal_planes(jnp.asarray(sx), jnp.asarray(sy),
                                       jnp.asarray(ego), TILE, N)
    _close(ours, theirs)


def test_exact_variants_agree_with_the_production_solve(rows):
    """r3 and fixed22 bisect to the exact k-th value on these rows, so
    they equal the production solve to float32 rounding."""
    x, ego = (torch.as_tensor(a) for a in rows)
    h, g = cv.drcvar_variant(x, ego, "prod")
    for variant in ("r3", "fixed22"):
        hv, gv = cv.drcvar_variant(x, ego, variant)
        torch.testing.assert_close(hv, h, rtol=0, atol=1e-5)
        torch.testing.assert_close(gv, g, rtol=1e-5, atol=2e-4)


def _known_rows(rng, n):
    const = np.broadcast_to(rng.normal(size=(4, 1, 2)), (4, n, 2)).copy()
    # Two values a row: two projections of opposite signs, all tied.
    tied = rng.choice(np.asarray([-1.0, 2.0]), size=(4, n, 1))
    tied = np.concatenate([tied, np.zeros_like(tied)], -1)
    return const, tied


def test_select_rounds_plain_on_known_rows():
    """Rows whose k-th key is tied.  N <= 1024: the select leaves only
    when its bin holds ONE key, so ties run all four passes.  N > 1024:
    the bucket of the k-th key's top 8 bits already holds nothing but
    copies of it, so the count is 1."""
    rng = np.random.default_rng(4)
    ego = rng.normal(size=(64, 2))
    for n, want in ((64, 4), (1100, 1)):
        for rows_ in _known_rows(rng, n):
            r = cv.select_rounds(
                torch.as_tensor(rows_, dtype=torch.float32),
                torch.as_tensor(ego[:4], dtype=torch.float32), cv.ALPHA)
            assert r.dtype == torch.int32 and r.tolist() == [want] * 4
    rand = rng.normal(size=(64, 300, 2))
    r = cv.select_rounds(torch.as_tensor(rand, dtype=torch.float32),
                         torch.as_tensor(ego, dtype=torch.float32), cv.ALPHA)
    assert r.shape == (64,)
    assert int(r.min()) >= 1 and int(r.max()) <= 4
    assert int(r.max()) > 1                # random rows need more than one


@pytest.mark.parametrize("gap_bit,passes", [(2, 2), (8, 3), (16, 4)])
def test_select_rounds_definition(gap_bit, passes):
    """N <= 1024: the count is the passes the select ran, the first p
    after which the bin of the k-th key's top 8p bits holds one key.
    Rows of 16 distinct powers of two (and one balancing value) built so
    that every sum is exact in any order and the mean is the ego (normal
    [1, 0], projections -x): the k-th value 2^-5 and the next larger one
    2^-5 (1 + 2^-gap_bit) share their top 8 + gap_bit key bits and no
    other key shares their top 8, so the select runs gap_bit // 8 + 2
    passes."""
    a = 2.0 ** -5
    b = a * (1.0 + 2.0 ** -gap_bit)
    larger = [2.0 ** e for e in (2, 1, 0, -1, -2, -3)]
    smaller = [2.0 ** e for e in range(-6, -13, -1)]
    proj = larger + [b, a] + smaller                # 8th largest: a
    proj.append(-sum(proj))
    samples = np.zeros((1, 16, 2), np.float32)
    samples[0, :, 0] = -np.asarray(proj)
    assert np.array_equal(samples[0, :, 0].astype(np.float64),
                          -np.asarray(proj))        # float32 holds them
    assert float(samples[0, :, 0].astype(np.float64).sum()) == 0.0
    assert len(set(proj)) == 16
    for order in (slice(None), slice(None, None, -1)):
        rounds = cv.select_rounds(
            torch.as_tensor(samples[:, order].copy()), torch.zeros((1, 2)),
            0.5)
        assert rounds.tolist() == [passes]


def test_select_rounds_definition_block_path():
    """N > 1024 keeps the earlier count: the first p whose top-8p-bit
    bucket of the k-th key holds nothing but the k-th key, ties or not.
    512 values 2^-5 (1 + 2^-2), 1024 tied k-th values 2^-5 and 512
    balancing ones: the two share 10 bits, so p = 2."""
    a = 2.0 ** -5
    b = a * 1.25
    px = np.array([-b] * 512 + [-a] * 1024 + [(1024 * a + 512 * b) / 512]
                  * 512)
    samples = np.zeros((1, 2048, 2), np.float32)
    samples[0, :, 0] = px
    assert float(samples[0, :, 0].astype(np.float64).sum()) == 0.0
    rounds = cv.select_rounds(torch.as_tensor(samples), torch.zeros((1, 2)),
                              0.5)
    assert rounds.tolist() == [2]


def test_variant_dispatch_and_errors():
    x = torch.zeros((2, 8, 2))
    e = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="variant"):
        cv.drcvar_variant(x, e, "planes")
    before = (cv.drcvar_variant.launches, cv.minimal_planes.launches,
              cv.select_rounds.launches)
    for variant in cv.VARIANTS:
        cv.drcvar_variant(x, e, variant)
    cv.minimal_planes(x, e)
    cv.select_rounds(x, e, cv.ALPHA)
    assert (cv.drcvar_variant.launches, cv.minimal_planes.launches,
            cv.select_rounds.launches) == before == (0, 0, 0)
    meta = torch.zeros((2, 8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cv.drcvar_variant(meta, meta[:, 0], "r3")
    with pytest.raises(TypeError):
        cv.minimal_planes(meta.double(), meta[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        cv.select_rounds(meta, meta[:, 0], cv.ALPHA)


def test_kbench_harness_on_cpu():
    """The harness measures on a CUDA device only, and summarises the
    pass counts per row and per block of rows."""
    with pytest.raises(ValueError, match="unknown variants"):
        tkb.measure(["nosel", "prod:512", "planes"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tkb.measure(["nosel"])
    rounds = torch.tensor([1, 2, 3, 4] * 16, dtype=torch.int32)
    line = tkb.rounds_summary(rounds, 32)
    assert "per row min=1 mean=2.500 max=4" in line
    assert "worst per 32-row block min=4 mean=4.000 max=4" in line
    line = tkb.rounds_summary(torch.tensor([1, 1, 2, 1, 3, 4, 1, 1]), 4)
    assert "worst per 4-row block min=2 mean=3.000 max=4" in line
    assert set(tkb.NAMES) == set(cv.VARIANTS) | {"minimal_planes",
                                                 "select_rounds"}
    s, e = tkb.make_inputs(4, 10, "cpu")
    assert s.shape == (4, 10, 2) and e.shape == (4, 2)
    s2, _ = tkb.make_inputs(4, 10, "cpu")
    assert torch.equal(s, s2)
    for name in tkb.NAMES:
        tkb.run_variant(name, s, e)
