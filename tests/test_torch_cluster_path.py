"""Kernel 1's cluster path: rows of 49,153 ... 393,216 samples, one
thread-block cluster of c = ceil(N / 49,152) blocks a row, and the
paper's multi-obstacle deployment at N = 49,153
(`benchmark/configs/paper_multi_obstacle_n49153.json`).

On the CPU: `halfspace_plan` on both sides of each path's limit,
`use_halfspace_kernel` at the new bounds, a plain replay of the cluster
select (each block's slice counted apart, the c histograms added in rank
order) against `radix_select_plain` and `torch.kthvalue` bit for bit, the
wrapper's row counter on the cluster plan, the plan's blocks a row
handed to each entry point, the kernel benchmark's
variants refusing such rows, and the port's halfspace stage at the
cell's N on one scenario of the paper deployment, held to the benchmark's
plain float64 reference (`benchmark/reference.py`) at the cell's
`halfspace_gap` limit.

Marked `cuda` (skipped where torch sees no CUDA device; the kernels have
no CPU mode), run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cluster_path.py

the cluster path against `torch.kthvalue` and float64 at N = 49,153,
65,536, 100,000 and 393,216, the DR-CVaR-only kernel against the
all-metrics one, two launches against each other, a launch of more than
2^31 floats, the entry points' refusal of blocks a row that do not fit
the row, and the stage on the card: one launch a call on the cluster
path at N = 49,153, none at 393,217 or in float64.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    environment as tenv)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
import inputs                      # noqa: E402  (benchmark/)
import reference as ref            # noqa: E402

CELL = "paper_multi_obstacle_n49153.halfspaces128"
CFG = json.loads((BENCH / "configs" / "paper_multi_obstacle_n49153.json")
                 .read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())["limits"]
N_HS, N_OBS = 26, 3
SEED = 2 ** 31 + 4093
ARGS = (0.1, 0.1, 0.15, 0.3, 0.3)         # alpha, delta, epsilon, radii
# Kernel 1's tolerances against its plain version (tests/test_torch_cuda.py).
H_TOL, G_ATOL, G_RTOL = 1e-5, 2e-4, 1e-5
# An H100 block's shared memory; the cluster kernel's static bookkeeping
# (two sets of 256 counters and the reductions' slots) takes ~2.3 KB.
SMEM_LIMIT, BOOKKEEPING = 232_448, 2_400


# --- the plan and the dispatch --------------------------------------------

@pytest.mark.parametrize("N,entry,blocks,slice_n", [
    (49152, "block", 1, 49152), (49153, "cluster", 2, 24577),
    (65536, "cluster", 2, 32768), (100000, "cluster", 3, 33334),
    (393215, "cluster", 8, 49152), (393216, "cluster", 8, 49152)])
@pytest.mark.parametrize("B", [0, 1, 9984])
def test_plan_past_the_block_path(B, N, entry, blocks, slice_n):
    for aligned in (True, False):
        plan = ck.halfspace_plan(B, N, aligned)
        assert (plan.entry, plan.cluster, plan.slice) == (entry, blocks,
                                                          slice_n)
        assert plan.values_per_lane == 0 and plan.rows_per_block == 1
        assert plan.threads == 256 and plan.load_bytes == 8
        assert plan.smem_bytes == 4 * slice_n
        assert plan.smem_bytes + BOOKKEEPING <= SMEM_LIMIT
        # every block of the cluster holds part of the row
        assert (blocks - 1) * slice_n < N <= blocks * slice_n


def test_the_limits_of_the_three_paths():
    assert (ck.WARP_MAX_N, ck.BLOCK_MAX_N, ck.MAX_CLUSTER_BLOCKS) == \
        (1024, 49152, 8)
    assert ck.MAX_N_SAMPLES == 393216
    with pytest.raises(ValueError, match="393216"):
        ck.halfspace_plan(1, 393217, True)


@pytest.mark.parametrize("dtype,n,want", [
    (torch.float32, 49153, True), (torch.float32, 100000, True),
    (torch.float32, 393216, True), (torch.float32, 393217, False),
    (torch.float64, 49153, False), (torch.float64, 393216, False)])
def test_use_halfspace_kernel_at_the_cluster_bounds(dtype, n, want):
    assert tenv.use_halfspace_kernel(dtype, n) is want


# --- a plain replay of the cluster select ---------------------------------

def cluster_select_replay(x, k: int, blocks: int):
    """The cluster path's select with torch ops: the k-th largest along
    the last axis of x [B, N], the row cut into `blocks` slices of
    ceil(N / blocks); each pass counts each slice's digits apart (a
    block's own counters) and adds the slices' counts in rank order, then
    walks the bins from the largest down as the block path does, all four
    passes."""
    keys = ck.float_keys(x)
    B, N = keys.shape
    size = -(-N // blocks)
    slices = [keys[:, r * size:(r + 1) * size] for r in range(blocks)]
    assert all(s.shape[1] > 0 for s in slices)
    prefix = torch.zeros((B,), dtype=torch.int64)
    krem = torch.full((B,), k, dtype=torch.int64)
    mask = 0
    for shift in (24, 16, 8, 0):
        hist = torch.zeros((B, 256), dtype=torch.int64)
        for s in slices:
            match = (s & mask) == prefix[:, None]
            hist += torch.zeros_like(hist).scatter_add_(
                1, (s >> shift) & 0xFF, match.to(torch.int64))
        down = hist.flip(1)
        incl = down.cumsum(1)
        at = (incl >= krem[:, None]).to(torch.int64).argmax(1, keepdim=True)
        krem = krem - (incl.gather(1, at) - down.gather(1, at))[:, 0]
        prefix = prefix | ((255 - at[:, 0]) << shift)
        mask |= 0xFF << shift
    return ck.key_floats(prefix)


def _select_rows(N: int, seed: int):
    """Eight rows of N: Gaussian, rounded (heavy ties, signed zeros),
    constant, two values only, and a row of one outlier."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((8, N), generator=gen)
    x[1:3] = torch.round(x[1:3])
    x[2, ::2] = -0.0
    x[3] = x[3, :1]
    x[4] = torch.where(x[4] > 0, 1.5, -2.5)
    x[5] = 0.0
    x[5, N // 2] = 7.0
    return x


@pytest.mark.parametrize("N,blocks", [(49153, 2), (100000, 3), (393216, 8)])
def test_summed_slice_histograms_give_the_exact_kth_value(N, blocks):
    assert ck.halfspace_plan(1, N, True).cluster == blocks
    x = _select_rows(N, N)
    for k in (1, pt.core.risk.cvar_k(N, 0.1), N // 2, N):
        got = cluster_select_replay(x, k, blocks)
        want = torch.kthvalue(x, N - k + 1, dim=-1).values
        assert torch.equal(got, want), k
        assert torch.equal(got, ck.radix_select_plain(x, k)[0]), k


@pytest.mark.parametrize("blocks", [2, 3, 8])
def test_the_replay_at_any_cut_of_a_short_row(blocks):
    """The same replay where a slice is short and the k-th value's bin is
    split unevenly between the blocks."""
    x = _select_rows(101, blocks)
    for k in range(1, 102, 10):
        assert torch.equal(cluster_select_replay(x, k, blocks),
                           ck.radix_select_plain(x, k)[0]), k


# --- the wrapper and the stage on the CPU ---------------------------------

def test_the_wrapper_counts_rows_under_the_cluster_plan(monkeypatch):
    """The CUDA branch of `all_metrics_halfspaces` on shape-only (meta)
    tensors at the cell's shape, its device check and launch stubbed: the
    rows are counted as `halfspace.rows_cluster`, and the launch gets the
    CVaR select at k = ceil(0.1 N) = 4,916 and the plan's values."""
    launched = []
    monkeypatch.setattr(ck, "_check_f32_cuda", lambda *a: None)
    monkeypatch.setattr(ck._build, "launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(ck.all_metrics_halfspaces, "launches",
                        ck.all_metrics_halfspaces.launches)
    B, N = 128 * N_HS * N_OBS, CFG["num_samples"]
    samples = torch.empty((B, N, 2), device="meta")
    ego = torch.empty((B, 2), device="meta")
    before, was = timing.totals(), timing.record(True)
    try:
        ck.all_metrics_halfspaces(samples, ego, *ARGS)
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {"halfspace.rows_cluster": 9984}
    (args,) = launched
    assert args[7:10] == (9984, 49153, 4916)
    assert args[10:14] == (0, 1, 8, 2)


@pytest.mark.parametrize("N", [1000, 1025, 49152, 49153, 100000, 393216])
def test_every_entry_launches_the_plans_blocks_a_row(N, monkeypatch):
    """The three wrappers hand the C entry points the plan's blocks a
    row (1 on the warp and block paths, 2 ... 8 on the cluster path),
    which the entry points check against N; meta tensors, the device
    check and launch stubbed."""
    launched = []
    monkeypatch.setattr(ck, "_check_f32_cuda", lambda *a: None)
    monkeypatch.setattr(ck._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    for fn in (ck.all_metrics_halfspaces, ck.fused_drcvar_halfspace,
               ck.kth_largest):
        monkeypatch.setattr(fn, "launches", fn.launches)
    x = torch.empty((3, N, 2), device="meta")
    ego = torch.empty((3, 2), device="meta")
    ck.all_metrics_halfspaces(x, ego, *ARGS)
    ck.fused_drcvar_halfspace(x, ego, *ARGS)
    ck.kth_largest(torch.empty((3, N), device="meta"), 7)
    blocks = ck.halfspace_plan(3, N, False).cluster
    assert blocks == -(-N // ck.BLOCK_MAX_N)
    (a, all_args), (f, fused_args), (k, kth_args) = launched
    assert (a, f, k) == ("drcvar_all_metrics_halfspaces",
                         "drcvar_fused_halfspace", "drcvar_kth_largest")
    assert all_args[13] == fused_args[10] == kth_args[7] == blocks


def test_the_variants_refuse_rows_past_the_block_path(monkeypatch):
    """The kernel benchmark's variants keep the warp and block paths
    only: a row of 49,153 samples is refused before any launch."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    monkeypatch.setattr(ck, "_check_f32_cuda", lambda *a: None)
    monkeypatch.setattr(ck._build, "launch", None)
    x = torch.empty((2, ck.BLOCK_MAX_N + 1, 2), device="meta")
    ego = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="no cluster path"):
        cv.drcvar_variant(x, ego, "r3")
    with pytest.raises(ValueError, match="no cluster path"):
        cv.select_rounds(x, ego, cv.ALPHA)


def test_the_config_is_the_paper_preset_at_n_49153():
    n1500 = json.loads((BENCH / "configs" / "paper_multi_obstacle_n1500.json")
                       .read_text())
    same = {k for k in n1500 if k not in ("num_samples", "assumed",
                                          "deployment")}
    assert {k: CFG[k] for k in same} == {k: n1500[k] for k in same}
    assert CFG["num_samples"] == 49153 == ck.BLOCK_MAX_N + 1
    assert CFG["reduced"] == [] and "num_samples" in CFG["assumed"]


def test_the_stage_at_the_cells_n_is_judged_by_the_reference():
    """One scenario of the paper deployment at N = 49,153 through
    `compute_safe_halfspaces_for_trajectory` in float32 on the CPU (the
    rows reach `all_metrics_halfspaces`, whose plain version runs on a
    CPU tensor), held to the float64 reference at the cell's limit."""
    params = dataclasses.replace(pt.config.get_parameters("paper"),
                                 num_samples=CFG["num_samples"])
    scenario = pt.config.get_scenario_config("multi_obstacle", "paper")
    env = pt.models.make_statics(scenario, params, torch.float32, "cpu").env
    pool = inputs.make_pool(torch, CFG, 1, 1, SEED, "cpu")
    start, goal = inputs.start_goal(torch, CFG, 1, "cpu")
    x_ref64 = ref.straight_line(start, goal, CFG["ego_velocity"], CFG["dt"],
                                CFG["horizon"], ref.FLOAT64)
    samples = pool.draw(0)[1]
    before, was = timing.totals(), timing.record(True)
    try:
        out = tenv.compute_safe_halfspaces_for_trajectory(
            env, samples, x_ref64.float())
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {"halfspace.rows_plain": N_HS * N_OBS}
    assert out.cvar.h.shape == (1, N_HS, N_OBS, 2)
    rows = ref.sample_rows(samples, N_HS).double()
    ego = ref.ego_rows(x_ref64, N_HS, N_OBS)
    gap = ref.halfspace_gap(
        rows, ego, {m: out.by_metric(m).h.reshape(-1, 2) for m in ref.METRICS},
        {m: out.by_metric(m).g_tilde.reshape(-1) for m in ref.METRICS}, CFG)
    assert gap <= LIMITS["halfspace_gap"], gap


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


CLUSTER_N = [49153, 65536, 100000, 393216]


def _rows(cuda, B, N, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 2.0 + 0.1 * torch.randn(B, N, 2, device=cuda, generator=gen)
    return x, torch.randn(B, 2, device=cuda, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("N", CLUSTER_N)
def test_select_is_bit_equal_on_the_cluster_path(cuda, N):
    x = _select_rows(N, N).to(cuda)
    x = torch.cat([x, torch.randn(59, N, device=cuda)])
    before = ck.kth_largest.launches
    for k in (1, pt.core.risk.cvar_k(N, 0.1), N // 2, N):
        got = ck.kth_largest(x, k)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.kthvalue(x, N - k + 1, dim=-1).values), k
        assert torch.equal(got, ck.radix_select_plain(x, k)[0]), k
    assert ck.kth_largest.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("N", CLUSTER_N)
def test_cluster_path_within_the_kernel_tolerances_of_float64(cuda, N):
    x, ego = _rows(cuda, 37, N, N)
    before, was = timing.totals(), timing.record(True)
    try:
        out = ck.all_metrics_halfspaces(x, ego, *ARGS)
        torch.cuda.synchronize()
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {"halfspace.rows_cluster": 37}
    want = ck.all_metrics_halfspaces_plain(x.double(), ego.double(), *ARGS)
    for name, a, b in zip(out._fields, out, want):
        assert bool(torch.isfinite(a).all()), name
        if name.startswith("h"):
            torch.testing.assert_close(a.double(), b, atol=H_TOL, rtol=0)
        else:
            torch.testing.assert_close(a.double(), b, atol=G_ATOL, rtol=G_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N", CLUSTER_N)
def test_drcvar_only_is_bit_equal_to_all_metrics(cuda, N):
    x, ego = _rows(cuda, 21, N, N + 1)
    h, g = ck.fused_drcvar_halfspace(x, ego, *ARGS)
    ref_out = ck.all_metrics_halfspaces(x, ego, *ARGS)
    torch.cuda.synchronize()
    assert torch.equal(h, ref_out.h) and torch.equal(g, ref_out.g_drcvar)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [49153, 393216])
def test_two_launches_are_bit_identical(cuda, N):
    x, ego = _rows(cuda, 64, N, N + 2)
    first = ck.all_metrics_halfspaces(x, ego, *ARGS)
    second = ck.all_metrics_halfspaces(x, ego, *ARGS)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_launch_of_more_than_2_31_floats(cuda):
    """2,731 rows of 393,216 samples (2^31 + 262,144 floats, 8.6 GB): the
    rows past the 2^31-th float give what a launch on their copy alone
    gives, bit for bit, and lie within the tolerances of float64."""
    B, N = 2731, ck.MAX_N_SAMPLES
    assert B * N * 2 > 2 ** 31
    x, ego = _rows(cuda, B, N, 31)
    out = ck.all_metrics_halfspaces(x, ego, *ARGS)
    tail = slice(B - 3, B)
    alone = ck.all_metrics_halfspaces(x[tail].clone(), ego[tail].clone(), *ARGS)
    head = ck.all_metrics_halfspaces(x[:2].clone(), ego[:2].clone(), *ARGS)
    torch.cuda.synchronize()
    want = ck.all_metrics_halfspaces_plain(x[tail].double(), ego[tail].double(),
                                           *ARGS)
    for name, a, b, c, w in zip(out._fields, out, alone, head, want):
        assert torch.equal(a[tail], b) and torch.equal(a[:2], c), name
        tol = (H_TOL, 0) if name.startswith("h") else (G_ATOL, G_RTOL)
        torch.testing.assert_close(a[tail].double(), w, atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.cuda
def test_entry_points_refuse_blocks_a_row_that_do_not_fit_n(cuda):
    """A row of 49,153 samples takes 2 blocks a row and no other count;
    a row of 49,152 takes 1; a warp-path plan takes 1."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        _build)
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(4, device=cuda)

    def call(n, values, rows, cluster):
        x = torch.randn(2, n, device=cuda)
        err = lib.drcvar_kth_largest(x.data_ptr(), out.data_ptr(), 2, n, 5,
                                     values, rows, cluster, stream)
        torch.cuda.synchronize()
        return err

    assert call(49153, 0, 1, 2) == 0
    for cluster in (1, 3, 8, 9):
        assert call(49153, 0, 1, cluster) != 0
    assert call(49152, 0, 1, 1) == 0
    assert call(49152, 0, 1, 2) != 0
    assert call(393216, 0, 1, 8) == 0
    assert call(393216, 0, 1, 9) != 0
    assert call(1000, 32, 4, 1) == 0
    assert call(1000, 32, 4, 2) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples,dtype,launches,counter", [
    (49153, torch.float32, 1, "halfspace.rows_cluster"),
    (393217, torch.float32, 0, "halfspace.rows_plain"),
    (49153, torch.float64, 0, "halfspace.rows_plain")])
def test_the_stage_on_the_card(cuda, n_samples, dtype, launches, counter):
    """One scenario of the paper deployment through
    `compute_safe_halfspaces_for_trajectory` on the card: float32 rows of
    49,153 samples in one cluster-path launch, within the cell's limit of
    the float64 reference; 393,217 samples and float64 on the plain path."""
    cfg = dict(CFG, num_samples=n_samples)
    params = dataclasses.replace(pt.config.get_parameters("paper"),
                                 num_samples=n_samples)
    scenario = pt.config.get_scenario_config("multi_obstacle", "paper")
    env = pt.models.make_statics(scenario, params, dtype, cuda).env
    pool = inputs.make_pool(torch, cfg, 1, 1, SEED, cuda)
    start, goal = inputs.start_goal(torch, cfg, 1, cuda)
    x_ref64 = ref.straight_line(start, goal, cfg["ego_velocity"], cfg["dt"],
                                cfg["horizon"], ref.FLOAT64)
    samples = pool.draw(0)[1].to(dtype)
    was_launches = ck.all_metrics_halfspaces.launches
    before, was = timing.totals(), timing.record(True)
    try:
        out = tenv.compute_safe_halfspaces_for_trajectory(
            env, samples, x_ref64.to(dtype))
        torch.cuda.synchronize()
    finally:
        timing.record(was)
    assert ck.all_metrics_halfspaces.launches == was_launches + launches
    assert timing.since(before)["counts"] == {counter: N_HS * N_OBS}
    rows = ref.sample_rows(samples, N_HS).double()
    ego = ref.ego_rows(x_ref64, N_HS, N_OBS)
    gap = ref.halfspace_gap(
        rows, ego, {m: out.by_metric(m).h.reshape(-1, 2) for m in ref.METRICS},
        {m: out.by_metric(m).g_tilde.reshape(-1) for m in ref.METRICS}, cfg)
    assert gap <= LIMITS["halfspace_gap"], gap
