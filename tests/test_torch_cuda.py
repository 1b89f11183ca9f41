"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device (a CUDA
kernel has no CPU mode).  Run on a machine with an H100:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: the k-th value bit-equal on identical
inputs; h to 1e-5; g to atol 2e-4 / rtol 1e-5; L and x to 1e-5 relative
in norm.
"""

import numpy as np
import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck, cuda_linalg as cl)

from torch_port_streams import reference_rng_obstacles

pytestmark = pytest.mark.cuda

ARGS = (0.2, 0.1, 0.15, 0.3, 0.3)   # alpha, delta, epsilon, radii


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


# Both sides of the warp path's limit (1024 / 1025), odd N (8-byte loads),
# every number of values a lane, B off the rows-a-block multiple.
GRID = [(2304, 1000), (7, 20), (5, 4096), (13, 1001), (9, 1024), (6, 1025),
        (10, 999), (3, 1), (5, 64), (5, 65), (7, 130), (6, 300), (1, 513)]


@pytest.mark.parametrize("B,N", GRID)
def test_all_metrics_kernel_matches_plain(cuda, B, N):
    gen = torch.Generator(device=cuda).manual_seed(B)
    x = 2.0 + 0.1 * torch.randn(B, N, 2, device=cuda, generator=gen)
    ego = torch.randn(B, 2, device=cuda, generator=gen)
    before = ck.all_metrics_halfspaces.launches
    out = ck.all_metrics_halfspaces(x, ego, *ARGS)
    torch.cuda.synchronize()
    assert ck.all_metrics_halfspaces.launches == before + 1
    ref = ck.all_metrics_halfspaces_plain(x, ego, *ARGS)
    for name, a, b in zip(out._fields, out, ref):
        if name.startswith("h"):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("N,k", [(1000, 200), (20, 4), (4096, 820),
                                 (64, 64), (33, 1), (1024, 205), (1024, 1),
                                 (1024, 1024), (1025, 205), (999, 999),
                                 (1, 1), (129, 26), (300, 60), (600, 1)])
def test_select_bit_equal_to_kthvalue(cuda, N, k):
    gen = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(67, N, device=cuda, generator=gen)
    x[:8] = torch.round(x[:8])                # heavy ties, signed zeros
    x[8:16] = x[8:16, :1]                     # constant rows
    x[16:20] = 1e38 * x[16:20]                # some overflow to +-inf
    v = ck.kth_largest(x, k)
    ref = torch.kthvalue(x, N - k + 1, dim=-1).values
    assert torch.equal(v, ref)                # -0.0 == +0.0
    replay, passes = ck.radix_select_plain(x, k)
    assert torch.equal(v, replay)
    assert 1 <= int(passes.min()) and int(passes.max()) <= 4


@pytest.mark.parametrize("n", [60, 64, 17])
def test_cholesky_and_solve_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn(768, n, n, device=cuda, generator=gen)
    S = A @ A.mT + 3.0 * torch.eye(n, device=cuda)
    L = cl.batched_cholesky(S)
    assert _rel(L, cl.batched_cholesky_plain(S)) < 1e-5
    assert float(L.triu(1).abs().max()) == 0.0
    for k in (0, 1, 65):
        shape = (768, n) if k == 0 else (768, n, k)
        r = torch.randn(shape, device=cuda, generator=gen)
        x = cl.batched_cho_solve(L, r)
        assert _rel(x, cl.batched_cho_solve_plain(L, r)) < 1e-5


def _spd(cuda, gen, B, n):
    A = torch.randn(B, n, n, device=cuda, generator=gen)
    return A @ A.mT + 3.0 * torch.eye(n, device=cuda)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 60, 64])
@pytest.mark.parametrize("B", [1, 5])
def test_cholesky_and_solve_size_grid(cuda, B, n):
    """Sizes on both sides of 32 (a lane's second row) and right-hand
    side counts on both sides of the solve's kernel threshold."""
    gen = torch.Generator(device=cuda).manual_seed(100 * B + n)
    S = _spd(cuda, gen, B, n)
    L = cl.batched_cholesky(S)
    assert _rel(L, cl.batched_cholesky_plain(S)) < 1e-5
    assert float(L.triu(1).abs().max()) == 0.0
    assert 1 <= cl.solve_warp_max_k() < 65
    for k in (0, 1, 2, 31, 32, 33, 65, 256):
        shape = (B, n) if k == 0 else (B, n, k)
        r = torch.randn(shape, device=cuda, generator=gen)
        x = cl.batched_cho_solve(L, r)
        assert x.shape == r.shape
        assert _rel(x, cl.batched_cho_solve_plain(L, r)) < 1e-5, k


@pytest.mark.parametrize("n", [33, 60, 64])
def test_not_positive_definite_in_a_batch(cuda, n):
    """NaN where the plain version has NaN (the whole matrix), the other
    matrices of the batch bit for bit what they are without it."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    S = _spd(cuda, gen, 8, n)
    L_clean = cl.batched_cholesky(S)
    S_bad = S.clone()
    S_bad[2] = -S[2]
    S_bad[5, n // 2, n // 2] = -1.0
    L = cl.batched_cholesky(S_bad)
    assert torch.equal(torch.isnan(L),
                       torch.isnan(cl.batched_cholesky_plain(S_bad)))
    assert bool(torch.isnan(L[[2, 5]]).all())
    good = [0, 1, 3, 4, 6, 7]
    assert torch.equal(L[good], L_clean[good])
    for k in (1, 65):
        r = torch.randn(8, n, k, device=cuda, generator=gen)
        x = cl.batched_cho_solve(L, r)
        assert bool(torch.isnan(x[[2, 5]]).all())
        assert torch.equal(x[good], cl.batched_cho_solve(L_clean, r)[good])


def test_unaligned_views_take_the_generic_kernels(cuda):
    """A contiguous view that starts 4 bytes into its storage is not
    16-byte aligned: the n = 60 kernels' vector loads must not see it."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    S = _spd(cuda, gen, 4, 60)
    flat = torch.empty(S.numel() + 1, device=cuda)
    view = flat[1:].view_as(S).copy_(S)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    L = cl.batched_cholesky(view)
    assert _rel(L, cl.batched_cholesky_plain(S)) < 1e-5
    Lview = flat[1:].view_as(S).copy_(L)
    r = torch.randn(4, 60, 65, device=cuda, generator=gen)
    for rhs in (r, r[:, :, 0].contiguous()):
        assert _rel(cl.batched_cho_solve(Lview, rhs),
                    cl.batched_cho_solve_plain(L, rhs)) < 1e-5


def test_batch_run_launch_counts(cuda):
    """One 8-scenario batch run: one factorisation and two solves for
    each of the IPM's 16 passes, two and six more in the polish."""
    import dataclasses
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 num_samples=1000, sim_time=6.0)
    scenario = pt.config.get_scenario_config("multi_obstacle")
    statics = pt.models.make_statics(scenario, params, torch.float32, cuda)
    kernels = (ck.all_metrics_halfspaces, cl.batched_cholesky,
               cl.batched_cho_solve)
    before = [fn.launches for fn in kernels]
    res = pt.models.run_scenario_core(
        statics, torch.Generator(device=cuda).manual_seed(0),
        scenario.ego_start, scenario.ego_goal, scenario.obstacle_starts,
        scenario.obstacle_directions, scenario.obstacle_speeds,
        int(params.sim_time / params.dt), params.num_samples,
        params.noise_var, params.ego_velocity, qp_iters=35, qp_tol=3e-5,
        n_scenarios=8)
    passes = int(res.qp_iterations.max()) + 1
    assert [fn.launches - b for fn, b in zip(kernels, before)] == \
        [1, passes + 2, 2 * passes + 6]
    assert bool(res.qp_converged.all())


def test_kernels_reject_non_f32_on_cuda(cuda):
    S = torch.eye(8, device=cuda, dtype=torch.float64).expand(2, 8, 8)
    with pytest.raises(TypeError):
        cl.batched_cholesky(S.contiguous())
    with pytest.raises(ValueError, match="n <= 64"):
        cl.batched_cholesky(torch.zeros(2, 65, 65, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        cl.batched_cholesky(torch.zeros(2, 8, 8, device=cuda).mT)
    with pytest.raises(TypeError):
        ck.all_metrics_halfspaces(torch.zeros(2, 8, 2, device=cuda,
                                              dtype=torch.float64),
                                  torch.zeros(2, 2, device=cuda), *ARGS)


def test_pipeline_on_cuda_uses_the_kernels(cuda):
    """head_on through the float32 CUDA pipeline: every kernel of the path
    launches, and the controls stay within 1e-4 of the CPU float64 run."""
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("head_on")
    obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                  params.num_samples)
    runs = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        statics = pt.models.make_statics(scenario, params, dtype, device)
        before = (ck.all_metrics_halfspaces.launches,
                  cl.batched_cholesky.launches, cl.batched_cho_solve.launches)
        runs[device] = pt.models.run_scenario_with_obstacles(
            statics, pt.convert.obstacle_data(obs, dtype, device, True),
            scenario.ego_start, scenario.ego_goal, params.ego_velocity)
        after = (ck.all_metrics_halfspaces.launches,
                 cl.batched_cholesky.launches, cl.batched_cho_solve.launches)
        launched = [a - b for a, b in zip(after, before)]
        if device == "cpu":
            assert launched == [0, 0, 0]
        else:
            assert min(launched) > 0, launched
    gpu, cpu = runs[cuda], runs["cpu"]
    assert bool(gpu.qp_converged.all())
    dev = np.abs(gpu.filtered_u.cpu().double().numpy()
                 - cpu.filtered_u.numpy()).max()
    assert dev < 1e-4, dev


def _rows(cuda, B, N, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 0.5 + 0.1 * torch.randn(B, N, 2, device=cuda, generator=gen)
    return x, 0.1 * torch.randn(B, 2, device=cuda, generator=gen)


@pytest.mark.parametrize("B,N", GRID + [(1, 1000)])
def test_drcvar_kernel_bit_equal_to_all_metrics(cuda, B, N):
    x, ego = _rows(cuda, B, N, B + N)
    before = ck.fused_drcvar_halfspace.launches
    h, g = ck.fused_drcvar_halfspace(x, ego, *ARGS)
    torch.cuda.synchronize()
    assert ck.fused_drcvar_halfspace.launches == before + 1
    ref = ck.all_metrics_halfspaces(x, ego, *ARGS)
    assert torch.equal(h, ref.h) and torch.equal(g, ref.g_drcvar)
    plain = ck.fused_drcvar_halfspace_plain(x, ego, *ARGS)
    torch.testing.assert_close(h, plain.h, atol=1e-5, rtol=0)
    torch.testing.assert_close(g, plain.g_tilde, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("B,N", [(9, 1000), (6, 20), (5, 300)])
def test_misaligned_view_takes_the_8_byte_loads(cuda, B, N):
    """A contiguous view that starts 8 bytes into its storage: the plan
    gives it 8-byte loads, whose results are bit-equal to the 16-byte
    loads' on the same rows (a lane holds the same samples either way)."""
    x, ego = _rows(cuda, B, N, N)
    flat = torch.empty(x.numel() + 2, device=cuda)
    view = flat[2:].view_as(x).copy_(x)
    assert view.data_ptr() % 16 == 8 and view.is_contiguous()
    assert ck.halfspace_plan(B, N, False).load_bytes == 8
    assert ck.halfspace_plan(B, N, x.data_ptr() % 16 == 0).load_bytes == 16
    for fn in (ck.all_metrics_halfspaces, ck.fused_drcvar_halfspace):
        for a, b in zip(fn(view, ego, *ARGS), fn(x, ego, *ARGS)):
            assert torch.equal(a, b)
    plain = ck.all_metrics_halfspaces_plain(x, ego, *ARGS)
    out = ck.all_metrics_halfspaces(view, ego, *ARGS)
    torch.testing.assert_close(out.h, plain.h, atol=1e-5, rtol=0)
    torch.testing.assert_close(out.g_drcvar, plain.g_drcvar, atol=2e-4,
                               rtol=1e-5)


def test_entry_points_refuse_a_plan_the_kernels_do_not_take(cuda):
    """The C entry points hold the plan against the rows: too few values
    a lane, 16-byte loads on an odd N or a misaligned start, a block of
    more than 8 rows, more than one block a row short of the cluster
    path."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        _build)
    x, ego = _rows(cuda, 4, 100, 0)
    odd, _ = _rows(cuda, 4, 99, 0)
    out = [torch.empty(8, device=cuda) for _ in range(5)]
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream

    def call(samples, n, values, rows, load, cluster=1):
        return lib.drcvar_all_metrics_halfspaces(
            samples.data_ptr(), ego.data_ptr(), *(t.data_ptr() for t in out),
            4, n, 20, values, rows, load, cluster, 1.0 / n, 0.2 * n, 0.6,
            0.1, 0.75, stream)

    assert call(x, 100, 4, 4, 16) == 0
    assert call(x, 100, 2, 4, 16) != 0          # 64 values hold no 100
    assert call(x, 100, 3, 4, 16) != 0          # no such instantiation
    assert call(x, 100, 4, 9, 16) != 0          # more than 8 rows a block
    assert call(x, 100, 4, 4, 4) != 0           # no such load
    assert call(odd, 99, 4, 4, 16) != 0         # odd N: rows not aligned
    assert call(odd, 99, 4, 4, 8) == 0
    assert call(x, 100, 4, 4, 16, 2) != 0       # a warp a row, not 2 blocks
    assert call(x, 100, 0, 1, 8, 2) != 0        # a block a row, not 2
    assert call(x, 100, 0, 1, 8) == 0
    torch.cuda.synchronize()


# Every number of values a lane, both sides of the warp path's limit, an
# odd N (8-byte loads), B off the rows-a-block multiple.
VARIANT_GRID = [(4096, 1000), (9, 300), (7, 20), (5, 64), (5, 65), (10, 999),
                (9, 1024), (6, 1025), (5, 4096)]


def _misaligned(x):
    """The same rows in a contiguous view 8 bytes into its storage."""
    flat = torch.empty(x.numel() + 2, device=x.device)
    view = flat[2:].view_as(x).copy_(x)
    assert view.data_ptr() % 16 == 8 and view.is_contiguous()
    return view


@pytest.mark.parametrize("variant", ["prod_nosel", "nosel", "r3", "fixed12",
                                     "fixed22", "minimal", "minimal_planes"])
@pytest.mark.parametrize("B,N", VARIANT_GRID)
def test_variant_kernels_match_plain(cuda, variant, B, N):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    x, ego = _rows(cuda, B, N, N)
    if variant == "minimal_planes":
        fn, call = cv.minimal_planes, cv.minimal_planes
        ref = cv.minimal_planes_plain(x, ego)
    else:
        fn = cv.drcvar_variant

        def call(s, e):
            return cv.drcvar_variant(s, e, variant)
        ref = cv.drcvar_variant_plain(x, ego, variant)
    before = fn.launches
    out = call(x, ego)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(out.h, ref.h, atol=1e-5, rtol=0)
    torch.testing.assert_close(out.g_tilde, ref.g_tilde, atol=2e-4,
                               rtol=1e-5)
    # 8-byte loads give a lane the same samples as 16-byte loads.
    shifted = call(_misaligned(x), ego)
    assert fn.launches == before + 2
    assert torch.equal(shifted.h, out.h)
    assert torch.equal(shifted.g_tilde, out.g_tilde)


@pytest.mark.parametrize("B,N", [(4096, 1000), (9, 300)])
def test_exact_bisections_equal_the_production_kernel(cuda, B, N):
    """r3 and fixed22 bisect to the exact k-th value, and share the
    production kernel's stages before the select: the same h bit for
    bit, g to float32 rounding."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    x, ego = _rows(cuda, B, N, N)
    prod = cv.drcvar_variant(x, ego, "prod")
    for variant in ("r3", "fixed22"):
        out = cv.drcvar_variant(x, ego, variant)
        assert torch.equal(out.h, prod.h)
        torch.testing.assert_close(out.g_tilde, prod.g_tilde, atol=2e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("B,N", VARIANT_GRID)
def test_select_rounds_kernel_equals_plain(cuda, B, N):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    B = max(B, 24)
    x, ego = _rows(cuda, B, N, 3)
    x[:8] = torch.round(x[:8] * 4) / 4       # repeated samples
    x[8:16] = x[8:16, :1]                    # constant rows: every key tied
    before = cv.select_rounds.launches
    r = cv.select_rounds(x, ego, 0.2)
    torch.cuda.synchronize()
    assert cv.select_rounds.launches == before + 1
    assert r.dtype == torch.int32 and r.shape == (B,)
    assert torch.equal(r, cv.select_rounds_plain(x, ego, 0.2))
    assert torch.equal(r, cv.select_rounds(_misaligned(x), ego, 0.2))
    # Tied keys run all four passes of the warp path's select; on the
    # block path the count is the room an early exit would have.
    assert r[8:16].tolist() == [4 if N <= ck.WARP_MAX_N else 1] * 8
    assert 1 <= int(r.min()) and int(r.max()) <= 4


def test_select_rounds_counts_the_production_select(cuda):
    """On the warp path the count is what the production select does on
    the same keys: `kth_largest` runs that select alone, and its torch
    replay reports the same passes on the plain version's projections."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    x, ego = _rows(cuda, 2304, 1000, 11)
    r = cv.select_rounds(x, ego, 0.2)
    h = ck.all_metrics_halfspaces_plain(x, ego, *ARGS).h
    centered = x - ego[:, None, :]
    proj = -((centered - centered.mean(1, keepdim=True))
             * h[:, None, :]).sum(-1).contiguous()
    v, passes = ck.radix_select_plain(proj, 200)
    assert torch.equal(ck.kth_largest(proj, 200), v)
    # The two sets of projections differ in rounding only: a row's count
    # moves where that splits or joins a digit of two keys.
    assert float((r != passes).float().mean()) < 0.02
    assert abs(float(r.float().mean()) - float(passes.float().mean())) < 0.01


def test_variant_entry_points_refuse_a_plan_the_kernels_do_not_take(cuda):
    """As the production entry points: too few values a lane, 16-byte
    loads on an odd N, a block of more than 8 rows; and `minimal_planes`
    has no warp kernel."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        _build)
    x, ego = _rows(cuda, 4, 100, 0)
    odd, _ = _rows(cuda, 4, 99, 0)
    h, g = torch.empty(8, device=cuda), torch.empty(4, device=cuda)
    out = torch.empty(4, device=cuda, dtype=torch.int32)
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream

    def variant(samples, n, code, values, rows, load):
        return lib.drcvar_variant(
            samples.data_ptr(), ego.data_ptr(), h.data_ptr(), g.data_ptr(),
            4, n, 20, code, 22, values, rows, load, 1.0 / n, 0.2 * n, 0.1,
            0.75, stream)

    def rounds(samples, n, values, rows, load):
        return lib.drcvar_select_rounds(
            samples.data_ptr(), ego.data_ptr(), out.data_ptr(), 4, n, 20,
            values, rows, load, 1.0 / n, stream)

    for code in range(5):
        assert variant(x, 100, code, 4, 4, 16) == 0
        assert variant(x, 100, code, 0, 1, 8) == 0      # a block a row
    assert variant(x, 100, 5, 0, 1, 8) == 0
    assert variant(x, 100, 5, 4, 4, 16) != 0            # minimal_planes
    assert variant(x, 100, 6, 4, 4, 16) != 0            # no such variant
    assert variant(x, 100, 6, 0, 1, 8) != 0
    for call in (lambda *a: variant(a[0], a[1], 2, *a[2:]), rounds):
        assert call(x, 100, 4, 4, 16) == 0
        assert call(x, 100, 2, 4, 16) != 0          # 64 values hold no 100
        assert call(x, 100, 3, 4, 16) != 0          # no such instantiation
        assert call(x, 100, 4, 9, 16) != 0          # more than 8 rows a block
        assert call(x, 100, 4, 4, 4) != 0           # no such load
        assert call(odd, 99, 4, 4, 16) != 0         # odd N: rows not aligned
        assert call(odd, 99, 4, 4, 8) == 0
    torch.cuda.synchronize()


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
        cuda_variants as cv)
    x, ego = _rows(cuda, 4, 16, 0)
    calls = {
        "fused_drcvar_halfspace":
            lambda s, e: ck.fused_drcvar_halfspace(s, e, *ARGS),
        "drcvar_variant": lambda s, e: cv.drcvar_variant(s, e, "r3"),
        "minimal_planes": cv.minimal_planes,
        "select_rounds": lambda s, e: cv.select_rounds(s, e, 0.2),
    }
    for name, call in calls.items():
        with pytest.raises(TypeError):
            call(x.double(), ego)
        with pytest.raises(ValueError, match="CUDA"):
            call(x, ego.cpu())
        with pytest.raises(ValueError, match="shape"):
            call(x, ego[:3])
        with pytest.raises(ValueError):
            call(x[..., :1].contiguous(), ego)
        with pytest.raises(ValueError, match="contiguous"):
            call(x.transpose(0, 1).contiguous().transpose(0, 1), ego)


def test_monte_carlo_on_cuda_uses_the_kernels(cuda):
    """A short Monte Carlo study on the card: kernels 1-3 launch, and two
    runs from one seed give identical minimum distances."""
    import dataclasses
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 num_samples=100)
    scenario = pt.config.get_scenario_config("head_on")
    kernels = (ck.all_metrics_halfspaces, cl.batched_cholesky,
               cl.batched_cho_solve)
    before = [fn.launches for fn in kernels]
    first, second = (pt.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=16, seed=5, device=cuda) for _ in range(2))
    assert min(fn.launches - b for fn, b in zip(kernels, before)) > 0
    assert bool(torch.isfinite(first.min_distances).all())
    assert torch.equal(first.min_distances, second.min_distances)


def _kernel_counts():
    return (ck.all_metrics_halfspaces.launches, cl.batched_cholesky.launches,
            cl.batched_cho_solve.launches)


def test_float64_runs_on_the_card_without_the_kernels(cuda):
    """float64 through `run_single_scenario` on the card: the closed
    forms and the plain factorisations on the device (no kernel launch,
    no error), within 1e-6 of the CPU float64 run on the same obstacles."""
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    before = _kernel_counts()
    gpu = pt.models.run_single_scenario(scenario, params, seed=42,
                                        dtype=torch.float64, device=cuda)
    assert _kernel_counts() == before
    assert gpu.filtered_u.dtype == torch.float64
    assert gpu.filtered_u.device.type == "cuda"
    assert bool(gpu.qp_converged.all())
    cpu = pt.models.run_scenario_with_obstacles(
        pt.models.make_statics(scenario, params, torch.float64, "cpu"),
        pt.simulation.ObstacleData(*(t.cpu() for t in gpu.obstacles)),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    torch.testing.assert_close(gpu.filtered_u.cpu(), cpu.filtered_u, rtol=0,
                               atol=1e-6)


def test_wrappers_still_refuse_what_the_call_sites_keep_away(cuda):
    """The dispatch lives at the call sites; a wrapper handed a CUDA
    tensor it cannot take raises as before."""
    with pytest.raises(ValueError, match="393216"):
        ck.all_metrics_halfspaces(
            torch.zeros(1, ck.MAX_N_SAMPLES + 1, 2, device=cuda),
            torch.zeros(1, 2, device=cuda), *ARGS)
    with pytest.raises(ValueError, match="393216"):
        ck.fused_drcvar_halfspace(
            torch.zeros(1, ck.MAX_N_SAMPLES + 1, 2, device=cuda),
            torch.zeros(1, 2, device=cuda), *ARGS)
    L = torch.eye(65, device=cuda).expand(2, 65, 65).contiguous()
    with pytest.raises(ValueError, match="n <= 64"):
        cl.batched_cho_solve(L, torch.zeros(2, 65, device=cuda))
    L = torch.eye(8, device=cuda).expand(2, 8, 8).contiguous()
    with pytest.raises(ValueError, match="k <= 256"):
        cl.batched_cho_solve(L, torch.zeros(2, 8, 257, device=cuda))
    with pytest.raises(TypeError):
        cl.batched_cho_solve(L.double(), torch.zeros(2, 8, device=cuda,
                                                     dtype=torch.float64))


@pytest.mark.parametrize("horizon,kernel_sizes", [(31, {62}), (33, set())])
def test_long_horizon_on_the_card(cuda, horizon, kernel_sizes):
    """Horizons whose systems outgrow the kernels run on the card in
    float32, within 1e-4 of the CPU float64 run on the same obstacles;
    at 31 the n = 62 systems still launch the kernels."""
    import dataclasses
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 horizon=horizon)
    scenario = pt.config.get_scenario_config("head_on")
    before = _kernel_counts()
    gpu = pt.models.run_single_scenario(scenario, params, seed=42,
                                        dtype=torch.float32, device=cuda)
    launched = [a - b for a, b in zip(_kernel_counts(), before)]
    assert launched[0] == 1
    assert (launched[1] > 0) == (launched[2] > 0) == bool(kernel_sizes)
    assert bool(gpu.qp_converged.all())
    cpu = pt.models.run_scenario_with_obstacles(
        pt.models.make_statics(scenario, params, torch.float64, "cpu"),
        pt.simulation.ObstacleData(*(t.cpu().double()
                                     for t in gpu.obstacles)),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    torch.testing.assert_close(gpu.filtered_u.cpu().double(), cpu.filtered_u,
                               rtol=0, atol=1e-4)


def _filter_case(device, dtype):
    """head_on on the seed-42 streams: the problem and, per metric, the
    inputs of `filter_trajectory` from the CPU float64 pipeline run."""
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("head_on")
    obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                  params.num_samples)
    run = pt.models.run_scenario_with_obstacles(
        pt.models.make_statics(scenario, params, torch.float64, "cpu"),
        pt.convert.obstacle_data(obs, torch.float64, "cpu", True),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    prob = pt.models.make_statics(scenario, params, dtype, device).mpc
    x0 = np.zeros(4)
    x0[:2] = scenario.ego_start
    return prob, run, x0


def test_filter_trajectory_on_the_card(cuda):
    """`filter_trajectory` in float32 on the card against the CPU float64
    call on the same inputs (1e-4), one metric a lane; kernels 2 and 3
    launch; a forced fallback replays u_ref exactly."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models.pipeline import (
        INPUT_BOUNDS, STATE_BOUNDS)
    results = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        prob, run, x0 = _filter_case(device, dtype)
        hs = [run.halfspaces.by_metric(m) for m in pt.models.METRICS]
        args = (np.broadcast_to(x0, (3, 4)).copy(),
                run.x_ref.expand(3, -1, -1), run.u_ref.expand(3, -1, -1),
                torch.cat([h.h for h in hs]),
                torch.cat([h.g_tilde for h in hs]))
        before = _kernel_counts()
        results[dtype] = pt.filter_trajectory(
            prob, *args, input_bounds=INPUT_BOUNDS,
            position_bounds=STATE_BOUNDS, device=device)
        launched = [a - b for a, b in zip(_kernel_counts(), before)]
        if device == "cpu":
            assert launched == [0, 0, 0]
            torch.testing.assert_close(results[dtype].u_filtered,
                                       run.filtered_u[0], rtol=0, atol=1e-9)
        else:
            assert launched[0] == 0 and min(launched[1:]) > 0, launched
            fb = pt.filter_trajectory(
                prob, *args, input_bounds=INPUT_BOUNDS,
                position_bounds=STATE_BOUNDS, max_iters=1, device=device)
            assert bool(fb.used_fallback.all())
            assert torch.equal(fb.u_filtered.cpu(),
                               run.u_ref.expand(3, -1, -1).float())
    gpu, cpu = results[torch.float32], results[torch.float64]
    assert gpu.u_filtered.device.type == "cuda"
    assert bool(gpu.status.all()) and not bool(gpu.used_fallback.any())
    torch.testing.assert_close(gpu.u_filtered.cpu().double(), cpu.u_filtered,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(gpu.x_filtered.cpu().double(), cpu.x_filtered,
                               rtol=0, atol=1e-4)


def test_solve_qp_batched_launches_the_linalg_kernels(cuda):
    """The generic IPM's float32 systems (n <= 64) reach kernels 2 and 3,
    and its answer agrees with the CPU float32 run to the solver's
    floor."""
    rng = np.random.default_rng(0)
    B, n, m = 8, 20, 40
    L = rng.normal(size=(B, n, n))
    args = [L @ L.transpose(0, 2, 1) + np.eye(n), rng.normal(size=(B, n)),
            rng.normal(size=(B, m, n)), rng.uniform(0.1, 2.0, size=(B, m))]
    before = _kernel_counts()
    sol = pt.ops.solve_qp_batched(*(torch.as_tensor(a, dtype=torch.float32,
                                                    device=cuda)
                                    for a in args))
    torch.cuda.synchronize()
    after = _kernel_counts()
    assert after[0] == before[0]
    assert after[1] > before[1] and after[2] > before[2]
    ref = pt.ops.solve_qp_batched(*(torch.as_tensor(a) for a in args))
    assert bool(sol.converged.all()) and bool(ref.converged.all())
    torch.testing.assert_close(sol.obj.cpu().double(), ref.obj, rtol=1e-3,
                               atol=0)


def test_plan_trajectory_launches_the_linalg_kernels(cuda):
    """plan_trajectory with bounds at H = 30 (n_u = 60) on the card."""
    A, B, C = pt.core.dynamics.create_double_integrator_matrices(
        0.2, dtype=torch.float32, device=cuda)
    planner = pt.models.Planner(A, B, C, 2.0, 1.0, 30, 0.2)
    lim = np.array([0.3, 0.3])
    before = _kernel_counts()
    x_ref, u_ref, info = pt.models.plan_trajectory(
        planner, [-4.0, 0.0, 0.0, 0.0], [4.0, 0.0, 0.0, 0.0],
        input_bounds=(-lim, lim),
        state_bounds=(-np.array([10.0, 10.0, 5.0, 5.0]),
                      np.array([10.0, 10.0, 5.0, 5.0])), has_bounds=True)
    torch.cuda.synchronize()
    after = _kernel_counts()
    assert after[1] > before[1] and after[2] > before[2]
    assert bool(info["converged"]) and x_ref.device.type == "cuda"
    assert float(u_ref.abs().max()) <= 0.3 + 1e-5


def test_mesh_data1_runs_on_nccl(cuda, tmp_path):
    """--mesh data=1 in one process: a NCCL group of one, set up and torn
    down by the CLI; the result equals the meshless run's."""
    import torch.distributed as dist

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
        cli)

    argv = ["--mode", "monte_carlo", "--mc_runs", "8", "--device", "cuda",
            "--preset", "paper"]
    plain = cli.main(argv + ["--save_dir", str(tmp_path / "plain")])
    pt.parallel.CENSUS.clear()
    mesh = cli.main(argv + ["--mesh", "data=1", "--save_dir",
                            str(tmp_path / "mesh")])
    assert sum(pt.parallel.CENSUS.values()) == 1
    assert not dist.is_initialized()
    assert torch.equal(mesh.min_distances, plain.min_distances)
    probe = pt.parallel.make_mesh(1, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        assert probe.device == torch.device("cuda", 0)
    finally:
        probe.close()


@pytest.mark.parametrize("B", [1, 37, 768])
def test_cho_solve_k60_against_the_identity(cuda, B):
    """Kernel 3 at k = 60 with the identity as right-hand sides (S^-1 of
    60 x 60 SPD matrices): one launch, to its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    A = torch.randn(B, 60, 60, device=cuda, generator=gen)
    L = cl.batched_cholesky(A @ A.mT + 3.0 * torch.eye(60, device=cuda))
    eye = torch.eye(60, device=cuda).expand(B, 60, 60).contiguous()
    before = cl.batched_cho_solve.launches
    x = cl.batched_cho_solve(L, eye)
    torch.cuda.synchronize()
    assert cl.batched_cho_solve.launches == before + 1
    assert _rel(x, cl.batched_cho_solve_plain(L, eye)) < 1e-5
