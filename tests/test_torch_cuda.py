"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device (a CUDA
kernel has no CPU mode).  Run on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_cuda.py

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


@pytest.mark.parametrize("B,N", [(2304, 1000), (7, 20), (5, 4096),
                                 (13, 1001)])
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
                                 (64, 64), (33, 1)])
def test_select_bit_equal_to_kthvalue(cuda, N, k):
    gen = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(64, N, device=cuda, generator=gen)
    x[:8] = torch.round(x[:8])                # heavy ties, signed zeros
    x[8:16] = x[8:16, :1]                     # constant rows
    v = ck.kth_largest(x, k)
    ref = torch.kthvalue(x, N - k + 1, dim=-1).values
    assert torch.equal(v, ref)                # -0.0 == +0.0


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
