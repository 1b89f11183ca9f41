"""PyTorch port on the paper preset's multi_obstacle deployment at N = 1500
(`benchmark/configs/paper_multi_obstacle_n1500.json`): three obstacles
alongside the ego, alpha 0.1, a 5 s simulation (26 obstacle points) under
a 30-step horizon, so the last 4 steps of every plan are padded.

On the CPU, float32, four scenarios drawn as the benchmark draws them:
the pipeline judged by the plain float64 reference of the benchmark
(`benchmark/reference.py::judge_plan`) at the limits of the existing
cells, the padding on both sides, the recorder's row and padding
counters, and the row counter of kernel 1's wrapper at the cell's shape.

Marked `cuda` (skipped where torch sees no CUDA device; the kernels have
no CPU mode), run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_paper_config.py

kernel 1's block path at the cell's shape against its plain version, at
the tolerances of tests/test_torch_cuda.py, and the paper multi_obstacle
end to end on the card against the CPU in float64 and the reference.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_kernels as ck)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

from torch_port_streams import reference_rng_obstacles

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
import inputs                      # noqa: E402  (benchmark/)
import reference as ref            # noqa: E402

CFG = json.loads((BENCH / "configs" / "paper_multi_obstacle_n1500.json").read_text())
# The existing cells' limits (set on the card from the program's and the
# control's readings).
LIMITS = json.loads((BENCH / "limits" / "multi_obstacle_n1000.batch256.json")
                    .read_text())["limits"]
S, N_HS, H, N_OBS = 4, 26, 30, 3
ROWS = S * N_HS * N_OBS                   # 312 halfspace rows a call
SEED = 2 ** 31 + 1613
ARGS = (0.1, 0.1, 0.15, 0.3, 0.3)         # alpha, delta, epsilon, radii


def _paper():
    params = dataclasses.replace(pt.config.get_parameters("paper"),
                                 num_samples=CFG["num_samples"])
    return params, pt.config.get_scenario_config("multi_obstacle", "paper")


def _run(device, dtype, pool, draw=0):
    """One pipeline call on a draw of the pool, with the recorder on and
    `_filter_core`'s halfspace inputs kept: (result, the recorder's totals
    added by the call, (hs_h, hs_g) as the QPs got them)."""
    params, scenario = _paper()
    statics = pt.models.make_statics(scenario, params, dtype, device)
    seen = {}
    core = pt.models.pipeline._filter_core

    def spy(mpc, x0, x_ref, hs_h, hs_g, *rest):
        seen["hs"] = (hs_h, hs_g)
        return core(mpc, x0, x_ref, hs_h, hs_g, *rest)

    before, was = timing.totals(), timing.record(True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pt.models.pipeline, "_filter_core", spy)
            res = pt.models.run_scenario_with_obstacles(
                statics, pt.simulation.obstacles.ObstacleData(*pool.draw(draw)),
                scenario.ego_start, scenario.ego_goal, params.ego_velocity,
                qp_iters=CFG["qp_iters"], qp_tol=CFG["qp_tol"])
    finally:
        timing.record(was)
    return res, timing.since(before), seen["hs"]


def _judge(res, pool, draw=0):
    _, samples, real = pool.draw(draw)
    start, goal = inputs.start_goal(torch, CFG, samples.shape[0], samples.device)
    return ref.judge_plan(inputs.plan_of(res), samples.double(), real.double(),
                          start, goal, CFG, res.used_fallback)


@pytest.fixture(scope="module")
def cpu_run():
    pool = inputs.make_pool(torch, CFG, 1, S, SEED, "cpu")
    return (pool,) + _run("cpu", torch.float32, pool)


def test_config_file_is_the_port_paper_preset():
    params, scenario = _paper()
    for key in ("alpha", "delta", "epsilon", "robot_radius", "obstacle_radius",
                "dt", "horizon", "q_weight", "r_weight", "ego_velocity",
                "noise_var", "num_samples"):
        assert CFG[key] == getattr(params, key), key
    assert CFG["sim_time"] == scenario.sim_time == 5.0
    np.testing.assert_array_equal(CFG["ego_start"], scenario.ego_start)
    np.testing.assert_array_equal(CFG["ego_goal"], scenario.ego_goal)
    obs = CFG["obstacles"]
    np.testing.assert_array_equal([o["start"] for o in obs], scenario.obstacle_starts)
    np.testing.assert_array_equal([o["direction"] for o in obs],
                                  scenario.obstacle_directions)
    np.testing.assert_array_equal([o["speed"] for o in obs], scenario.obstacle_speeds)
    assert CFG["reduced"] == []


def test_cpu_float32_is_judged_correct_by_the_reference(cpu_run):
    pool, res, _, _ = cpu_run
    assert res.filtered_u.shape == (S, 3, H, 2)
    assert not bool(res.used_fallback.any())
    assert bool(torch.isfinite(res.filtered_u).all())
    numbers = _judge(res, pool)
    for name, value in numbers.items():
        assert value <= LIMITS[name], (name, value, LIMITS[name])


def test_last_four_steps_are_padded_on_both_sides(cpu_run):
    pool, res, _, (hs_h, hs_g) = cpu_run
    assert res.halfspaces.mean.h.shape == (S, N_HS, N_OBS, 2)
    # the port: inactive rows into the QPs, and their slack 0 to the
    # float32 solver's tolerance (a lane whose polish is not kept reports
    # the IPM's interior iterate, ~1e-5 there), below any binding row's
    assert hs_g.shape == (S * 3, H, N_OBS)
    assert bool((hs_g[:, N_HS:] == -1e4).all())
    assert bool((hs_h[:, N_HS:] == torch.tensor([1.0, 0.0])).all())
    assert bool((hs_g[:, :N_HS] > -1e3).all())
    assert float(res.slack[:, :, N_HS:].abs().max()) < 1e-4
    assert float(res.slack[:, :, :N_HS].amax()) > 1e-2
    # the reference: the same rows, and slack 0 to its solver's tolerance
    _, samples, real = pool.draw(0)
    start, goal = inputs.start_goal(torch, CFG, S, samples.device)
    plan = ref.pipeline(samples, real, start, goal, CFG, ref.FLOAT64)
    r_h, r_g = ref.hs_for_qp(plan.h, plan.g, H, S, N_OBS, ref.FLOAT64, "cpu")
    assert bool((r_g[:, N_HS:] == -1e4).all())
    assert bool((r_h[:, N_HS:] == torch.tensor([1.0, 0.0], dtype=torch.float64)).all())
    ar = ref.FLOAT64
    mats = ref.mpc_mats(CFG, ar, "cpu")
    x_ref = ref.straight_line(start, goal, CFG["ego_velocity"], CFG["dt"], H, ar)
    qp = ref.build_qp(ref.x0_of(start, ar).repeat_interleave(3, 0),
                      x_ref.repeat_interleave(3, 0), r_h, r_g, CFG, mats, ar)
    z, _ = ref.solve_qp(qp, ar)
    slack = z[:, qp.n_u:].reshape(S * 3, H, N_OBS)
    assert float(slack[:, N_HS:].abs().max()) < 1e-8
    assert float(slack[:, :N_HS].amax()) > 1e-4      # the corridor binds


def test_one_call_counts_its_rows(cpu_run):
    _, _, counts, _ = cpu_run
    got = counts["counts"]
    assert got["filter.padded_rows"] == 4 * 3 * 4 * 3
    assert got["filter.soft_rows"] == 4 * 3 * 30 * 3
    assert got["halfspace.rows_plain"] == ROWS
    assert "halfspace.rows_warp" not in got and "halfspace.rows_block" not in got
    assert counts["spans"]["filter.pad"][0] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_rows_are_counted_once_on_either_route(dtype):
    """float32 rows reach `all_metrics_halfspaces`, which runs its plain
    version on a CPU tensor; float64 rows go to the plain version from
    `compute_safe_halfspaces_for_trajectory`. Either way once."""
    params, scenario = _paper()
    env = pt.models.make_statics(scenario, params, dtype, "cpu").env
    pool = inputs.make_pool(torch, dict(CFG, num_samples=50), 1, 2, SEED, "cpu")
    x_ref = torch.zeros((2, H + 1, 4), dtype=dtype)
    before, was = timing.totals(), timing.record(True)
    try:
        pt.simulation.environment.compute_safe_halfspaces_for_trajectory(
            env, pool.samples.to(dtype), x_ref)
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {"halfspace.rows_plain": 2 * N_HS * N_OBS}


@pytest.mark.parametrize("B,N,entry,k", [(19968, 1500, "block", 150),
                                         (23040, 1000, "warp", 100)])
def test_the_wrapper_counts_rows_under_its_plan(monkeypatch, B, N, entry, k):
    """The CUDA branch of `all_metrics_halfspaces` on shape-only (meta)
    tensors, its device check and launch stubbed: the rows are counted
    under the entry the plan gives, which is the one launched, with the
    CVaR select at k = ceil(alpha N) (`halfspace_plan`'s grid is
    tests/test_torch_halfspace_select.py's)."""
    launched = []
    monkeypatch.setattr(ck, "_check_f32_cuda", lambda *a: None)
    monkeypatch.setattr(ck._build, "launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(ck.all_metrics_halfspaces, "launches",
                        ck.all_metrics_halfspaces.launches)
    samples = torch.empty((B, N, 2), device="meta")
    ego = torch.empty((B, 2), device="meta")
    before, was = timing.totals(), timing.record(True)
    try:
        ck.all_metrics_halfspaces(samples, ego, *ARGS)
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {f"halfspace.rows_{entry}": B}
    plan = ck.halfspace_plan(B, N, True)
    assert plan.entry == entry
    (args,) = launched
    assert args[7:10] == (B, N, k)
    assert args[10:13] == (plan.values_per_lane, plan.rows_per_block,
                           plan.load_bytes)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_block_path_at_the_cell_shape_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1500)
    x = 2.0 + 0.1 * torch.randn(19968, 1500, 2, device=cuda, generator=gen)
    ego = torch.randn(19968, 2, device=cuda, generator=gen)
    before, was = timing.totals(), timing.record(True)
    try:
        out = ck.all_metrics_halfspaces(x, ego, *ARGS)
        torch.cuda.synchronize()
    finally:
        timing.record(was)
    assert timing.since(before)["counts"] == {"halfspace.rows_block": 19968}
    want = ck.all_metrics_halfspaces_plain(x, ego, *ARGS)
    for name, a, b in zip(out._fields, out, want):
        if name.startswith("h"):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-5)


@pytest.mark.cuda
def test_paper_multi_obstacle_end_to_end_on_the_card(cuda):
    """The reference's seed-42 streams of paper multi_obstacle (N = 20),
    as chip_smoke.py's [e2e] runs them: the card in float32 against the
    CPU in float64; then four of the cell's draws at N = 1500 on the
    block path, judged by the reference at the existing cells' limits."""
    params = pt.config.get_parameters("paper")
    scenario = pt.config.get_scenario_config("multi_obstacle", "paper")
    obs = reference_rng_obstacles(scenario, scenario.sim_time, params.dt,
                                  params.num_samples)
    runs = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        statics = pt.models.make_statics(scenario, params, dtype, device)
        runs[str(device)] = pt.models.run_scenario_with_obstacles(
            statics, pt.convert.obstacle_data(obs, dtype, device, True),
            scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    gpu, cpu = runs[str(cuda)], runs["cpu"]
    assert bool(gpu.qp_converged.all()) and bool(torch.isfinite(gpu.filtered_u).all())
    assert float(gpu.slack[:, :, N_HS:].abs().max()) < 1e-4
    assert float(cpu.slack[:, :, N_HS:].abs().max()) < 1e-8
    for m in pt.models.METRICS:
        torch.testing.assert_close(gpu.halfspaces.by_metric(m).g_tilde.cpu().double(),
                                   cpu.halfspaces.by_metric(m).g_tilde,
                                   atol=2e-4, rtol=1e-5)
    print(f"[e2e] paper/multi_obstacle: |u_gpu - u_cpu_f64| "
          f"{float((gpu.filtered_u.cpu().double() - cpu.filtered_u).abs().max()):.3e}")

    pool = inputs.make_pool(torch, CFG, 1, S, SEED, cuda)
    res, counts, _ = _run(cuda, torch.float32, pool)
    assert counts["counts"]["halfspace.rows_block"] == ROWS
    assert counts["counts"]["filter.padded_rows"] == 4 * 3 * 4 * 3
    assert not bool(res.used_fallback.any())
    for name, value in _judge(res, pool).items():
        assert value <= LIMITS[name], (name, value, LIMITS[name])
