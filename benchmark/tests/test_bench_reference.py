"""The benchmark's plain reference against the program's plain CPU path at
small sizes, in float64: the straight line, the halfspaces, the QP's
optimum, the rollout and distances, and the Monte Carlo study's draws;
and the comparisons that judge the program's outputs."""

import math

import numpy as np
import pytest
import torch

import harness
import inputs
import reference as ref
from conftest import ROOT

PT = pytest.importorskip(harness.PORT)
F64 = torch.float64


@pytest.fixture(scope="module")
def cell():
    return harness.find_cell(ROOT, "multi_obstacle_n1000.batch256",
                             {"config": {"num_samples": 30}})


@pytest.fixture(scope="module")
def ctx(cell):
    return harness.make_ctx(cell, 11, "cpu", torch)


@pytest.fixture(scope="module")
def draws(cell):
    pool = inputs.make_pool(torch, cell.config, 1, 5, 123, "cpu")
    return pool.draw(0)


def port64(ctx, draws):
    statics = PT.models.make_statics(ctx.scenario, ctx.params, F64, "cpu")
    return PT.models.pipeline.run_scenario_with_obstacles(
        statics, PT.simulation.obstacles.ObstacleData(
            *(t.double() for t in draws)),
        ctx.scenario.ego_start, ctx.scenario.ego_goal, ctx.params.ego_velocity,
        qp_iters=60)


def test_straight_line_matches_the_port(cell, ctx):
    cfg = cell.config
    start, goal = inputs.start_goal(torch, cfg, 2, "cpu")
    got = ref.straight_line(start, goal, cfg["ego_velocity"], cfg["dt"],
                            cfg["horizon"], ref.FLOAT64)
    statics = PT.models.make_statics(ctx.scenario, ctx.params, F64, "cpu")
    want, _, _ = PT.models.planner.straight_line_trajectory(
        statics.planner, start, goal, cfg["ego_velocity"])
    assert torch.allclose(got, want, atol=1e-12)


def test_pipeline_matches_the_port_in_float64(cell, ctx, draws):
    nominal, samples, real = draws
    cfg = cell.config
    start, goal = inputs.start_goal(torch, cfg, 5, "cpu")
    res = port64(ctx, draws)
    plan = ref.pipeline(samples.double(), real.double(), start, goal, cfg,
                        ref.FLOAT64)
    for m in ref.METRICS:
        assert torch.allclose(plan.h[m], res.halfspaces.by_metric(m).h, atol=1e-9)
        assert torch.allclose(plan.g[m], res.halfspaces.by_metric(m).g_tilde, atol=1e-9)
    # u is weakly determined along flat directions of the objective (its
    # curvature is at least 2 r_w): compare u loosely and the objective
    # tightly, the reference being at least as good.
    assert (plan.u - res.filtered_u).abs().max() < 2e-3
    qp_obj = ref.judge_plan(plan, samples.double(), real.double(), start, goal, cfg)
    assert qp_obj["plan_gap"] < 1e-6
    assert (plan.distances - res.distances).abs().max() < 5e-3
    assert torch.allclose(plan.reference_distance, res.reference_distance, atol=1e-12)


def test_judge_reads_zero_for_float64_and_the_float_floor_for_float32(cell, ctx, draws):
    _, samples, real = draws
    cfg = cell.config
    start, goal = inputs.start_goal(torch, cfg, 5, "cpu")
    nums64 = ref.judge_plan(inputs.plan_of(port64(ctx, draws)), samples.double(),
                            real.double(), start, goal, cfg)
    assert nums64["halfspace_gap"] < 1e-10 and nums64["distance_gap"] < 1e-10
    assert nums64["plan_gap"] < 1e-7
    statics = PT.models.make_statics(ctx.scenario, ctx.params, torch.float32, "cpu")
    res32 = PT.models.pipeline.run_scenario_with_obstacles(
        statics, PT.simulation.obstacles.ObstacleData(*draws),
        ctx.scenario.ego_start, ctx.scenario.ego_goal, ctx.params.ego_velocity,
        qp_iters=60, qp_tol=3e-5)
    nums32 = ref.judge_plan(inputs.plan_of(res32), samples.double(), real.double(),
                            start, goal, cfg)
    assert 1e-9 < nums32["halfspace_gap"] < 5e-5
    assert nums32["plan_gap"] < 5e-2 and nums32["distance_gap"] < 2e-4


def test_halfspace_gap_judges_direction_norm_and_offset(cell, draws):
    _, samples, _ = draws
    cfg = cell.config
    rows = ref.sample_rows(samples.double(), 30)[:40]
    ego = torch.randn(40, 2, dtype=F64)
    h, g = ref.halfspaces(rows, ego, cfg, ref.FLOAT64)
    assert ref.halfspace_gap(rows, ego, h, g, cfg) < 1e-12
    flipped = dict(h, cvar=-h["cvar"])
    assert ref.halfspace_gap(rows, ego, flipped, g, cfg) > 1e-3
    longer = dict(h, mean=1.001 * h["mean"])
    mean_norm = float(rows.mean(-2).norm(dim=-1).max())
    assert ref.halfspace_gap(rows, ego, longer, g, cfg) == pytest.approx(1e-3 * mean_norm, rel=1e-3)
    shifted = dict(g, dr_cvar=g["dr_cvar"] + 1e-4)
    assert ref.halfspace_gap(rows, ego, h, shifted, cfg) == pytest.approx(1e-4, rel=1e-3)
    nan = dict(g, mean=g["mean"].clone())
    nan["mean"][3] = math.nan
    assert ref.halfspace_gap(rows, ego, h, nan, cfg) == math.inf


def test_cvar_matches_the_linear_program_form():
    x = torch.tensor([[5.0, 1.0, 3.0, 2.0, 4.0, 0.0, 3.0]], dtype=F64)
    for alpha in (0.1, 0.2, 0.5, 0.3):
        an = alpha * 7
        taus = torch.linspace(-1, 6, 70001, dtype=F64)
        lp = (taus + torch.relu(x[0][:, None] - taus).sum(0) / an).min()
        got = ref._cvar_neg_proj(-x[:, :, None] * torch.tensor([1.0, 0.0], dtype=F64),
                                 torch.tensor([[1.0, 0.0]], dtype=F64), alpha, ref.FLOAT64)
        assert float(got) == pytest.approx(float(lp), abs=1e-4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0e-3], dtype=torch.float32)
    r = ref.round_tf32(x)
    assert r[0] == x[0] and r[1] == 1.0
    assert abs(float(r[2]) / 3.0e-3 - 1) < 2 ** -11


def test_mc_redraw_is_the_studys_draw(ctx):
    cfg = dict(ctx.config, num_samples=7)
    seeds = ref.mc_run_seeds(2 ** 31 + 3, 4)
    assert seeds == PT.evaluation.monte_carlo.run_seeds(2 ** 31 + 3, 4)
    params = ctx.params.__class__(**{**ctx.params.__dict__, "num_samples": 7})
    statics = PT.models.make_statics(ctx.scenario, params, torch.float32, "cpu")
    obs = PT.evaluation.monte_carlo.run_obstacles(statics, seeds, ctx.scenario,
                                                  params, 12)
    noise, lap = ref.mc_redraw(seeds, cfg, 12, "cpu")
    o = cfg["obstacles"]
    nominal = ref.nominal_paths([x["start"] for x in o], [x["direction"] for x in o],
                                [x["speed"] for x in o], 12, cfg["dt"], F64, "cpu")
    assert (obs.samples.double() - (noise.double() + nominal[:, None])).abs().max() < 1e-5
    assert (obs.realization.double() - (lap.double() + nominal)).abs().max() < 1e-5


def test_pool_follows_the_documented_law(cell):
    cfg = dict(cell.config, num_samples=400)
    pool = inputs.make_pool(torch, cfg, 2, 3, 7, "cpu")
    nominal, samples, real = pool.draw(1)
    noise = (samples - nominal[:, :, None])[..., 1:, :]
    assert float(noise.var()) == pytest.approx(cfg["noise_var"], rel=0.02)
    assert float(noise.mean()).__abs__() < 1e-3
    lap = (real - nominal)[..., 1:, :].double()
    assert float(lap.var()) == pytest.approx(cfg["noise_var"], rel=0.15)
    assert (samples[..., 0, :] == nominal[:, :, None, 0, :]).all()
    again = inputs.make_pool(torch, cfg, 2, 3, 7, "cpu")
    assert torch.equal(again.samples, pool.samples)
    assert not torch.equal(inputs.make_pool(torch, cfg, 2, 3, 8, "cpu").samples,
                           pool.samples)


def test_plan_objective_of_the_optimum_is_the_optimum(cell, draws):
    _, samples, real = draws
    cfg = cell.config
    start, goal = inputs.start_goal(torch, cfg, 5, "cpu")
    ar = ref.FLOAT64
    x_ref = ref.straight_line(start, goal, cfg["ego_velocity"], cfg["dt"], 30, ar)
    mats = ref.mpc_mats(cfg, ar, "cpu")
    h, g = ref.halfspaces(ref.sample_rows(samples.double(), 30),
                          ref.ego_rows(x_ref, 30, 3), cfg, ar)
    hs_h, hs_g = ref.hs_for_qp({m: v.reshape(5, 30, 3, 2) for m, v in h.items()},
                               {m: v.reshape(5, 30, 3) for m, v in g.items()},
                               30, 5, 3, ar, "cpu")
    qp = ref.build_qp(ref.x0_of(start, ar).repeat_interleave(3, 0),
                      x_ref.repeat_interleave(3, 0), hs_h, hs_g, cfg, mats, ar)
    z, f = ref.solve_qp(qp, ar)
    fu, viol = ref.plan_objective(qp, z[:, :qp.n_u])
    assert torch.allclose(fu, f, rtol=1e-6) and float(viol.max()) < 1e-7
    worse, _ = ref.plan_objective(qp, z[:, :qp.n_u] + 1e-2)
    assert (worse > f).all()
    np.testing.assert_array_less(-1e-8, qp.hb - (qp.G @ z[..., None])[..., 0])
