"""PyTorch port, the whole slice in float64 against the JAX pipeline.

The four custom scenarios and the paper head_on (sim_time 3 s < the
6 s horizon: the inactive-halfspace padding path), on the reference's
seed-42 obstacle streams: controls to 1e-6, halfspaces and distances to
1e-9, the same IPM iteration counts, and the reference-parity curve
features of tests/test_reference_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models import (
    pipeline as jpipe)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.obstacles import (
    ObstacleData as JObstacleData)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

from torch_port_streams import E2E_CASES, reference_rng_obstacles

torch.set_num_threads(1)

F64 = torch.float64
METRICS = pt.models.METRICS


def _case(preset, name):
    params = pt.config.get_parameters(preset)
    scenario = pt.config.get_scenario_config(name, preset)
    sim_time = scenario.sim_time or params.sim_time
    obs = reference_rng_obstacles(scenario, sim_time, params.dt,
                                  params.num_samples)
    return params, scenario, obs


def _port_run(preset, name, dtype=F64):
    params, scenario, obs = _case(preset, name)
    statics = pt.models.make_statics(scenario, params, dtype, "cpu")
    return pt.models.run_scenario_with_obstacles(
        statics, pt.convert.obstacle_data(obs, dtype, "cpu", add_batch=True),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for preset, name in E2E_CASES:
        params, scenario, obs = _case(preset, name)
        jres = jpipe.run_scenario_with_obstacles(
            jpipe.make_statics(scenario, params, jnp.float64),
            JObstacleData(**{k: jnp.asarray(v) for k, v in obs.items()}),
            jnp.asarray(scenario.ego_start), jnp.asarray(scenario.ego_goal),
            params.ego_velocity)
        out[preset, name] = (_port_run(preset, name), jres)
    return out


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("case", E2E_CASES, ids="-".join)
def test_controls_and_solver_match_jax_f64(runs, case):
    ours, theirs = runs[case]
    assert ours.filtered_u.shape == (1,) + theirs.filtered_u.shape
    _close(ours.filtered_u[0], theirs.filtered_u, 1e-6)
    _close(ours.filtered_x[0], theirs.filtered_x, 1e-6)
    _close(ours.x_ref[0], theirs.x_ref, 1e-12)
    _close(ours.u_ref[0], theirs.u_ref, 1e-12)
    assert ours.qp_converged[0].tolist() == \
        np.asarray(theirs.qp_converged).tolist() == [True] * 3
    assert ours.qp_iterations[0].tolist() == \
        np.asarray(theirs.qp_iterations).tolist()
    np.testing.assert_allclose(ours.objective[0].numpy(),
                               np.asarray(theirs.objective), rtol=1e-9)


@pytest.mark.parametrize("case", E2E_CASES, ids="-".join)
def test_halfspaces_and_distances_match_jax_f64(runs, case):
    ours, theirs = runs[case]
    for m in METRICS:
        _close(ours.halfspaces.by_metric(m).h[0],
               theirs.halfspaces.by_metric(m).h, 1e-9)
        _close(ours.halfspaces.by_metric(m).g_tilde[0],
               theirs.halfspaces.by_metric(m).g_tilde, 1e-9)
    _close(ours.distances[0], theirs.distances, 1e-9)
    _close(ours.reference_distance[0], theirs.reference_distance, 1e-9)


def test_paper_head_on_takes_the_padding_path(runs):
    ours, _ = runs["paper", "head_on"]
    params = pt.config.get_parameters("paper")
    # 3 s at dt 0.2: obstacle data for t = 0..15, horizon 30.
    assert ours.halfspaces.mean.h.shape[1] == 16 < params.horizon
    # Padded rows never bind: their slack stays 0.
    assert float(ours.slack[0, :, 16:].abs().max()) == 0.0


def test_batch_of_scenarios_equals_single_runs():
    """Three scenarios with one obstacle each, run as ONE batch of S = 3
    (9 QPs), give each scenario's own single run: lanes are independent,
    including their iteration counts."""
    names = ("head_on", "overtaking", "intersection")
    singles = [_port_run("custom", n) for n in names]
    cases = [_case("custom", n) for n in names]
    params = cases[0][0]
    obs = {k: np.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    statics = pt.models.make_statics(cases[0][1], params, F64, "cpu")
    batch = pt.models.run_scenario_with_obstacles(
        statics, pt.convert.obstacle_data(obs, F64, "cpu"),
        np.stack([c[1].ego_start for c in cases]),
        np.stack([c[1].ego_goal for c in cases]), params.ego_velocity)
    for i, single in enumerate(singles):
        assert batch.qp_iterations[i].tolist() == \
            single.qp_iterations[0].tolist()
        _close(batch.filtered_u[i], single.filtered_u[0], 1e-12)
        _close(batch.distances[i], single.distances[0], 1e-12)


def test_run_single_scenario_generates_and_converges():
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    res = pt.models.run_single_scenario(scenario, params, seed=0, dtype=F64,
                                        device="cpu")
    assert res.obstacles.samples.shape == (1, 3, 20, 151, 2)
    assert res.wall_time_ms > 0
    assert bool(res.qp_converged.all())
    assert not bool(res.used_fallback.any())
    assert bool(torch.isfinite(res.distances).all())
    again = pt.models.run_single_scenario(scenario, params, seed=0,
                                          dtype=F64, device="cpu")
    assert torch.equal(again.filtered_u, res.filtered_u)


# --- reference-parity curve features (tests/test_reference_parity.py) ---

def test_reference_curve_features(runs):
    run, _ = runs["custom", "head_on"]
    for i in range(3):
        assert float(run.distances[0, i, 0]) == pytest.approx(7.4, abs=1e-9)
    ref = run.reference_distance[0].numpy()
    assert float(ref[0]) == pytest.approx(7.4, abs=1e-9)
    assert 15 <= int(ref.argmin()) <= 17
    assert -0.60 <= ref.min() <= -0.40


def test_dr_cvar_curve_features(runs):
    run, _ = runs["custom", "head_on"]
    d = run.distance_for("dr_cvar")[0].numpy()
    cv = run.distance_for("cvar")[0].numpy()
    assert 14 <= int(d.argmin()) <= 18
    assert -0.442 <= d.min() <= -0.342
    assert d.min() >= cv.min() - 1e-6
    assert 5.3 <= d[30] <= 6.3


def test_mean_and_cvar_curve_features(runs):
    run, _ = runs["custom", "head_on"]
    d = run.distance_for("mean")[0].numpy()
    assert 18 <= int(d.argmin()) <= 23
    assert -0.30 <= d.min() <= 0.10
    d = run.distance_for("cvar")[0].numpy()
    assert 14 <= int(d.argmin()) <= 18
    assert -0.55 <= d.min() <= -0.15
