"""PyTorch port, the whole slice in float32 (the card's dtype) against
the JAX pipeline in float32, on head_on and multi_obstacle with the
seed-42 streams: controls to 1e-4.  (Each JAX scenario and dtype is a
fresh compile on the CPU, so the float32 cases are kept to two.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models import (
    pipeline as jpipe)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.obstacles import (
    ObstacleData as JObstacleData)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

from torch_port_streams import reference_rng_obstacles

torch.set_num_threads(1)

SCENARIOS = ("head_on", "multi_obstacle")


@pytest.fixture(scope="module")
def runs():
    params = pt.config.get_parameters("custom")
    out = {}
    for name in SCENARIOS:
        scenario = pt.config.get_scenario_config(name)
        obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                      params.num_samples)
        ours = pt.models.run_scenario_with_obstacles(
            pt.models.make_statics(scenario, params, torch.float32),
            pt.convert.obstacle_data(obs, torch.float32, add_batch=True),
            scenario.ego_start, scenario.ego_goal, params.ego_velocity)
        theirs = jpipe.run_scenario_with_obstacles(
            jpipe.make_statics(scenario, params, jnp.float32),
            JObstacleData(**{k: jnp.asarray(v, jnp.float32)
                             for k, v in obs.items()}),
            jnp.asarray(scenario.ego_start), jnp.asarray(scenario.ego_goal),
            params.ego_velocity)
        out[name] = (ours, theirs)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("metric", pt.models.METRICS)
def test_controls_match_jax_f32(runs, scenario, metric):
    ours, theirs = runs[scenario]
    mi = pt.models.METRICS.index(metric)
    assert ours.filtered_u.dtype == torch.float32
    assert bool(ours.qp_converged[0, mi]) and bool(theirs.qp_converged[mi])
    dev = np.abs(ours.filtered_u[0, mi].numpy()
                 - np.asarray(theirs.filtered_u[mi])).max()
    assert dev < 1e-4, f"f32 deviation {dev:.3e}"


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_halfspaces_match_jax_f32(runs, scenario):
    """The plain all-metrics form against the JAX float32 closed forms
    (its CPU path): h to 1e-5, g to 2e-4 (the kernel tolerances)."""
    ours, theirs = runs[scenario]
    for m in pt.models.METRICS:
        np.testing.assert_allclose(ours.halfspaces.by_metric(m).h[0].numpy(),
                                   np.asarray(theirs.halfspaces.by_metric(m).h),
                                   atol=1e-5)
        np.testing.assert_allclose(
            ours.halfspaces.by_metric(m).g_tilde[0].numpy(),
            np.asarray(theirs.halfspaces.by_metric(m).g_tilde),
            atol=2e-4, rtol=1e-5)
