"""PyTorch port, end-to-end control deviation against the independent
scipy oracle (tests/oracle.py), as tests/test_e2e_control_deviation.py
holds the JAX pipeline: head_on on the seed-42 streams; the oracle
solves the identical QP on the float64 halfspaces.  Float64 controls
within 1e-6, float32 within 1e-4.  multi_obstacle is in
test_torch_pipeline_oracle_multi.py: the oracle takes ~8 s a solve, so
xdist runs the two scenarios on two workers."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

from torch_port_streams import oracle_controls, reference_rng_obstacles

torch.set_num_threads(1)

METRICS = pt.models.METRICS
TOL = {torch.float64: 1e-6, torch.float32: 1e-4}
DTYPES = pytest.mark.parametrize("dtype", list(TOL), ids=["f64", "f32"])


def oracle_runs(name):
    """Port runs in both dtypes and the oracle's controls, for one custom
    scenario."""
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config(name)
    obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                  params.num_samples)
    runs = {dtype: pt.models.run_scenario_with_obstacles(
                pt.models.make_statics(scenario, params, dtype, "cpu"),
                pt.convert.obstacle_data(obs, dtype, "cpu",
                                         add_batch=True),
                scenario.ego_start, scenario.ego_goal, params.ego_velocity)
            for dtype in TOL}
    res64 = runs[torch.float64]
    halfspaces = {m: (res64.halfspaces.by_metric(m).h[0].numpy(),
                      res64.halfspaces.by_metric(m).g_tilde[0].numpy())
                  for m in METRICS}
    # One BLAS thread: trust-constr makes many small LAPACK calls, and
    # OpenBLAS's thread pool beside the other test workers made each
    # solve ~5x slower (2.3 s against 11.7 s, measured).
    with threadpool_limits(limits=1, user_api="blas"):
        return runs, oracle_controls(params, scenario,
                                     res64.x_ref[0].numpy(), halfspaces)


def check_deviation(runs, oracles, dtype, metric):
    res = runs[dtype]
    mi = METRICS.index(metric)
    assert bool(res.qp_converged[0, mi])
    dev = np.abs(res.filtered_u[0, mi].double().numpy()
                 - oracles[metric]).max()
    assert dev < TOL[dtype], f"{dtype} deviation {dev:.3e}"


@pytest.fixture(scope="module")
def head_on():
    return oracle_runs("head_on")


@DTYPES
@pytest.mark.parametrize("metric", METRICS)
def test_control_deviation_vs_oracle(head_on, dtype, metric):
    check_deviation(*head_on, dtype, metric)
