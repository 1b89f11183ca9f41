"""PyTorch port: the recorder of the port's own spans and counters
(utils/timing.py) and where the pipeline records them.

Off, a run records nothing and opens no profiler range; on, the IPM's
counters agree exactly with the iterations the solve returns, the
controls are bit-equal to a run with it off, a Monte Carlo study draws
once a run, and `trace` writes the spans beside the Chrome trace.
"""

import json

import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation.obstacles import (
    generate_obstacle_scenarios)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

torch.set_num_threads(1)

F32 = torch.float32
SPANS = ("ipm.pass", "ipm.residuals", "ipm.factor", "ipm.newton",
         "ipm.step", "ipm.sync", "ipm.polish", "ipm.finalize",
         "filter.assemble", "halfspace.rows", "halfspace.solve",
         "obstacles.generate")


@pytest.fixture(autouse=True)
def recorder_state():
    """Each test starts with the recorder off and empty; the process's
    recorder is put back as it was (xdist runs a file's tests in one
    process)."""
    saved = timing.RECORDING, timing.totals()
    timing.record(False)
    timing.reset()
    yield
    timing.record(saved[0])
    timing.reset()
    timing.SPANS.update(saved[1]["spans"])
    timing.COUNTS.update(saved[1]["counts"])


@pytest.fixture(scope="module")
def case():
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    statics = pt.models.make_statics(scenario, params, F32, "cpu")
    return params, scenario, statics


def _run(case, qp_iters=60):
    params, scenario, statics = case
    as_t = lambda v: torch.as_tensor(v, dtype=F32)   # noqa: E731
    obstacles = generate_obstacle_scenarios(
        torch.Generator().manual_seed(7), as_t(scenario.obstacle_starts),
        as_t(scenario.obstacle_directions), as_t(scenario.obstacle_speeds),
        int(params.sim_time / params.dt), params.dt, params.num_samples,
        params.noise_var, n_scenarios=2)
    return pt.models.run_scenario_with_obstacles(
        statics, obstacles, scenario.ego_start, scenario.ego_goal,
        params.ego_velocity, qp_iters=qp_iters)


def test_recorder_off_records_nothing_and_opens_no_range(case):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(case)
    assert timing.totals() == {"spans": {}, "counts": {}}
    names = {e.name for e in prof.events()}
    assert not names & set(SPANS)


@pytest.mark.parametrize("qp_iters", [60, 4])
def test_recorder_counts_the_ipm_exactly(case, qp_iters):
    off = _run(case, qp_iters)
    timing.record(True)
    on = _run(case, qp_iters)
    totals = timing.totals()
    timing.record(False)
    assert torch.equal(on.filtered_u, off.filtered_u)
    assert torch.equal(on.qp_iterations, off.qp_iterations)

    its = on.qp_iterations.flatten()
    counts, spans = totals["counts"], totals["spans"]
    passes = min(int(its.max()) + 1, qp_iters)
    assert counts["ipm.lanes"] == its.numel() == 6
    assert counts["ipm.passes"] == passes
    assert counts["ipm.lane_passes"] == int(
        torch.clamp(its + 1, max=qp_iters).sum())
    assert 0 <= counts.get("ipm.polish_kept", 0) <= counts["ipm.lanes"]
    assert spans["ipm.pass"][0] == passes
    assert spans["ipm.sync"][0] == passes + 1
    assert spans["ipm.newton"][0] == 2 * passes
    for name in ("ipm.residuals", "ipm.factor", "ipm.step"):
        assert spans[name][0] == passes, name
    for name in ("ipm.polish", "ipm.finalize", "filter.assemble",
                 "halfspace.rows", "halfspace.solve"):
        assert spans[name][0] == 1, name
    assert all(s >= 0.0 for _, s in spans.values())


def test_monte_carlo_draws_once_a_run(case):
    params, scenario, statics = case
    timing.record(True)
    pt.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=5, seed=3, device="cpu", statics=statics,
        chunk_size=3)
    totals = timing.totals()
    assert totals["spans"]["obstacles.generate"][0] == 5
    assert totals["counts"]["ipm.lanes"] == 5 * 3
    assert totals["spans"]["filter.assemble"][0] == 2


def test_trace_writes_spans_and_the_program_ranges(case, tmp_path):
    with pt.utils.trace(str(tmp_path)):
        _run(case)
    assert not timing.RECORDING
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["counts"]["ipm.lanes"] == 6
    assert set(spans["spans"]) == set(SPANS)
    names = {e.get("name") for e in
             json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"ipm.pass", "ipm.sync", "halfspace.rows"} <= names


def test_totals_since_and_counters():
    timing.count("x", 5)                  # off: dropped
    assert timing.totals() == {"spans": {}, "counts": {}}
    assert timing.record(True) is False
    before = timing.totals()
    timing.count("x", 2)
    with timing.annotate("y"):
        pass
    added = timing.since(before)
    assert added["counts"] == {"x": 2} and added["spans"]["y"][0] == 1
    assert timing.since(timing.totals()) == {"spans": {}, "counts": {}}
    assert timing.record(False) is True
    assert timing.annotate("y") is timing.annotate("z")   # the shared no-op
    timing.reset()
    assert timing.totals() == {"spans": {}, "counts": {}}
