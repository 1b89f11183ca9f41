"""The reader of `ipm_fused_pct`: the share of the IPM's passes run on the
fused pass kernels, read from the program's counters `ipm.fused_passes`
and `ipm.passes`; nothing where the program counts no fused pass (its
CPU path, or a program without the fused kernels), and nothing without a
recorder."""

import pytest

import harness
from conftest import BENCH, run_small

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

NAMES = ("ipm_fused_pct.rate", "ipm_fused_pct.loop")


@pytest.fixture(autouse=True)
def recorder_state():
    saved = timing.RECORDING, timing.totals()
    timing.record(False)
    timing.reset()
    yield
    timing.record(saved[0])
    timing.reset()
    timing.SPANS.update(saved[1]["spans"])
    timing.COUNTS.update(saved[1]["counts"])


def trace(values):
    return harness.TraceData(
        config={}, traffic={}, calls=0, spans={}, values=values,
        profiled_values={}, stage_device_s={}, stage_calls={}, busy_s=0.0,
        window_s=0.0, profile_calls=0)


def _call(counts):
    return {"spans": {}, "counts": counts}


@pytest.mark.parametrize("name", NAMES)
def test_reads_the_share_of_fused_passes(name):
    mod = harness.metric_reader(BENCH, name)
    calls = [_call({"ipm.passes": 12, "ipm.graph_passes": 12,
                    "ipm.fused_passes": 12}),
             _call({"ipm.passes": 8, "ipm.graph_passes": 8,
                    "ipm.fused_passes": 4})]
    assert mod.read(trace({mod.__name__: calls})) == pytest.approx(80.0)


@pytest.mark.parametrize("name", NAMES)
def test_reads_nothing_without_fused_passes(name):
    """The parent's program: graph passes, no fused pass counter."""
    mod = harness.metric_reader(BENCH, name)
    assert mod.read(trace({})) is None
    graphed = [_call({"ipm.passes": 12, "ipm.graph_passes": 12})]
    assert mod.read(trace({mod.__name__: graphed})) is None


def test_without_a_recorder_it_hooks_nothing(monkeypatch):
    monkeypatch.delattr(timing, "since")
    mod = harness.metric_reader(BENCH, "ipm_fused_pct.rate")
    assert mod.HOOKS == {} and mod.read(trace({})) is None


@pytest.mark.parametrize("cell", ["head_on_n20.mc300",
                                  "multi_obstacle_n1000.loop"])
def test_a_traced_cpu_run_leaves_it_out(cell):
    """The CPU runs the plain pass: the traced line has no fused share,
    and the run is correct."""
    res = run_small(cell, trace=True)
    assert res["correct"]
    assert not any(k.startswith("ipm_fused_pct") for k in res["metrics"])
    assert "ipm_passes.rate" in res["metrics"] or \
        "ipm_passes.loop" in res["metrics"]
