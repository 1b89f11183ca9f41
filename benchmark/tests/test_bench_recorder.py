"""The readers of the program's own spans and counters: what they read
from a made trace, that they read nothing where the program has no
recorder, that one reader's hook never takes what another reads, and
small CPU runs of the harness with the trace on (every new metric reads a
finite number) and off (the recorder never records)."""

import math

import pytest

import harness
from conftest import BENCH, run_small

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

NEW = ("ipm_pass_host_ms.rate", "ipm_pass_host_ms.loop",
       "ipm_sync_wait_ms.rate", "ipm_sync_wait_ms.loop",
       "ipm_lane_util.rate", "ipm_lane_util.loop",
       "polish_kept_pct.rate", "polish_kept_pct.loop", "obstacle_draw_ms")


@pytest.fixture(autouse=True)
def recorder_state():
    """Each test starts with the recorder off and empty, and leaves the
    process's recorder as it found it."""
    saved = timing.RECORDING, timing.totals()
    timing.record(False)
    timing.reset()
    yield
    timing.record(saved[0])
    timing.reset()
    timing.SPANS.update(saved[1]["spans"])
    timing.COUNTS.update(saved[1]["counts"])


def trace(**kw):
    base = dict(config={"qp_iters": 60}, traffic={}, calls=0, spans={},
                values={}, profiled_values={}, stage_device_s={},
                stage_calls={}, busy_s=0.0, window_s=0.0, profile_calls=0)
    base.update(kw)
    return harness.TraceData(**base)


def reader(name):
    return harness.metric_reader(BENCH, name)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_from_an_empty_trace(name):
    assert reader(name).read(trace()) is None
    assert timing.RECORDING          # loading a reader switched it on


def _call(spans=None, counts=None):
    return {"spans": spans or {}, "counts": counts or {}}


def test_readers_on_a_made_trace():
    ipm = [_call({"ipm.pass": [10, 0.06], "ipm.sync": [11, 0.004]},
                 {"ipm.lanes": 768, "ipm.passes": 10,
                  "ipm.lane_passes": 5376, "ipm.polish_kept": 384}),
           _call({"ipm.pass": [14, 0.10], "ipm.sync": [15, 0.002]},
                 {"ipm.lanes": 768, "ipm.passes": 14,
                  "ipm.lane_passes": 5376, "ipm.polish_kept": 0})]
    draws = [_call({"obstacles.generate": [300, 0.09]}),
             _call({"obstacles.generate": [300, 0.12]})]
    got = {}
    for name in NEW:
        mod = reader(name)
        values = draws if name == "obstacle_draw_ms" else ipm
        got[name] = mod.read(trace(values={mod.__name__: values}))
    assert got["ipm_pass_host_ms.rate"] == pytest.approx(1e3 * 0.16 / 24)
    assert got["ipm_sync_wait_ms.loop"] == pytest.approx(1e3 * 0.006 / 2)
    assert got["ipm_lane_util.rate"] == pytest.approx(
        100 * 10752 / (768 * 10 + 768 * 14))
    assert got["polish_kept_pct.loop"] == pytest.approx(25.0)
    assert got["obstacle_draw_ms"] == pytest.approx(1e3 * 0.21 / 600)


def test_without_a_recorder_the_readers_hook_nothing(monkeypatch):
    """A program without the recorder (the commit before it): no hooks,
    nothing read, no error."""
    monkeypatch.delattr(timing, "since")
    for name in NEW:
        mod = reader(name)
        assert mod.HOOKS == {} and mod.read(trace()) is None
    assert not timing.RECORDING


def test_each_reader_takes_only_its_own_difference():
    a, b = reader("ipm_pass_host_ms.rate"), reader("ipm_lane_util.rate")
    hook_a, hook_b = a.HOOKS["_filter_core"], b.HOOKS["_filter_core"]
    timing.count("ipm.passes", 3)
    assert hook_a(None, None, None)["counts"] == {"ipm.passes": 3}
    timing.count("ipm.passes", 2)
    assert hook_a(None, None, None)["counts"] == {"ipm.passes": 2}
    assert hook_b(None, None, None)["counts"] == {"ipm.passes": 5}
    assert hook_b(None, None, None) == _call()


@pytest.mark.parametrize("cell", ["multi_obstacle_n1000.batch256",
                                  "head_on_n20.mc300",
                                  "multi_obstacle_n1000.loop"])
def test_traced_run_reads_every_new_metric(cell):
    res = run_small(cell, trace=True)
    per_layer = harness.find_cell(BENCH.parent, cell).per_layer
    cell_metrics = [m["name"] for m in per_layer if m["name"] in NEW]
    assert cell_metrics
    for name in cell_metrics:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
        assert name.split(".")[0].endswith("_ms") or value <= 100.0, name


def test_untraced_run_never_records():
    res = run_small("multi_obstacle_n1000.batch256", trace=False)
    assert res["correct"]
    assert not timing.RECORDING
    assert timing.totals() == {"spans": {}, "counts": {}}
