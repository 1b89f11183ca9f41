"""The cell `paper_multi_obstacle_n49153.halfspaces128` and its per-layer
metrics: the cell resolves to its files and is listed by the halfspace
cell's accepted metrics (halfspace_ms, halfspace_roofline,
device_idle_pct.hs), its traffic spans the stage alone (a range nested
inside it would take its kernels out of the stage's device time), the
new reader reads a made trace right (the cluster share) and reads
nothing from a program without the counters, the limit lies between the
readings it was set from, small CPU runs of the cell are correct, traced
and untraced, and runs with the halfspace stage broken underneath
(test_bench_faults.py's half_the_rows and altered_halfspace) are not.

Importing this file adds the cell's small size to the shared table of
small sizes (`conftest.SMALL`), which the discovery and fault tests read;
it sorts before them, so they see the cell whenever the folder's tests
run together."""

import json

import pytest

import harness
import roofline
from conftest import BENCH, ROOT, SEED, SMALL, run_small

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

CELL = "paper_multi_obstacle_n49153.halfspaces128"
SMALL.setdefault(CELL, {
    "config": {"num_samples": 40},
    "traffic": {"scenarios": 4, "pool": 2, "warmup_calls": 1,
                "profile_calls": 2}})
# metric -> the reader's file
NEW = {"halfspace_cluster_pct": "halfspace_cluster_pct.py"}
# the accepted metrics of the halfspace cell that list this one too
SHARED = ("halfspace_ms", "halfspace_roofline", "device_idle_pct.hs")
STAGE = "compute_safe_halfspaces_for_trajectory"
ROWS, N = 128 * 26 * 3, 49153            # a call of the cell
EGO_FLOATS = 128 * 31 * 4                 # the straight line, [S, H+1, 4]


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
    base = dict(config={}, traffic={}, calls=0, spans={}, values={},
                profiled_values={}, stage_device_s={}, stage_calls={},
                busy_s=0.0, window_s=0.0, profile_calls=0)
    base.update(kw)
    return harness.TraceData(**base)


def _call(counts):
    return {"spans": {}, "counts": counts}


def test_the_cell_resolves_to_its_files():
    c = harness.find_cell(ROOT, CELL)
    assert c.config == json.loads(
        (BENCH / "configs" / "paper_multi_obstacle_n49153.json").read_text())
    assert c.traffic["driver"] == "halfspaces"
    assert (c.traffic["scenarios"], c.traffic["pool"]) == (128, 2)
    assert c.entry["chips"] == 1
    assert {m["name"] for m in c.end_to_end} == {"halfspace_rows_per_s",
                                                 "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(NEW) | set(SHARED)
    assert c.config["num_samples"] == N and c.config["reduced"] == []
    assert c.traffic["spans"] == [f"simulation.environment.{STAGE}"]


@pytest.mark.parametrize("name", SHARED + ("halfspace_rows_per_s",))
def test_the_halfspace_cells_metrics_list_the_cell(name):
    b = harness.load_benchmark(ROOT)
    entry = next(m for m in b["per_layer"] + b["end_to_end"]
                 if m["name"] == name)
    assert entry["workloads"] == ["multi_obstacle_n1000.halfspaces1024",
                                  CELL]


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metrics_resolve_to_readers(name):
    mod = harness.metric_reader(BENCH, name)
    assert mod.__file__.endswith(NEW[name]) and callable(mod.read)
    entry = next(m for m in harness.load_benchmark(ROOT)["per_layer"]
                 if m["name"] == name)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "halfspace_rows_per_s"


@pytest.mark.parametrize("counts,share", [
    ([{"halfspace.rows_cluster": ROWS}, {"halfspace.rows_cluster": ROWS}],
     100.0),
    ([{"halfspace.rows_cluster": 300, "halfspace.rows_block": 100},
      {"halfspace.rows_warp": 50, "halfspace.rows_plain": 50}], 60.0),
    ([{"halfspace.rows_plain": ROWS}], 0.0)])
def test_cluster_share_on_a_made_trace(counts, share):
    """The change's cell (every row on the cluster path), a mix, and the
    program before the cluster path (every long row plain)."""
    mod = harness.metric_reader(BENCH, "halfspace_cluster_pct")
    got = mod.read(trace(values={mod.__name__: [_call(c) for c in counts]}))
    assert got == pytest.approx(share)


def test_cluster_share_reads_nothing_without_the_counters():
    mod = harness.metric_reader(BENCH, "halfspace_cluster_pct")
    assert mod.read(trace()) is None
    ipm_only = [_call({"ipm.passes": 12, "ipm.lanes": 768})]
    assert mod.read(trace(values={mod.__name__: ipm_only})) is None


def test_the_stage_bound_at_the_cells_shape():
    """9,984 rows of 49,153 samples: 3.93 GB read, 1.17 ms at 3.35 TB/s."""
    f, b = roofline.halfspace_work(ROWS, N, EGO_FLOATS)
    assert b == (ROWS * N * 2 + EGO_FLOATS + ROWS * 7) * 4
    assert 3.92e9 < b < 3.93e9
    assert roofline.least_seconds(f, b) == pytest.approx(b / 3.35e12)
    assert 1.17e-3 < roofline.least_seconds(f, b) < 1.175e-3


def test_halfspace_ms_and_idle_of_the_cell_on_a_made_trace():
    ms = harness.metric_reader(BENCH, "halfspace_ms")
    idle = harness.metric_reader(BENCH, "device_idle_pct.hs")
    t = trace(stage_device_s={STAGE: 20 * 4.0e-3}, stage_calls={STAGE: 20},
              busy_s=0.09, window_s=0.1)
    assert ms.read(t) == pytest.approx(4.0)
    assert idle.read(t) == pytest.approx(10.0)
    assert ms.read(trace()) is None and idle.read(trace()) is None


def test_the_limit_lies_between_its_readings():
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    gap = limits["readings"]["halfspace_gap"]
    assert gap["lower"] < limits["limits"]["halfspace_gap"] < gap["upper"]


def test_traced_cpu_run_of_the_cell():
    """On the CPU every row takes the plain path; the device-trace metrics
    have nothing to read."""
    res = run_small(CELL, trace=True)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["halfspace_cluster_pct"] == 0.0
    for name in SHARED:
        assert name not in got, name


@pytest.mark.parametrize("fault", ["half_the_rows", "altered_halfspace"])
def test_a_broken_halfspace_stage_is_not_correct(fault, monkeypatch):
    from test_bench_faults import FAULTS
    module, name, breaker, _ = FAULTS[fault]
    monkeypatch.setattr(module, name, breaker(getattr(module, name)))
    res = run_small(CELL, seed=SEED + 1)
    assert not res["correct"], res["check"]


def test_untraced_run_is_correct_and_never_records():
    res = run_small(CELL, trace=False)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"halfspace_rows_per_s", "setup_s"}
    assert not timing.RECORDING
    assert timing.totals() == {"spans": {}, "counts": {}}
