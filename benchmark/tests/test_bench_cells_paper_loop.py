"""The cells `paper_multi_obstacle_n1500.batch256` and `head_on_n20.loop`
and their four new per-layer metrics: each resolves to files by name,
the readers of the program's row and padding counters read a made trace
right and read nothing from a program without the counters, and small
CPU runs of both cells are correct, traced and untraced.

Importing this file adds the two cells' small sizes to the shared table
of small sizes (`conftest.SMALL`), which the discovery and fault tests
read; it sorts before them, so they see the cells whenever the folder's
tests run together."""

import json
import math

import pytest

import harness
from conftest import BENCH, ROOT, SMALL, run_small

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

PAPER = "paper_multi_obstacle_n1500.batch256"
LOOP = "head_on_n20.loop"
SMALL.setdefault(PAPER, {
    "config": {"num_samples": 40},
    "traffic": {"scenarios": 4, "pool": 2, "warmup_calls": 1,
                "profile_calls": 1}})
SMALL.setdefault(LOOP, {
    "traffic": {"pool": 4, "warmup_calls": 1, "profile_calls": 1,
                "check_calls": 4}})
# metric -> the reader's file
NEW = {"halfspace_block_pct.rate": "halfspace_block_pct.py",
       "soft_pad_pct.rate": "soft_pad_pct.py",
       "halfspace_ms.rate": "halfspace_ms.py",
       "halfspace_block_roofline": "halfspace_block_roofline.py"}


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


def _call(counts):
    return {"spans": {}, "counts": counts}


@pytest.mark.parametrize("cell", [PAPER, LOOP])
def test_new_cells_resolve_to_their_files(cell):
    c = harness.find_cell(ROOT, cell)
    config, traffic = cell.split(".")
    assert c.config == json.loads(
        (BENCH / "configs" / f"{config}.json").read_text())
    assert c.traffic["driver"] == traffic.rstrip("0123456789")
    assert (BENCH / "limits" / f"{cell}.json").exists() and c.limits
    assert c.entry["chips"] == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e == ({"scenarios_per_s", "setup_s"} if cell == PAPER
                   else {"plan_p50_ms", "plan_p95_ms", "setup_s"})
    suffix = ".rate" if cell == PAPER else ".loop"
    same = {m["name"] for m in harness.find_cell(
        ROOT, "multi_obstacle_n1000." + traffic).per_layer
        if m["name"].endswith(suffix)}
    assert same <= {m["name"] for m in c.per_layer}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metrics_resolve_to_readers(name):
    mod = harness.metric_reader(BENCH, name)
    assert mod.__file__.endswith(NEW[name]) and callable(mod.read)
    entry = next(m for m in harness.load_benchmark(ROOT)["per_layer"]
                 if m["name"] == name)
    assert entry["workloads"] == [PAPER]
    assert entry["moves"] == "scenarios_per_s"


def test_the_paper_config_is_not_cut():
    cfg = harness.find_cell(ROOT, PAPER).config
    assert cfg["reduced"] == [] and cfg["num_samples"] == 1500
    assert cfg["alpha"] == 0.1 and cfg["sim_time"] == 5.0
    assert int(cfg["sim_time"] / cfg["dt"]) + 1 < cfg["horizon"]


@pytest.mark.parametrize("counts,share", [
    ([{"halfspace.rows_block": 19968}, {"halfspace.rows_block": 19968}], 100.0),
    ([{"halfspace.rows_block": 300, "halfspace.rows_warp": 100},
      {"halfspace.rows_plain": 100}], 60.0),
    ([{"halfspace.rows_warp": 23040}], 0.0)])
def test_block_share_on_a_made_trace(counts, share):
    mod = harness.metric_reader(BENCH, "halfspace_block_pct.rate")
    got = mod.read(trace(values={mod.__name__: [_call(c) for c in counts]}))
    assert got == pytest.approx(share)


@pytest.mark.parametrize("counts,share", [
    ([{"filter.soft_rows": 69120, "filter.padded_rows": 9216}] * 3, 100 * 4 / 30),
    ([{"filter.soft_rows": 100, "filter.padded_rows": 0},
      {"filter.soft_rows": 300, "filter.padded_rows": 100}], 25.0)])
def test_pad_share_on_a_made_trace(counts, share):
    mod = harness.metric_reader(BENCH, "soft_pad_pct.rate")
    got = mod.read(trace(values={mod.__name__: [_call(c) for c in counts]}))
    assert got == pytest.approx(share)


@pytest.mark.parametrize("name", ["halfspace_block_pct.rate",
                                  "soft_pad_pct.rate"])
def test_counter_readers_read_nothing_without_the_counters(name):
    """A program that counts neither rows nor soft rows (the commit before
    these counters): nothing read, no error."""
    mod = harness.metric_reader(BENCH, name)
    assert mod.read(trace()) is None
    ipm_only = [_call({"ipm.passes": 12, "ipm.lanes": 768})]
    assert mod.read(trace(values={mod.__name__: ipm_only})) is None


def test_block_roofline_reads_what_halfspace_roofline_reads():
    mine = harness.metric_reader(BENCH, "halfspace_block_roofline")
    base = harness.metric_reader(BENCH, "halfspace_roofline")
    shapes = [(19968, 1500, 256 * 31 * 4)] * 2
    kw = dict(stage_device_s={"compute_safe_halfspaces_for_trajectory": 0.9e-3},
              stage_calls={"compute_safe_halfspaces_for_trajectory": 2})
    got = mine.read(trace(profiled_values={mine.__name__: shapes}, **kw))
    want = base.read(trace(profiled_values={base.__name__: shapes}, **kw))
    assert got == pytest.approx(want) and 0 < got <= 100
    assert mine.read(trace(**kw)) is None


def test_traced_cpu_run_of_the_paper_cell():
    """On the CPU every row takes the plain path and 4 of the horizon's 30
    steps are padded; the device-trace metrics have nothing to read."""
    res = run_small(PAPER, trace=True)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["soft_pad_pct.rate"] == pytest.approx(100 * 4 / 30)
    assert got["halfspace_block_pct.rate"] == 0.0
    assert "halfspace_ms.rate" not in got
    assert "halfspace_block_roofline" not in got
    assert got["ipm_passes.rate"] >= 1


def test_traced_cpu_run_of_the_head_on_loop():
    res = run_small(LOOP, trace=True)
    assert res["correct"], res["check"]
    per_layer = harness.find_cell(ROOT, LOOP).per_layer
    for name in (m["name"] for m in per_layer):
        if name in res["metrics"]:
            value = res["metrics"][name]["value"]
            assert math.isfinite(value) and value >= 0, name
    for name in ("filter_core_ms.loop", "ipm_passes.loop",
                 "ipm_lane_util.loop", "polish_kept_pct.loop"):
        assert name in res["metrics"], name


@pytest.mark.parametrize("cell", [PAPER, LOOP])
def test_untraced_runs_are_correct_and_never_record(cell):
    res = run_small(cell, trace=False)
    assert res["correct"], res["check"]
    assert res["failed"] == 0
    assert not timing.RECORDING
    assert timing.totals() == {"spans": {}, "counts": {}}
