"""The harness finds cells, configurations, traffic, limits, drivers and
per-layer readers by the names in BENCHMARK.json, and a cell added as
files alone runs; BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

import harness
from conftest import BENCH, ROOT, SMALL

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Widths of this system's shapes: never cut.
WIDTHS = {"horizon", "num_samples", "dt", "alpha", "delta", "epsilon",
          "robot_radius", "obstacle_radius", "obstacles"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = harness.find_cell(ROOT, cell)
    assert c.config and c.traffic["driver"] and c.limits
    for fn in ("setup", "call", "check", "control", "units"):
        assert callable(getattr(c.driver, fn)), fn
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in c.traffic["metrics"]
    for m in c.per_layer:
        assert hasattr(harness.metric_reader(BENCH, m["name"]), "read")
    for target in c.traffic.get("spans", []):
        mod, fn = target.rsplit(".", 1)
        import importlib
        assert callable(getattr(importlib.import_module(
            f"{harness.PORT}.{mod}"), fn)), target


def test_reader_falls_back_to_the_name_before_the_dot(tmp_path):
    assert harness.metric_reader(BENCH, "ipm_passes.loop").__name__.endswith("ipm_passes")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader(BENCH, "no_such_metric.rate")


def test_contract_of_benchmark_json():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and not set(c["reduced"]) & WIDTHS
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for cell in m["workloads"]:
            moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split()[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        got = [m for m in b["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert {"setup_s"} < {m["name"] for m in got}
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new cell, as a later PR adds it: an entry in BENCHMARK.json, a
    traffic file and a limits file; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / harness.PORT).symlink_to(ROOT / harness.PORT)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "head_on_n20.batch8", "config": "head_on_n20",
                           "traffic": "batch8", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("scenarios_per_s", "filter_core_ms.rate"):
            m["workloads"].append("head_on_n20.batch8")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = dict(json.loads((BENCH / "traffic" / "batch256.json").read_text()),
                   scenarios=3, pool=2, warmup_calls=1, profile_calls=1)
    (root / "benchmark" / "traffic" / "batch8.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "limits" / "head_on_n20.batch8.json").write_text(json.dumps(
        {"limits": {"halfspace_gap": 5e-5, "plan_gap": 5e-2, "distance_gap": 2e-4}}))
    cell = harness.find_cell(root, "head_on_n20.batch8")
    assert cell.config["scenario"] == "head_on" and cell.traffic["scenarios"] == 3
    res = harness.run(root, "head_on_n20.batch8", 5, 0.2, False, device="cpu",
                      log=lambda s: None)
    assert res["correct"] and res["attempted"] % 3 == 0
    assert set(res["metrics"]) == {"scenarios_per_s", "setup_s"}
    traced = harness.run(root, "head_on_n20.batch8", 5, 0.2, True, device="cpu",
                         log=lambda s: None)
    assert "filter_core_ms.rate" in traced["metrics"]
    assert list(traced)[-1] == "check"


def test_small_sizes_cover_every_cell():
    assert set(SMALL) == set(CELLS)
