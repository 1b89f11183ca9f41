"""PyTorch port: the experiment scripts, the demos and the console script,
run on the CPU at small sizes.

  * `experiments.qpbench`: every variant at batch 8 prints one line, and
    the solver's names are restored afterwards (also when a run raises),
    the solver's cached graphs dropped on the way in and out;
  * `experiments.make_gallery` cut to custom / head_on with
    --skip_animate writes the JAX gallery's head_on files but the
    animation (`results/Custom_Scenarios/head_on_*`), into tmp_path;
  * `demos.single_obstacle` / `demos.multi_obstacle` write the JAX demos'
    file names (test_scripts/) and print their lines;
  * the `dr-cvar-filter-torch` console script of pyproject.toml is the
    port's CLI.
None of them writes into results/.
"""

import importlib
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
    cli as tcli)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.demos import (
    multi_obstacle, single_obstacle)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
    make_gallery, qpbench)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models import (
    METRICS)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    qp_ipm_structured as qps)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REBOUND = ("_factor", "_solve", "_polish", "_select_rows",
           "POLISH_REFINEMENTS")
SMALL = ["--device", "cpu", "--repeats", "1", "--k", "1"]


def _solver_names():
    return {name: getattr(qps, name) for name in REBOUND}


@pytest.fixture
def results_untouched():
    """results/ (the JAX package's published gallery) is not written."""
    def snapshot():
        return {p: p.stat().st_mtime_ns for p in (REPO / "results").rglob("*")}

    before = snapshot()
    yield
    assert snapshot() == before


def test_qpbench_every_variant(capsys, results_untouched):
    specs = [f"{name}:8" for name in qpbench.NAMES] + ["chol:8:nopol",
                                                       "chol:8:5"]
    before = _solver_names()
    out = qpbench.main(specs + SMALL)
    assert _solver_names() == before
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(specs)
    for spec, line, (fields, r) in zip(specs, lines, out):
        assert line.startswith(f"{spec}  ") and "QP/s" in line
        assert fields["spec"] == spec and fields["batch"] == 8
        assert r["ms"] > 0 and r["k"] == 1
    by_spec = {fields["spec"]: r for fields, r in out}
    # At a cap of 5 every float32 lane stops at the cap, and the rescue's
    # warm float64 re-solve, capped at 5 too, converges each: 5 and at
    # most 5 more (test_torch_ipm_rescue.py holds each attempt to the cap).
    capped = by_spec["chol:8:5"]
    assert capped["converged"] == 1.0
    assert 5 < capped["iters_max"] <= 2 * 5
    assert by_spec["chol:8"]["converged"] == 1.0


@pytest.mark.parametrize("name,rebound", [
    ("diag", {"_factor", "_solve", "_polish"}), ("pnone", {"_polish"}),
    ("pref0", {"POLISH_REFINEMENTS"}), ("pnotopk", {"_select_rows"}),
    ("chol", set()), ("bt", set())])
def test_qpbench_variants_restore_the_solver(name, rebound):
    before = _solver_names()
    with pytest.raises(RuntimeError, match="inside"):
        with qpbench.variant(name):
            changed = {key for key, value in _solver_names().items()
                       if value is not before[key]}
            raise RuntimeError("inside")
    assert changed == rebound
    assert _solver_names() == before


@pytest.mark.parametrize("spec", ["lu:8", "chol", "chol:x", "chol:8:fast"])
def test_qpbench_bad_specs(spec):
    with pytest.raises(ValueError, match="bad spec"):
        qpbench.parse_spec(spec)


def test_qpbench_data_follow_the_jax_laws():
    prob, (x0, x_ref, hs_h, hs_g) = qpbench.make_data(64, device="cpu")
    assert prob.horizon == 30 and prob.n_obstacles == qpbench.N_OBS
    assert x0.shape == (64, 4) and x_ref.shape == (64, 31, 4)
    torch.testing.assert_close(hs_h.norm(dim=-1), torch.ones(64, 30, 3))
    assert float(hs_g.min()) >= -1.5 and float(hs_g.max()) <= 0.2
    P_uu, q_u, G_u, h1, A, b, p_ss, q_s = qpbench.assemble(
        prob, x0, x_ref, hs_h, hs_g)
    assert P_uu.shape == (60, 60) and G_u.shape == (240, 60)
    assert A.shape == (64, 90, 60) and b.shape == (64, 90)
    assert (p_ss, q_s) == (100.0, 50.0)


def test_a_qpbench_variant_drops_the_cached_graphs():
    """The graphs captured the names bound at their first call, so a
    variant, which rebinds them, drops the cache on entry and on exit."""
    sentinel = ("sentinel",)
    qps._GRAPHS[sentinel] = object()
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with qpbench.variant("pnone"):
                assert sentinel not in qps._GRAPHS
                qps._GRAPHS[sentinel] = object()
                raise RuntimeError("inside")
        assert sentinel not in qps._GRAPHS
    finally:
        qps._GRAPHS.pop(sentinel, None)


def test_make_gallery_writes_the_jax_names(tmp_path, results_untouched):
    assert REPO / "build" in make_gallery.DEFAULT_OUT.parents
    results = make_gallery.run(skip_animate=True, device="cpu", out=tmp_path,
                               scenarios=("head_on",),
                               presets=make_gallery.PRESETS[:1])
    (res,) = results.values()
    assert bool(res.qp_converged.all())
    want = {p.name for p in (REPO / "results" / "Custom_Scenarios")
            .glob("head_on_*") if "animation" not in p.name}
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*") if p.is_file()) == sorted(
        f"Custom_Scenarios/{name}" for name in want)


def test_single_obstacle_demo(tmp_path, capsys, results_untouched):
    verdicts = single_obstacle.main(["--device", "cpu", "--save_dir",
                                     str(tmp_path)])
    out = capsys.readouterr().out
    assert set(verdicts) == set(single_obstacle.SCENARIOS)
    for name, by_metric in verdicts.items():
        assert set(by_metric) == set(METRICS)
        for metric, (dist, verdict) in by_metric.items():
            assert verdict == ("COLLISION" if dist < 0 else "Safe")
            assert f"  {metric:10s}: min distance {dist:+.4f}  [{verdict}]" \
                in out
    assert out.count("reference : min distance") == 3
    # test_scripts/single_obstacle.py's names.
    want = {f"{s}_distances.png" for s in single_obstacle.SCENARIOS} | {
        f"{s}_{m}_trajectory.png" for s in single_obstacle.SCENARIOS
        for m in METRICS}
    assert {p.name for p in tmp_path.iterdir()} == want


def test_multi_obstacle_demo(tmp_path, capsys, results_untouched):
    dist = multi_obstacle.main(["--device", "cpu", "--save_dir",
                                str(tmp_path)])
    out = capsys.readouterr().out
    verdict = "COLLISION" if dist < 0 else "Safe"
    assert f"  dr_cvar: min distance {dist:+.4f}  [{verdict}]" in out
    assert "  QP status: optimal" in out
    # test_scripts/multi_obstacle.py's names.
    assert {p.name for p in tmp_path.iterdir()} == set(multi_obstacle.PLOTS)


@pytest.mark.parametrize("demo", [single_obstacle, multi_obstacle])
def test_demos_without_matplotlib_still_run(demo, tmp_path, capsys,
                                            monkeypatch):
    """As on the card's machine: one "skipping" line a scenario, the
    pipeline still runs, nothing is written."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
        simulation)

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, f"{simulation.__name__}.visualization",
                        raising=False)
    monkeypatch.delattr(simulation, "visualization", raising=False)
    got = demo.main(["--device", "cpu", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    n_scenarios = len(got) if isinstance(got, dict) else 1
    assert out.count("matplotlib is not installed: skipping") == n_scenarios
    assert out.count("min distance") == (4 * n_scenarios if n_scenarios > 1
                                         else 1)
    assert not tmp_path.exists() or not any(tmp_path.iterdir())


def test_console_script_is_the_port_cli(tmp_path, capsys):
    with open(REPO / "pyproject.toml", "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    module, _, attr = scripts["dr-cvar-filter-torch"].partition(":")
    entry = getattr(importlib.import_module(module), attr)
    assert entry is tcli.main
    res = entry(["--mode", "single", "--device", "cpu", "--save_dir",
                 str(tmp_path)])
    assert bool(res.qp_converged.all())
    assert "Running scenario: Head-on collision scenario on cpu" in \
        capsys.readouterr().out
