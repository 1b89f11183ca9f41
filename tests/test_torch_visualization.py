"""PyTorch port: simulation/visualization.py and the CLI's plots.

Mirrors tests/test_evaluation.py's visualization tests: every figure is
written, the animation falls back to a GIF where ffmpeg cannot write,
`_halfspace_line` equals the JAX package's on random lines (exactly: the
same numpy arithmetic), tensors are accepted at every entry, and the CLI
writes the JAX CLI's file names, or one line naming the plots it skips
where matplotlib is not installed.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
    visualization as jviz)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
    cli as tcli)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    visualization as viz)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _scene(seed, steps, n_obs, hs_steps):
    rng = np.random.default_rng(seed)
    ego = np.cumsum(rng.normal(size=(steps, 4)) * 0.1, axis=0)
    obs = np.cumsum(rng.normal(size=(n_obs, steps, 2)) * 0.1, axis=1)
    hs_h = rng.normal(size=(hs_steps, n_obs, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    return rng, ego, obs, hs_h, rng.normal(size=(hs_steps, n_obs))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_every_figure_is_written(tmp_path, as_tensor):
    rng, ego, obs, hs_h, hs_g = _scene(0, 20, 2, 10)
    conv = torch.as_tensor if as_tensor else np.asarray
    ego, obs, hs_h, hs_g = map(conv, (ego, obs, hs_h, hs_g))
    viz.plot_scenario(ego, obs, 0.3, 0.3,
                      save_path=str(tmp_path / "scenario.png"))
    viz.plot_distance_to_collision(
        {"a": conv(rng.normal(size=20)), "b": conv(rng.normal(size=20))},
        save_path=str(tmp_path / "dist.png"))
    viz.plot_distance_to_collision(
        {"a": conv(rng.normal(size=20)), "b": conv(rng.normal(size=20))},
        save_path=str(tmp_path / "box.png"), boxplot=True)
    viz.compare_risk_metrics(
        {"mean": conv(rng.normal(size=30)),
         "dr_cvar": conv(rng.normal(size=30))},
        save_path=str(tmp_path / "cmp.png"))
    viz.visualize_trajectory_with_halfspaces(
        ego, obs, hs_h, hs_g, 0.3, 0.3, save_path=str(tmp_path / "hs.png"))
    for f in ["scenario.png", "dist.png", "box.png", "cmp.png", "hs.png"]:
        assert (tmp_path / f).stat().st_size > 0, f


def test_animation_falls_back_to_a_gif(tmp_path):
    _, ego, obs, hs_h, hs_g = _scene(1, 6, 1, 6)
    viz.animate_scenario(torch.as_tensor(ego), torch.as_tensor(obs), 0.3, 0.3,
                         torch.as_tensor(hs_h), torch.as_tensor(hs_g),
                         save_path=str(tmp_path / "anim.mp4"))
    assert (tmp_path / "anim.mp4").exists() or (tmp_path / "anim.gif").exists()
    # Without halfspaces.
    viz.animate_scenario(ego, obs, 0.3, 0.3,
                         save_path=str(tmp_path / "plain.mp4"))
    assert ((tmp_path / "plain.mp4").exists()
            or (tmp_path / "plain.gif").exists())


def test_halfspace_line_equals_jax_package():
    rng = np.random.default_rng(3)
    xlim, ylim = (-6, 6), (-4, 4)
    lines = [(rng.normal(size=2), rng.normal() * 3) for _ in range(200)]
    lines += [(np.array([1.0, 0.0]), 0.5), (np.array([0.0, 1.0]), -0.5),
              (np.array([1.0, 1.0]), 100.0), (np.array([0.0, 0.0]), 1.0)]
    seen = set()
    for h, g in lines:
        ours = viz._halfspace_line(h, g, xlim, ylim)
        theirs = jviz._halfspace_line(h, g, xlim, ylim)
        seen.add(theirs is None)
        if theirs is None:
            assert ours is None
        else:
            np.testing.assert_array_equal(ours, theirs)
        from_tensor = viz._halfspace_line(
            torch.as_tensor(h), torch.as_tensor(g, dtype=torch.float64),
            xlim, ylim)
        assert (from_tensor is None) == (ours is None)
        if ours is not None:
            np.testing.assert_array_equal(from_tensor, ours)
    assert seen == {True, False}


def test_to_numpy_takes_tensors_and_arrays():
    t = torch.arange(6.0, requires_grad=True).reshape(2, 3)
    out = viz.to_numpy(t)
    assert isinstance(out, np.ndarray) and out.shape == (2, 3)
    assert viz.to_numpy([1, 2]).tolist() == [1, 2]
    a = np.ones(3)
    assert viz.to_numpy(a) is a


def test_package_does_not_import_matplotlib_eagerly():
    """`import <port>` and its CLI module work where matplotlib is not
    installed: a blocked matplotlib is never asked for."""
    script = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        f"import {pt.__name__} as pt\n"
        f"import {pt.__name__}.cli\n"
        "assert not hasattr(pt.simulation, 'visualization')\n"
        "assert [m for m in sys.modules if m.startswith('matplotlib')] "
        "== ['matplotlib']\n"
        "print('NO_MPL_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_MPL_OK" in proc.stdout


@pytest.mark.parametrize("metric", ["cvar", "dr_cvar"])
def test_cli_single_writes_the_jax_cli_file_names(tmp_path, capsys, metric):
    argv = ["--mode", "single", "--device", "cpu", "--save_dir",
            str(tmp_path)]
    if metric != "dr_cvar":             # dr_cvar is the default
        argv += ["--metric", metric]
    result = tcli.main(argv)
    out = capsys.readouterr().out
    assert result.filtered_u.shape == (1, 3, 30, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"head_on_{metric}_halfspaces.png", "head_on_results.png"]
    assert f"Saved plots to {tmp_path}/" in out
    assert "skipping" not in out


def test_cli_animate_writes_the_animation(tmp_path, capsys):
    tcli.main(["--mode", "single", "--scenario", "intersection", "--metric",
               "mean", "--animate", "--device", "cpu", "--dtype", "float64",
               "--save_dir", str(tmp_path)])
    names = {p.name for p in tmp_path.iterdir()}
    assert {"intersection_results.png",
            "intersection_mean_halfspaces.png"} <= names
    assert names & {"intersection_mean_animation.mp4",
                    "intersection_mean_animation.gif"}
    assert "Animation saved near" in capsys.readouterr().out


def test_cli_without_matplotlib_skips_the_plots_and_refuses_animate(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, viz.__name__)
    monkeypatch.delattr(pt.simulation, "visualization", raising=False)
    result = tcli.main(["--mode", "single", "--device", "cpu", "--save_dir",
                        str(tmp_path)])
    out = capsys.readouterr().out
    assert result.filtered_u.shape == (1, 3, 30, 2)
    assert out.count("matplotlib is not installed: skipping") == 1
    assert "head_on_results.png and head_on_dr_cvar_halfspaces.png" in out
    assert list(tmp_path.iterdir()) == []
    tcli.main(["--mode", "monte_carlo", "--mc_runs", "2", "--device", "cpu",
               "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "skipping head_on_mc_comparison.png" in out
    assert [p.name for p in tmp_path.iterdir()] == ["head_on_mc_data.npz"]
    monkeypatch.setattr(tcli.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit):
        tcli.main(["--mode", "single", "--animate", "--device", "cpu",
                   "--save_dir", str(tmp_path)])
    assert "--animate needs matplotlib" in capsys.readouterr().err
