"""PyTorch port: the CLI's --mesh, and the timing sweep without matplotlib.

  * the `--mesh` parse errors and the world-size check;
  * `--mesh data=1` in this process (a Gloo group of one, set up and torn
    down by the CLI) for monte_carlo and timing_analysis: the npz equal
    to the plain run's, the same artifacts;
  * `torchrun --nproc_per_node 2 ... --mesh data=2 --device cpu`: the npz
    equal to the plain run's, written by rank 0 alone, and the timing
    sweep's CSV and text file;
  * under a launcher's variables the CLI ends the group it set up;
  * single mode prints the "ignored" line;
  * `--mode timing_analysis --save_dir` where matplotlib is not
    installed writes the CSV, npz and `timing_data.txt` and names the
    plots it skips.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
    cli as tcli)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation import (
    timing_analysis as ttiming)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = ["--mode", "monte_carlo", "--scenario", "head_on", "--preset", "paper",
      "--mc_runs", "5", "--seed", "3", "--device", "cpu"]
TIMING = ["--mode", "timing_analysis", "--sample_sizes", "10,20",
          "--timing_runs", "4", "--device", "cpu"]
TIMING_FILES = {"timing_comparison.csv", "timing_data.npz", "timing_data.txt"}


@pytest.mark.parametrize("spec", ["samples=2", "data=0", "data=x",
                                  "data=2,foo=1", "data=-1", ""])
def test_mesh_spec_errors(spec):
    with pytest.raises(SystemExit):
        tcli._parse_mesh_spec(spec)


@pytest.mark.parametrize("spec,axes", [("data=4", {"data": 4, "samples": 1}),
                                       ("data=2,samples=2",
                                        {"data": 2, "samples": 2})])
def test_mesh_spec_parses(spec, axes):
    assert tcli._parse_mesh_spec(spec) == axes


def test_mesh_larger_than_the_world_exits(tmp_path):
    with pytest.raises(SystemExit, match="needs 2 processes, 1 running"):
        tcli.main(MC + ["--mesh", "data=2", "--save_dir", str(tmp_path)])
    assert not dist.is_initialized()


def test_mesh_data1_in_process(tmp_path, capsys):
    plain = tcli.main(MC + ["--save_dir", str(tmp_path / "plain")])
    mesh = tcli.main(MC + ["--mesh", "data=1",
                           "--save_dir", str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    assert "Splitting the MC run axis over mesh {'data': 1, 'samples': 1}" \
        in capsys.readouterr().out
    assert torch.equal(mesh.min_distances, plain.min_distances)
    assert torch.equal(mesh.qp_converged, plain.qp_converged)
    with np.load(tmp_path / "plain" / "head_on_mc_data.npz") as a, \
            np.load(tmp_path / "mesh" / "head_on_mc_data.npz") as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    tcli.main(TIMING + ["--mesh", "data=1", "--save_dir",
                        str(tmp_path / "timing")])
    assert not dist.is_initialized()
    assert TIMING_FILES <= set(os.listdir(tmp_path / "timing"))


def test_mesh_under_a_launcher_is_closed_by_the_cli(tmp_path, monkeypatch):
    """With a launcher's variables set (a world of one; port 0 lets the
    store pick a free one), the CLI sets the group up through
    `initialize_distributed`: it owns that group and ends it.  A torchrun
    rank that exits with its Gloo group alive can abort in the group's
    destructor (SIGABRT, "terminate called without an active
    exception") while rank 0 still writes."""
    for name, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "0"),
                        ("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(name, value)
    plain = tcli.main(MC + ["--save_dir", str(tmp_path / "plain")])
    mesh = tcli.main(MC + ["--mesh", "data=1",
                           "--save_dir", str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    assert torch.equal(mesh.min_distances, plain.min_distances)
    with pytest.raises(SystemExit, match="needs 2 processes, 1 running"):
        tcli.main(MC + ["--mesh", "data=2", "--save_dir", str(tmp_path)])
    assert not dist.is_initialized()


def test_single_mode_ignores_the_mesh(tmp_path, capsys):
    tcli.main(["--mode", "single", "--mesh", "data=2", "--device", "cpu",
               "--save_dir", str(tmp_path)])
    assert "--mesh is ignored in --mode single" in capsys.readouterr().out
    assert not dist.is_initialized()


def _torchrun(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", f"{tcli.__package__}.cli", *args]
    try:
        out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=120)
    except subprocess.TimeoutExpired as exc:
        pytest.fail(f"torchrun timed out:\n{exc.stdout}\n{exc.stderr}")
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_torchrun_monte_carlo_data2(tmp_path):
    tcli.main(MC + ["--save_dir", str(tmp_path / "plain")])
    stdout = _torchrun(MC + ["--mesh", "data=2", "--save_dir",
                             str(tmp_path / "mesh")], tmp_path)
    assert stdout.count("Monte Carlo summary over 5 runs") == 1
    assert sorted(os.listdir(tmp_path / "mesh")) == sorted(
        os.listdir(tmp_path / "plain"))
    with np.load(tmp_path / "plain" / "head_on_mc_data.npz") as a, \
            np.load(tmp_path / "mesh" / "head_on_mc_data.npz") as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_torchrun_timing_analysis_data2(tmp_path):
    stdout = _torchrun(TIMING + ["--mesh", "data=2", "--save_dir",
                                 str(tmp_path / "out")], tmp_path)
    assert stdout.count("Timing Comparison") == 1
    assert TIMING_FILES <= set(os.listdir(tmp_path / "out"))


def test_timing_without_matplotlib_writes_the_data(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tcli.main(TIMING + ["--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed: skipping") == 1
    assert f"{ttiming.PLOTS[0]} and {ttiming.PLOTS[1]}" in out
    assert set(os.listdir(tmp_path)) == TIMING_FILES
    assert os.path.getsize(tmp_path / "timing_data.txt") > 0
