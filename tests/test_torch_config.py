"""PyTorch port: configuration copies, the CLI, and independence from jax."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config as jcfg
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"


@pytest.mark.parametrize("preset", ["custom", "paper"])
def test_presets_equal_jax(preset):
    ours = pt.config.get_parameters(preset)
    theirs = jcfg.get_parameters(preset)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.n_sim_steps == theirs.n_sim_steps


@pytest.mark.parametrize("preset", ["custom", "paper"])
@pytest.mark.parametrize("name", ["head_on", "overtaking", "intersection",
                                  "multi_obstacle"])
def test_scenarios_equal_jax(preset, name):
    ours = pt.config.get_scenario_config(name, preset)
    theirs = jcfg.get_scenario_config(name, preset)
    for field in dataclasses.fields(theirs):
        a, b = getattr(ours, field.name), getattr(theirs, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    assert ours.n_obstacles == theirs.n_obstacles
    assert pt.config.SCENARIO_NAMES == jcfg.SCENARIO_NAMES


def test_port_sources_never_import_jax():
    for path in PORT_DIR.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] == "jax"), (path, line)


_NO_JAX_SCRIPT = """
import sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
import dataclasses
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
params = dataclasses.replace(pt.config.get_parameters("custom"),
                             num_samples=8)
scenario = pt.config.get_scenario_config("head_on")
res = pt.models.run_single_scenario(scenario, params, seed=3,
                                    dtype=torch.float64, device="cpu")
assert res.filtered_u.shape == (1, 3, params.horizon, 2)
assert bool(torch.isfinite(res.distances).all())
assert bool(res.qp_converged.all())
leaked = sorted(m for m in sys.modules
                if m == "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu"
                or m.startswith("dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.")
                or m.startswith("jax"))
assert leaked == ["jax"], leaked   # only the blocking None entry
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_cli_single_mode(capsys):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import cli

    result = cli.main(["--scenario", "intersection", "--mode", "single",
                       "--device", "cpu", "--dtype", "float64"])
    out = capsys.readouterr().out
    for metric in ("mean", "cvar", "dr_cvar"):
        assert f"{metric} status: optimal" in out
    assert out.count("min distance") == 4
    assert result.filtered_u.shape == (1, 3, 30, 2)
    with pytest.raises(SystemExit):        # not a mode of the CLI
        cli.main(["--mode", "animate"])


_DEVICE_DEFAULTS = [
    ("models.pipeline", "make_statics"),
    ("models.pipeline", "run_single_scenario"),
    ("evaluation.monte_carlo", "run_monte_carlo_simulation"),
    ("evaluation.timing_analysis", "analyze_dr_cvar_computation_time"),
    ("core.dynamics", "create_double_integrator_matrices"),
    ("core.dynamics", "create_single_integrator_matrices"),
    ("convert", "obstacle_data"),
    ("convert", "mpc_problem"),
    ("simulation.environment", "Environment"),
]


@pytest.mark.parametrize("module,name", _DEVICE_DEFAULTS)
def test_entry_points_default_to_the_card(module, name):
    """Every `device=` of the port defaults to the one name, the card."""
    import importlib
    import inspect

    assert pt.config.DEFAULT_DEVICE == "cuda"
    mod = importlib.import_module(f"{pt.__name__}.{module}")
    default = inspect.signature(getattr(mod, name)).parameters["device"].default
    assert default is pt.config.DEFAULT_DEVICE


def test_no_other_device_default_in_the_port():
    """No signature of the port names a device of its own, and the CLI
    does not look for a card to choose its default."""
    for path in PORT_DIR.rglob("*.py"):
        text = path.read_text()
        assert 'device="cpu"' not in text.replace(" ", ""), path
        assert "device='cpu'" not in text.replace(" ", ""), path
    assert "is_available" not in (PORT_DIR / "cli.py").read_text()


def test_cli_defaults_to_the_card_and_does_not_move_to_the_cpu(tmp_path):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import cli

    parser = cli.build_parser()
    assert parser.get_default("device") == pt.config.DEFAULT_DEVICE
    assert parser.parse_args(["--device", "cpu"]).device == "cpu"
    argv = ["--mode", "timing_analysis", "--sample_sizes", "5",
            "--timing_runs", "2", "--save_dir", str(tmp_path)]
    if torch.cuda.is_available():
        cli.main(argv)
    else:       # PyTorch's own error, not a run on the CPU
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            cli.main(argv)
