"""PyTorch port: evaluation (metrics, Monte Carlo, the timing sweep) and
the CLI's monte_carlo and timing_analysis modes, against the JAX package.

* `safety_metrics` against JAX in float64 to 1e-12, std (population) and
  the linear-interpolation percentiles included;
* the Monte Carlo reduction on injected obstacles: three head_on runs
  (N = 8, sim_time 2 s) through the port and through JAX
  `vmap(run_scenario_with_obstacles)` in float64, minimum distances to
  1e-8;
* `run_monte_carlo_simulation`'s minimum distances do not depend on
  `chunk_size` or `batched` (bit for bit, on the CPU);
* npz round trips of the Monte Carlo result and the timing data, resume
  included, and the CSV against the JAX package's (same header, same
  numbers);
* CLI smoke runs on the CPU: the files each mode writes.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation import (
    metrics as jmetrics, timing_analysis as jtiming)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models import (
    pipeline as jpipe)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.obstacles import (
    ObstacleData as JObstacleData)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch import (
    cli as tcli)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation import (
    metrics as tmetrics, monte_carlo as tmc, timing_analysis as ttiming)

from torch_port_streams import reference_rng_obstacles

torch.set_num_threads(1)

TIMING_FILES = ("timing_comparison.csv", "timing_data.npz",
                "timing_data.txt", "dr_cvar_computation_time.png",
                "dr_cvar_computation_time_with_outliers.png")


def test_collision_rate_and_shortfall():
    d = torch.tensor([-1.0, 0.5, -0.5, 1.0])
    assert float(tmetrics.collision_rate(d)) == 0.5
    assert float(tmetrics.expectation_of_shortfall(d)) == pytest.approx(-0.75)
    assert float(tmetrics.expectation_of_shortfall(
        torch.tensor([0.1, 0.2]))) == 0.0
    rows = torch.tensor([[-1.0, 1.0], [2.0, 3.0]], dtype=torch.float64)
    assert tmetrics.collision_rate(rows, axis=1).tolist() == [0.5, 0.0]


@pytest.mark.parametrize("n", [1, 7, 100])
def test_safety_metrics_match_jax_f64(n):
    rng = np.random.default_rng(n)
    d = rng.normal(size=n)
    ours = tmetrics.safety_metrics(torch.as_tensor(d))
    theirs = jmetrics.safety_metrics(jnp.asarray(d))
    assert set(ours) == set(theirs)
    for key in theirs:
        # The mean of booleans is float32 in both (jnp.mean's dtype), and
        # XLA divides by multiplying with 1/n: one float32 ulp apart.
        atol = 6e-8 if key == "collision_rate" else 1e-12
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]),
                                   rtol=0, atol=atol, err_msg=key)
    assert ours["collision_rate"].dtype == torch.float32
    assert ours["std"].dtype == ours["q10"].dtype == torch.float64


def _head_on_short():
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 num_samples=8)
    scenario = dataclasses.replace(pt.config.get_scenario_config("head_on"),
                                   sim_time=2.0)
    return params, scenario


def test_mc_reduction_matches_jax_on_injected_obstacles():
    params, scenario = _head_on_short()
    runs = [reference_rng_obstacles(scenario, scenario.sim_time, params.dt,
                                    params.num_samples, seed=s)
            for s in (1, 2, 3)]
    stacked = {k: np.stack([r[k] for r in runs]) for k in runs[0]}

    statics = pt.models.make_statics(scenario, params, torch.float64,
                                     "cpu")
    res = pt.models.run_scenario_with_obstacles(
        statics, pt.convert.obstacle_data(stacked, torch.float64, "cpu"),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    min_d, conv = tmc.reduce_runs(res)

    jstatics = jpipe.make_statics(scenario, params, jnp.float64)
    jres = jax.vmap(lambda o: jpipe.run_scenario_with_obstacles(
        jstatics, o, jnp.asarray(scenario.ego_start),
        jnp.asarray(scenario.ego_goal), params.ego_velocity))(
        JObstacleData(**{k: jnp.asarray(v) for k, v in stacked.items()}))
    # monte_carlo.py's reduction: min over time, then the reference.
    j_min_d = np.concatenate([np.asarray(jres.distances.min(axis=-1)),
                              np.asarray(jres.reference_distance.min(
                                  axis=-1))[:, None]], axis=1)
    assert min_d.shape == (3, 4) and conv.shape == (3, 3)
    np.testing.assert_allclose(min_d.numpy(), j_min_d, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(conv.numpy(),
                                  np.asarray(jres.qp_converged))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mc_results_do_not_depend_on_chunking(dtype):
    params, scenario = _head_on_short()
    n_runs = 3
    runs = {}
    for chunk, batched in ((n_runs, True), (1, True), (2, True),
                           (1024, False)):
        runs[chunk, batched] = pt.evaluation.run_monte_carlo_simulation(
            scenario, params, n_runs=n_runs, seed=7, dtype=dtype,
            chunk_size=chunk, batched=batched, device="cpu")
    ref = runs[n_runs, True]
    assert ref.min_distances.shape == (n_runs, 4)
    assert ref.min_distances.dtype == dtype
    assert bool(torch.isfinite(ref.min_distances).all())
    for key, other in runs.items():
        assert torch.equal(other.min_distances, ref.min_distances), key
        assert torch.equal(other.qp_converged, ref.qp_converged), key
    assert ref.collision_probs.dtype == torch.float32     # as in JAX
    np.testing.assert_allclose(
        ref.collision_probs.numpy(),
        (ref.min_distances < 0).double().mean(0).numpy(), rtol=1e-6)
    other_seed = pt.evaluation.run_monte_carlo_simulation(
        scenario, params, n_runs=n_runs, seed=8, dtype=dtype,
        device="cpu")
    assert not torch.equal(other_seed.min_distances, ref.min_distances)


def test_mc_result_npz_roundtrip_and_summary(tmp_path, capsys):
    rng = np.random.default_rng(5)
    md = torch.as_tensor(rng.normal(size=(7, 4)))
    result = tmc.MonteCarloResult(
        min_distances=md, collisions=md < 0,
        collision_probs=(md < 0).double().mean(0),
        qp_converged=torch.ones((7, 3), dtype=torch.bool))
    path = tmp_path / "mc.npz"
    tmc.save_mc_result(result, str(path))
    with np.load(path) as archive:
        assert sorted(archive.files) == sorted(tmc.MonteCarloResult._fields)
    loaded = tmc.load_mc_result(str(path))
    for f in tmc.MonteCarloResult._fields:
        assert torch.equal(getattr(loaded, f), getattr(result, f)), f
    summary = result.summary()
    assert list(summary) == ["mean", "cvar", "dr_cvar", "reference"]
    assert summary["cvar"]["collision_prob"] == pytest.approx(
        float((md[:, 1] < 0).double().mean()))
    assert summary["reference"]["min"] == pytest.approx(float(md[:, 3].min()))
    tmc.print_mc_summary(result)
    out = capsys.readouterr().out
    assert "Monte Carlo summary over 7 runs" in out
    assert out.count("collision_prob=") == 4


def test_timing_npz_checkpoint_and_resume(tmp_path):
    kw = dict(n_runs=4, repeats=3, save_dir=str(tmp_path),
              dtype=torch.float64, device="cpu", verbose=False)
    first = ttiming.analyze_dr_cvar_computation_time(sample_sizes=(10,), **kw)
    assert set(first) == set(ttiming.TIMING_KEYS)
    npz = tmp_path / "timing_data.npz"
    loaded = ttiming.load_timing_data(str(npz))
    np.testing.assert_allclose(loaded["solve_times"][10],
                               first["solve_times"][10])
    # The JAX loader reads the port's file: the same keys.
    jloaded = jtiming.load_timing_data(str(npz))
    assert jloaded.keys() == loaded.keys()
    merged = ttiming.analyze_dr_cvar_computation_time(
        sample_sizes=(10, 30), resume=True, **kw)
    np.testing.assert_allclose(merged["solve_times"][10],
                               first["solve_times"][10])
    assert len(merged["solve_times"][30]) == 3
    for name in TIMING_FILES:
        assert (tmp_path / name).exists(), name


def test_timing_csv_matches_the_jax_table(tmp_path):
    data = ttiming.analyze_dr_cvar_computation_time(
        sample_sizes=(10, 20), n_runs=3, repeats=2, device="cpu",
        verbose=False)
    assert all(len(data[k][n]) == 2 for k in data for n in (10, 20))
    ours_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    ours_dir.mkdir()
    jax_dir.mkdir()
    ttiming.create_comparison_table(data, [10, 20], str(ours_dir),
                                    verbose=False)
    jtiming.create_comparison_table(data, [10, 20], str(jax_dir),
                                    verbose=False)
    with open(ours_dir / "timing_comparison.csv", newline="") as fh:
        ours = list(csv.reader(fh))
    with open(jax_dir / "timing_comparison.csv", newline="") as fh:
        theirs = list(csv.reader(fh))
    assert ours[0] == theirs[0] == list(ttiming.TABLE_COLUMNS)
    np.testing.assert_allclose(np.asarray(ours[1:], float),
                               np.asarray(theirs[1:], float), rtol=1e-12)
    assert ((ours_dir / "timing_comparison.csv").read_bytes()
            == (jax_dir / "timing_comparison.csv").read_bytes())


def test_timing_without_save_dir_writes_and_plots_nothing(tmp_path,
                                                          monkeypatch):
    def no_plot(*args, **kwargs):
        raise AssertionError("plotted without a save_dir")

    monkeypatch.setattr(ttiming, "plot_timing_results", no_plot)
    monkeypatch.chdir(tmp_path)
    data = ttiming.analyze_dr_cvar_computation_time(
        sample_sizes=(10,), n_runs=2, repeats=2, device="cpu", verbose=True)
    assert len(data["cvar_call_times"][10]) == 2
    assert list(tmp_path.iterdir()) == []


def test_timing_instances_are_the_jax_instances(monkeypatch):
    """The solver sees the JAX sweep's instances: [0.5, 0] + 0.1 N(0, 1)
    from np.random.default_rng(seed), and h = [1, 1]/sqrt(2)."""
    seen = []
    real = ttiming._make_batched_solvers

    def spy(params):
        dr, cvar = real(params)

        def dr_spy(samples, h):
            seen.append((samples.numpy().copy(), h.numpy().copy()))
            return dr(samples, h)
        return dr_spy, cvar

    monkeypatch.setattr(ttiming, "_make_batched_solvers", spy)
    ttiming.analyze_dr_cvar_computation_time(
        sample_sizes=(5,), n_runs=3, repeats=1, seed=3, dtype=torch.float64,
        device="cpu", verbose=False)
    rng = np.random.default_rng(3)
    want = np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(3, 5, 2))
    assert len(seen) == 2                  # the excluded first call + 1
    for samples, h in seen:
        np.testing.assert_array_equal(samples, want)
        np.testing.assert_allclose(h, np.array([1.0, 1.0]) / np.sqrt(2.0))


def test_cli_monte_carlo_smoke(tmp_path, capsys):
    prof = tmp_path / "prof"
    result = tcli.main(["--mode", "monte_carlo", "--mc_runs", "3",
                          "--save_dir", str(tmp_path), "--device", "cpu",
                          "--profile_dir", str(prof)])
    out = capsys.readouterr().out
    assert result.min_distances.shape == (3, 4)
    assert (tmp_path / "head_on_mc_data.npz").exists()
    loaded = tmc.load_mc_result(str(tmp_path / "head_on_mc_data.npz"))
    assert torch.equal(loaded.min_distances, result.min_distances)
    assert out.count("collision_prob=") == 4
    assert "visualization" in out
    assert (prof / "trace.json").exists()


def test_cli_timing_analysis_smoke(tmp_path, capsys):
    tcli.main(["--mode", "timing_analysis", "--sample_sizes", "10,20",
                 "--timing_runs", "3", "--save_dir", str(tmp_path),
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Timing Comparison (times in ms):" in out
    for name in TIMING_FILES:
        assert (tmp_path / name).exists(), name
    with open(tmp_path / "timing_comparison.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Samples", "DR-CVaR Setup", "DR-CVaR Solve",
                       "DR-CVaR Call", "CVaR Setup", "CVaR Solve",
                       "CVaR Call"]
    assert [r[0] for r in rows[1:]] == ["10", "20"]
    assert os.path.getsize(tmp_path / "timing_data.txt") > 0
