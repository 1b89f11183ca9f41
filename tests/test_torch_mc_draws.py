"""PyTorch port: a Monte Carlo chunk's obstacle draws in one launch of the
draw kernel (`ops/cuda_draws.py`, `simulation/obstacles.py::
draw_runs_kernel`) against the loop of one card generator a run
(`draw_runs_loop`), and which draws take which path.

On the CPU: the choice (`evaluation/monte_carlo.py::use_draw_kernel`, a
pure function of device and dtype), the runs each path counts, the loop
as the CPU's only path, PyTorch's launch geometry that the kernel
replays (`philox_plan`), the wrapper's refusals, the first draw of each
shape held to the loop (`draw_runs_kernel`'s check, with the kernel
replaced by the loop's draws, one bit turned over or not), and the scan's
mode that draws each study both ways (`experiments/mc_failures.py
--draws compare`).

Marked `cuda` (skipped where torch sees no CUDA device: the kernel has no
CPU mode), on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_mc_draws.py

the kernel's draws equal to the loop's bit for bit over a grid of
obstacles, samples, steps and runs (seeds 0 and 2^62 - 1 among them) and
on the studies of the failure scan, one launch a chunk, whole studies
unchanged, and float64 on the card left to the loop.
"""

import re
import sys
from pathlib import Path

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.config import (
    Parameters, get_scenario_config)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation import (
    monte_carlo as mc)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.models import (
    make_statics)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_draws)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.simulation import (
    obstacles as tobs)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

ROOT = Path(__file__).resolve().parents[1]
F32, F64 = torch.float32, torch.float64
TOP_SEED = 2 ** 62 - 1


def _recorded(fn):
    """fn() with the recorder on: (its result, the counters it added, the
    calls of each span it added)."""
    was, before = timing.record(True), timing.totals()
    try:
        out = fn()
        added = timing.since(before)
        return out, added["counts"], {k: n for k, (n, _) in
                                      added["spans"].items()}
    finally:
        timing.record(was)


def _obstacles(n_obs, device, dtype=F32, seed=0):
    """Starts, directions (the last one zero: a standing obstacle) and
    speeds of n_obs obstacles."""
    g = torch.Generator().manual_seed(seed)
    starts = torch.rand(n_obs, 2, generator=g) * 8 - 4
    dirs = torch.randn(n_obs, 2, generator=g)
    if n_obs > 1:
        dirs[-1] = 0.0
    speeds = torch.rand(n_obs, generator=g) + 0.5
    return tuple(t.to(device=device, dtype=dtype)
                 for t in (starts, dirs, speeds))


def _seeds(n, seed=7):
    """n run seeds as a study draws them, the first 0 and (n > 1) the
    last 2^62 - 1."""
    seeds = mc.run_seeds(seed, n)
    seeds[0] = 0
    if n > 1:
        seeds[-1] = TOP_SEED
    return seeds


def _equal_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# ---------------------------------------------------------------------------
# CPU: the choice, the counters, the geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,taken", [
    ("cuda", F32, True), ("cuda:0", F32, True), ("cuda", F64, False),
    ("cpu", F32, False), ("cpu", F64, False)])
def test_the_draw_path_is_chosen_from_device_and_dtype(device, dtype, taken):
    assert mc.use_draw_kernel(device, dtype) is taken
    assert mc.use_draw_kernel(torch.device(device), dtype) is taken


@pytest.mark.parametrize("dtype", [F32, F64])
def test_cpu_runs_take_the_loop_and_count_it(dtype):
    """On the CPU every run is drawn by its own generator, one after
    another, and counted under `obstacles.loop_runs`."""
    params, scenario = Parameters(num_samples=5), get_scenario_config("head_on")
    statics = make_statics(scenario, params, dtype, "cpu")
    seeds = _seeds(3)
    out, counts, spans = _recorded(lambda: mc.run_obstacles(
        statics, seeds, scenario, params, 12))
    assert counts["obstacles.loop_runs"] == 3
    assert "obstacles.kernel_runs" not in counts
    assert spans["obstacles.generate"] == 3
    assert out.samples.shape == (3, 1, 5, 13, 2) and out.samples.dtype == dtype
    args = [torch.as_tensor(v, dtype=dtype) for v in (
        scenario.obstacle_starts, scenario.obstacle_directions,
        scenario.obstacle_speeds)]
    for r, s in enumerate(seeds):
        one = tobs.generate_obstacle_scenarios(
            torch.Generator().manual_seed(s), *args, 12, params.dt, 5,
            params.noise_var)
        for got, want in zip(out, one):
            assert torch.equal(got[r:r + 1], want)


# (numel, multiprocessors, threads a multiprocessor) -> (threads, rounds):
# PyTorch's grid is min(ceil(numel / 256), SMs x threads / 256) blocks of
# 256, and a thread draws ceil(numel / (4 x threads)) Philox blocks.
PLANS = {
    "head_on_samples": ((6040, 132, 2048), (6144, 1)),
    "head_on_exponential": ((604, 132, 2048), (768, 1)),
    "one": ((1, 132, 2048), (256, 1)),
    "grid_capped": ((369000, 132, 2048), (270336, 1)),
    "two_rounds": ((270336 * 4 + 1, 132, 2048), (270336, 2)),
    "five_rounds": ((5_000_000, 132, 2048), (270336, 5)),
    "other_card": ((1_000_000, 114, 1536), (175104, 2)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_philox_plan_is_pytorchs_launch(case):
    args, want = PLANS[case]
    assert cuda_draws.philox_plan(*args) == want


def test_the_wrapper_takes_cuda_float32_only():
    nominal = torch.zeros(1, 13, 2)
    seeds = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_draws.obstacle_draws(nominal, seeds, 5, 0.01)
    before = cuda_draws.obstacle_draws.launches
    with pytest.raises(ValueError):
        cuda_draws.obstacle_draws(nominal.double(), seeds, 5, 0.01)
    assert cuda_draws.obstacle_draws.launches == before


def _kernel_replaced_by(monkeypatch, loop_args, flip=None):
    """`obstacle_draws` replaced by the loop's draws of `loop_args`, with
    the lowest bit of element 0 of field `flip` of run `flip_run` turned
    over where `flip` is (field, run); the checked shapes emptied.
    Returns the list of the seeds each call was given."""
    want = tobs.draw_runs_loop(*loop_args)
    calls = []

    def fake(nominal, seeds, n_samples, noise_var):
        calls.append(seeds.tolist())
        out = [t.clone() for t in want]
        if flip is not None:
            field, run = flip
            bits = out[field][run].view(-1).view(torch.int32)
            bits[0] ^= 1
        return out

    monkeypatch.setattr(tobs, "obstacle_draws", fake)
    monkeypatch.setattr(tobs, "_CHECKED", set())
    return calls


def test_the_first_kernel_draw_of_a_shape_is_held_to_the_loop(monkeypatch):
    """On the first call at a shape, run 0 is drawn again by the loop and
    must equal the kernel's bit for bit; the check adds no span and no
    counter, and a second call at that shape does not make it again."""
    args = (_seeds(4), *_obstacles(2, "cpu"), 12, 0.2, 7, 0.01)
    calls = _kernel_replaced_by(monkeypatch, args)
    out, counts, spans = _recorded(lambda: tobs.draw_runs_kernel(*args))
    assert calls == [args[0]]
    assert spans == {"obstacles.generate": 1} and not counts
    assert tobs._CHECKED == {(torch.device("cpu"), 2, 7, 12)}
    for a, b in zip(out, tobs.draw_runs_loop(*args)):
        assert _equal_bits(a, b)
    monkeypatch.setattr(tobs, "draw_runs_loop", lambda *a: pytest.fail(
        "the loop drew again at a checked shape"))
    tobs.draw_runs_kernel(*args)
    assert len(calls) == 2


@pytest.mark.parametrize("field,name", [(0, "nominal"), (1, "samples"),
                                        (2, "realization")])
def test_a_kernel_draw_unlike_the_loop_raises(monkeypatch, field, name):
    """One bit of run 0 off in any output: the first call at the shape
    raises, naming the output, the seed and PyTorch's version."""
    args = (_seeds(3), *_obstacles(1, "cpu"), 9, 0.2, 5, 0.01)
    _kernel_replaced_by(monkeypatch, args, flip=(field, 0))
    with pytest.raises(RuntimeError, match=f"{name} of seed 0 .*torch "
                       f"{re.escape(torch.__version__)}"):
        tobs.draw_runs_kernel(*args)
    assert not tobs._CHECKED


def test_the_check_draws_run_0_alone(monkeypatch):
    """A bit off in run 1 only: the check, which draws run 0 alone, lets
    the call through (the `cuda` tests hold every run to the loop)."""
    args = (_seeds(3), *_obstacles(1, "cpu"), 9, 0.2, 5, 0.01)
    _kernel_replaced_by(monkeypatch, args, flip=(1, 1))
    out = tobs.draw_runs_kernel(*args)
    assert out.samples.shape == (3, 1, 5, 10, 2)


@pytest.fixture(scope="module")
def mc_failures():
    """The scan script and the benchmark's harness it runs studies with;
    the module search path as it was afterwards."""
    saved = list(sys.path)
    sys.path[:0] = [str(ROOT / "experiments"), str(ROOT / "benchmark")]
    try:
        import mc_failures
        yield mc_failures
    finally:
        sys.path[:] = saved


def test_the_scan_compares_the_draws_of_each_study(mc_failures, tmp_path):
    """`--draws compare` draws each chunk again by the loop and compares
    it bit for bit: on the CPU both are the loop, so nothing differs, and
    the summary carries the rescue counters and the draw counts."""
    summary = mc_failures.main(["--device", "cpu", "--studies", "2",
                                "--runs", "3", "--draws", "compare",
                                "--out", str(tmp_path / "scan.jsonl")])
    assert summary["draws"] == "compare" and summary["runs"] == 6
    assert summary["chunks_compared"] == 2
    assert summary["chunks_differing"] == 0
    assert summary["studies_differing"] == []
    assert summary["draw_loop_runs"] == 12 and summary["draw_kernel_runs"] == 0
    assert isinstance(summary["rescue_counts"], dict)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draw kernel has no CPU mode")
    return torch.device("cuda")


def _both(device, n_obs, n_samples, steps, seeds, seed=0):
    args = (seeds, *_obstacles(n_obs, device, seed=seed), steps - 1, 0.2,
            n_samples, 0.01)
    return tobs.draw_runs_kernel(*args), tobs.draw_runs_loop(*args)


GRID = [(n_obs, n, steps) for n_obs in (1, 3) for n in (20, 1000, 1500)
        for steps in (26, 31, 41)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_obs,n_samples,steps", GRID)
def test_the_kernel_replays_the_loop_bit_for_bit(cuda, n_obs, n_samples,
                                                 steps):
    """For 1, 300 and 1024 runs: nominal, samples and realization equal
    to the loop's bit for bit (seed 0 in every chunk, 2^62 - 1 in the
    longer ones)."""
    for runs in (1, 300, 1024):
        got, want = _both(cuda, n_obs, n_samples, steps,
                          _seeds(runs, seed=runs + steps), seed=n_obs)
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), (runs, name)
            assert _equal_bits(a, b), (runs, name)


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [1, 300])
def test_the_kernel_replays_the_head_on_study(cuda, runs):
    """mc300's shapes: one obstacle, 20 samples, 151 steps."""
    got, want = _both(cuda, 1, 20, 151, _seeds(runs, seed=3))
    for a, b in zip(got, want):
        assert _equal_bits(a, b)


@pytest.mark.cuda
def test_a_study_draws_once_a_chunk_and_answers_as_the_loop(cuda,
                                                            monkeypatch):
    """700 runs in chunks of 300: three launches, 700 runs counted on the
    kernel, and the study's answers equal to those of the loop's draws."""
    params, scenario = Parameters(num_samples=20), get_scenario_config("head_on")
    statics = make_statics(scenario, params, F32, cuda)
    kw = dict(n_runs=700, seed=11, device=cuda, statics=statics,
              chunk_size=300)
    before = cuda_draws.obstacle_draws.launches
    res, counts, spans = _recorded(lambda: mc.run_monte_carlo_simulation(
        scenario, params, **kw))
    assert cuda_draws.obstacle_draws.launches - before == 3
    assert counts["obstacles.kernel_runs"] == 700
    assert "obstacles.loop_runs" not in counts
    assert spans["obstacles.generate"] == 3
    monkeypatch.setattr(mc, "use_draw_kernel", lambda *a: False)
    loop = mc.run_monte_carlo_simulation(scenario, params, **kw)
    assert cuda_draws.obstacle_draws.launches - before == 3
    for a, b in zip(res, loop):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_float64_on_the_card_takes_the_loop(cuda):
    params, scenario = Parameters(num_samples=10), get_scenario_config("head_on")
    statics = make_statics(scenario, params, F64, cuda)
    before = cuda_draws.obstacle_draws.launches
    out, counts, _ = _recorded(lambda: mc.run_obstacles(
        statics, _seeds(4), scenario, params, 20))
    assert cuda_draws.obstacle_draws.launches == before
    assert counts["obstacles.loop_runs"] == 4
    assert "obstacles.kernel_runs" not in counts
    assert out.samples.dtype == F64 and out.samples.is_cuda


# Studies of the failure scan (head_on_n20, `experiments/mc_failures.py`)
# whose float32 loop stalled a QP: (scan seed, study index).  In study
# 1123 of seed 2147484625 the warm float64 start stalled too, and run 22
# failed until the rescue's cold start.
SCAN_STUDIES = [(2147484625, 1123), (2147484625, 499), (1234567891011, 7986)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,study", SCAN_STUDIES)
def test_the_failing_studies_draw_as_the_loop(cuda, mc_failures, seed,
                                              study):
    """The kernel draws the study as the loop does, bit for bit, and
    every run ends converged."""
    summary = mc_failures.main(["--seed", str(seed), "--only", str(study),
                                "--draws", "compare"])
    assert summary["chunks_compared"] == 1
    assert summary["chunks_differing"] == 0
    assert summary["draw_kernel_runs"] == 300
    assert summary["failing_runs_f32"] >= 1
    assert summary["failing_runs_in_the_end"] == 0
