"""The reader of `draw_kernel_pct`: the share of Monte Carlo runs drawn by
the draw kernel, read from the program's counters
`obstacles.kernel_runs` and `obstacles.loop_runs`; nothing where the
program counts neither (a program without the draw kernel), and nothing
without a recorder."""

import pytest

import harness
from conftest import BENCH, run_small

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

NAME = "draw_kernel_pct"


@pytest.fixture(autouse=True)
def recorder_state():
    saved = timing.RECORDING, timing.totals()
    timing.record(False)
    timing.reset()
    yield
    timing.record(saved[0])
    timing.reset()
    timing.SPANS.update(saved[1]["spans"])
    timing.COUNTS.update(saved[1]["counts"])


def trace(values):
    return harness.TraceData(
        config={}, traffic={}, calls=0, spans={}, values=values,
        profiled_values={}, stage_device_s={}, stage_calls={}, busy_s=0.0,
        window_s=0.0, profile_calls=0)


def _call(counts):
    return {"spans": {}, "counts": counts}


@pytest.mark.parametrize("counts,share", [
    ([{"obstacles.kernel_runs": 300}, {"obstacles.kernel_runs": 300}], 100.0),
    ([{"obstacles.loop_runs": 300}], 0.0),
    ([{"obstacles.kernel_runs": 300}, {"obstacles.loop_runs": 100}], 75.0),
])
def test_reads_the_share_of_kernel_drawn_runs(counts, share):
    mod = harness.metric_reader(BENCH, NAME)
    calls = [_call(c) for c in counts]
    assert mod.read(trace({mod.__name__: calls})) == pytest.approx(share)


def test_reads_nothing_without_the_counters():
    """The parent's program: draws, but neither counter."""
    mod = harness.metric_reader(BENCH, NAME)
    assert mod.read(trace({})) is None
    plain = [_call({"ipm.passes": 12})]
    assert mod.read(trace({mod.__name__: plain})) is None


def test_without_a_recorder_it_hooks_nothing(monkeypatch):
    monkeypatch.delattr(timing, "since")
    mod = harness.metric_reader(BENCH, NAME)
    assert mod.HOOKS == {} and mod.read(trace({})) is None


def test_a_traced_cpu_run_reads_the_loop():
    """The CPU draws one generator a run: the traced line reads 0, and
    the run is correct."""
    res = run_small("head_on_n20.mc300", trace=True)
    assert res["correct"]
    assert res["metrics"][NAME]["value"] == 0.0
    assert res["metrics"][NAME]["unit"] == "%"
