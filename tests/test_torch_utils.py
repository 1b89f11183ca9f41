"""PyTorch port: utils/timing.py (timers, stats and the profiler hooks),
as tests/test_evaluation.py checks the JAX package's."""

import json

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    Timer, TimingStats, annotate, block_until_ready, time_blocked, timeit,
    trace)


def test_timer_and_stats(capsys):
    with Timer("unit") as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert "unit: " in capsys.readouterr().out
    stats = TimingStats()
    stats.add("x", 1.0)
    stats.add("x", 3.0)
    s = stats.get_stats("x")
    assert s == {"mean": 2.0, "std": 1.0, "min": 1.0, "max": 3.0,
                 "count": 2}
    assert stats.get_stats("missing") is None
    stats.print_stats()
    assert "Count: 2" in capsys.readouterr().out


def test_timer_stop_waits_on_a_value_and_rejects_a_second_stop():
    timer = Timer().start()
    value = {"a": (torch.ones(3), [torch.zeros(2)])}
    assert timer.stop(block=value) >= 0.0
    with pytest.raises(ValueError, match="not started"):
        timer.stop()
    assert block_until_ready(value) is value


def test_timeit_and_time_blocked(capsys):
    @timeit
    def work(n):
        return torch.arange(n).sum()

    assert int(work(10)) == 45
    assert "work: " in capsys.readouterr().out
    result, seconds = time_blocked(torch.ones, 4)
    assert torch.equal(result, torch.ones(4)) and seconds >= 0.0


def test_profiler_trace_hook(tmp_path):
    """`trace` writes a Chrome trace holding the annotated region, and is
    a no-op without a directory."""
    with trace(None):
        pass
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("unit-region"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    path = log_dir / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "unit-region" for e in events)
