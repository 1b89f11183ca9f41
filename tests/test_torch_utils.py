"""PyTorch port: utils/timing.py (the timers and the profiler hooks), as
tests/test_evaluation.py checks the JAX package's; the recorder's own
tests are in test_torch_recorder.py."""

import json

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    Timer, annotate, block_until_ready, time_blocked, timing, trace)


def test_timer_and_stats(capsys):
    with Timer("unit") as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert "unit: " in capsys.readouterr().out
    with Timer("quiet", verbose=False) as quiet:
        pass
    assert quiet.elapsed >= 0.0 and capsys.readouterr().out == ""
    assert quiet.start_time is None


def test_timer_stop_waits_on_a_value_and_rejects_a_second_stop():
    timer = Timer().start()
    value = {"a": (torch.ones(3), [torch.zeros(2)])}
    assert timer.stop(block=value) >= 0.0
    with pytest.raises(ValueError, match="not started"):
        timer.stop()
    assert block_until_ready(value) is value


def test_timeit_and_time_blocked():
    result, seconds = time_blocked(torch.ones, 4)
    assert torch.equal(result, torch.ones(4)) and seconds >= 0.0
    (total, parts), seconds = time_blocked(
        lambda n: (torch.arange(n).sum(), [torch.zeros(2)]), 10)
    assert int(total) == 45 and seconds >= 0.0


def test_profiler_trace_hook(tmp_path):
    """`trace` writes a Chrome trace holding the annotated region and the
    recorder's totals of the block beside it, and is a no-op without a
    directory."""
    was = timing.record(False)
    try:
        with trace(None):
            with annotate("unit-region"):
                pass
        assert "unit-region" not in timing.SPANS
        log_dir = tmp_path / "trace"
        with trace(str(log_dir)):
            with annotate("unit-region"):
                torch.ones((8, 8)) @ torch.ones((8, 8))
        assert not timing.RECORDING
    finally:
        timing.record(was)
    path = log_dir / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "unit-region" for e in events)
    spans = json.loads((log_dir / "spans.json").read_text())["spans"]
    assert spans["unit-region"][0] == 1
