"""`run.py` end to end: without a card it exits with code 2 and prints no
result; on a card (the `cuda` marker) a short run of a cell prints the
result line with its keys in order and `correct` true."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def run_cli(*args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    res = run_cli("--workload", "multi_obstacle_n1000.loop", "--seed", "1",
                  "--seconds", "1", "--trace", "0", timeout=120)
    assert res.returncode == 2
    assert res.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_cli("--workload", "multi_obstacle_n1000.halfspaces1024",
                  "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0")
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"halfspace_rows_per_s", "setup_s"}
    assert res.stderr.strip().splitlines()[-1].startswith("check halfspace_gap")
