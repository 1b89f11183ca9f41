"""Shared set-up of the benchmark's tests: the benchmark's folder and the
checkout's root on sys.path, and small sizes of each cell that a CPU test
run holds (the harness runs them on the CPU, skipping run.py's look for a
card)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "multi_obstacle_n1000.batch256": {
        "config": {"num_samples": 40},
        "traffic": {"scenarios": 4, "pool": 2, "warmup_calls": 1,
                    "profile_calls": 1}},
    "head_on_n20.mc300": {
        "traffic": {"runs": 40, "warmup_calls": 1, "profile_calls": 1}},
    "multi_obstacle_n1000.loop": {
        "config": {"num_samples": 40},
        "traffic": {"pool": 4, "warmup_calls": 1, "profile_calls": 1,
                    "check_calls": 4}},
    "multi_obstacle_n1000.halfspaces1024": {
        "config": {"num_samples": 40},
        "traffic": {"scenarios": 8, "pool": 2, "warmup_calls": 1,
                    "profile_calls": 2}},
}
SEED = 2 ** 31 + 977


@pytest.fixture(scope="session")
def root():
    return ROOT


def run_small(cell, seed=SEED, seconds=0.3, trace=False, control=False,
              root=ROOT):
    import harness
    return harness.run(root, cell, seed, seconds, trace, device="cpu",
                       overrides=SMALL[cell], control=control,
                       log=lambda s: None)
