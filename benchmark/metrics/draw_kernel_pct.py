"""draw_kernel_pct: the share of Monte Carlo runs whose obstacles the draw
kernel drew, over the traced window's calls of
`evaluation/monte_carlo.py::run_obstacles`: the program's counter
`obstacles.kernel_runs` over it and `obstacles.loop_runs` (the runs drawn
one generator a run, in a Python loop). Where the program counts neither
(a program without the draw kernel) the reader reads nothing."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("run_obstacles")


def read(trace):
    values = trace.values.get(__name__)
    kernel = _rec.counter(values, "obstacles.kernel_runs")
    loop = _rec.counter(values, "obstacles.loop_runs")
    if not kernel + loop:
        return None
    return 100.0 * kernel / (kernel + loop)
