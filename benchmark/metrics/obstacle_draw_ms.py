"""obstacle_draw_ms: host ms one draw of
`simulation/obstacles.py::generate_obstacle_scenarios` (the program's
own `obstacles.generate` span; a Monte Carlo study makes one a run, in
`evaluation/monte_carlo.py::run_obstacles`), over the traced window's
calls of `run_obstacles`."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("run_obstacles")


def read(trace):
    n, seconds = _rec.span(trace.values.get(__name__), "obstacles.generate")
    return 1e3 * seconds / n if n else None
