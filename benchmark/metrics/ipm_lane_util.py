"""ipm_lane_util: the share of the IPM's lane passes that work on a lane
still active, over the traced window's calls of `_filter_core` (one
solve each): the program's counter `ipm.lane_passes` (the lanes active
at each pass, summed) over `ipm.lanes` x `ipm.passes` of each call. The
rest is device work on lanes that have stopped and are carried along."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    counts = [v["counts"] for v in trace.values.get(__name__) or ()]
    slots = sum(c.get("ipm.lanes", 0) * c.get("ipm.passes", 0) for c in counts)
    if not slots:
        return None
    return 100.0 * sum(c.get("ipm.lane_passes", 0) for c in counts) / slots
