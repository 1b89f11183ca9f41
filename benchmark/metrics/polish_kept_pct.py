"""polish_kept_pct: the share of the IPM's lanes whose polished iterate
is kept (its merit is lower than the loop's best), over the traced
window's calls of `_filter_core`: the program's counters
`ipm.polish_kept` over `ipm.lanes`."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    values = trace.values.get(__name__)
    lanes = _rec.counter(values, "ipm.lanes")
    if not lanes:
        return None
    return 100.0 * _rec.counter(values, "ipm.polish_kept") / lanes
