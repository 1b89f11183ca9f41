"""halfspace_cluster_pct: the share of the halfspace rows that kernel 1's
cluster path (a thread-block cluster a row, rows of more than 49,152
samples) took over the traced window's calls: the program's counter
`halfspace.rows_cluster` over its four row counters (`halfspace.rows_warp`,
`halfspace.rows_block`, `halfspace.rows_cluster`, `halfspace.rows_plain`),
each counted where the path is taken. A program that counts rows but has
no cluster path reads 0 (its long rows are counted plain); one that counts
no rows at all reads nothing."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("compute_safe_halfspaces_for_trajectory")
PATHS = ("halfspace.rows_warp", "halfspace.rows_block",
         "halfspace.rows_cluster", "halfspace.rows_plain")


def read(trace):
    values = trace.values.get(__name__)
    rows = sum(_rec.counter(values, name) for name in PATHS)
    if not rows:
        return None
    return 100.0 * _rec.counter(values, "halfspace.rows_cluster") / rows
