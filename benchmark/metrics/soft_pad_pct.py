"""soft_pad_pct: the share of the QPs' soft rows that are padding over
the traced window's calls: the program's counter `filter.padded_rows`
(the inactive rows past the simulation's end, where `sim_time` is
shorter than the horizon) over `filter.soft_rows` (B x H x n_obs a
call). Where the program counts no soft rows (a program without these
counters) the reader reads nothing."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    values = trace.values.get(__name__)
    soft = _rec.counter(values, "filter.soft_rows")
    if not soft:
        return None
    return 100.0 * _rec.counter(values, "filter.padded_rows") / soft
