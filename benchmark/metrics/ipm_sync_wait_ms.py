"""ipm_sync_wait_ms: host ms a call of `_filter_core` spends blocked in
the IPM loop's readbacks (the program's own `ipm.sync` span, one a pass
and one more that finds every lane stopped): the host's wait on the
device, over the traced window's calls."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    values = trace.values.get(__name__)
    n, seconds = _rec.span(values, "ipm.sync")
    return 1e3 * seconds / len(values) if n else None
