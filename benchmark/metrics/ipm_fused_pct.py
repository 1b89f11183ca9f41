"""ipm_fused_pct: the share of the IPM's passes run on the fused pass
kernels over the traced window's calls of `_filter_core`: the program's
counter `ipm.fused_passes` over `ipm.passes`. Where the program counts no
fused pass at all (a program without the fused kernels, or the CPU) the
reader reads nothing."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    values = trace.values.get(__name__)
    passes = _rec.counter(values, "ipm.passes")
    fused = _rec.counter(values, "ipm.fused_passes")
    if not passes or not any("ipm.fused_passes" in v["counts"]
                             for v in values or ()):
        return None
    return 100.0 * fused / passes
