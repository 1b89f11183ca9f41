"""ipm_pass_host_ms: host ms a pass of the IPM loop of
`ops/qp_ipm_structured.py::solve_mpc_qp`, from the program's own
`ipm.pass` span (a pass's work without its readback, which is
`ipm.sync`): the span's seconds over its calls, over the traced window's
calls of `_filter_core`."""

from pathlib import Path

import harness

_rec = harness._load_module(Path(__file__).with_name("_recorder.py"),
                            "bench_metric__recorder")
HOOKS = _rec.hooks("_filter_core")


def read(trace):
    n, seconds = _rec.span(trace.values.get(__name__), "ipm.pass")
    return 1e3 * seconds / n if n else None
