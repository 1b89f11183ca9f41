"""filter_core_ms: host ms a call of `models/mpc_filter.py::_filter_core`
(QP assembly, the IPM, the polish), rebound from the benchmark in the
pipeline's module. The IPM loop reads a flag back every pass, so this is
nearly the stage's wall. Read over the whole traced window."""


def read(trace):
    spans = trace.spans.get("_filter_core")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
