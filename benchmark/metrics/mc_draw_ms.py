"""mc_draw_ms: host ms a study spends in
`evaluation/monte_carlo.py::run_obstacles` (one card generator a run, in a
Python loop), rebound from the benchmark. Read over the whole traced
window: the draws' host time over the studies run."""


def read(trace):
    spans = trace.spans.get("run_obstacles")
    if not spans or not trace.calls:
        return None
    return 1e3 * sum(spans) / trace.calls
