"""halfspace_ms: device ms a call of
`simulation/environment.py::compute_safe_halfspaces_for_trajectory`: the
time of every device operation inside the stage's range (the row-layout
copy, kernel 1, the ego positions), over the profiled calls."""

NAME = "compute_safe_halfspaces_for_trajectory"


def read(trace):
    device_s, n = trace.stage_device_s.get(NAME), trace.stage_calls.get(NAME)
    if not device_s or not n:
        return None
    return 1e3 * device_s / n
