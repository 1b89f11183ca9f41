"""device_idle_pct: the share of the profiled stretch in which no
operation ran on the device: 1 - (union of device operation intervals) /
(the stretch's length on the host clock)."""


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
