"""What the readers of the program's own spans and counters share (not a
metric of its own).

The program records them itself (`utils/timing.py` of the `_torch`
package: `SPANS` {name: [calls, host seconds]}, `COUNTS` {name: sum}),
only while its recorder is on. A reader that loads this file switches it
on; the harness loads readers only for a `--trace 1` run, and before the
warm-up, so an untraced run never records. A reader's hook, on a function
the cell's traffic spans, returns what the recorder added since that
hook's own previous call, so no reader clears what another reads. Where
the program has no recorder, there are no hooks and the readers read
nothing.
"""

import importlib

PORT = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"


def recorder():
    """The program's recorder, switched on; None where it has none."""
    try:
        timing = importlib.import_module(PORT + ".utils.timing")
    except ImportError:
        return None
    if not hasattr(timing, "since"):
        return None
    timing.record(True)
    return timing


def hooks(fname: str) -> dict:
    """{fname: hook}: at each call of `fname`, the recorder's totals added
    since the hook's previous call; {} without a recorder."""
    timing = recorder()
    if timing is None:
        return {}
    last = [timing.totals()]

    def hook(args, kwargs, out):
        added = timing.since(last[0])
        last[0] = timing.totals()
        return added

    return {fname: hook}


def span(values, name):
    """(calls, host seconds) of the span `name` over the hook's values."""
    got = [v["spans"][name] for v in values or () if name in v["spans"]]
    return sum(n for n, _ in got), sum(s for _, s in got)


def counter(values, name):
    """The counter `name` summed over the hook's values."""
    return sum(v["counts"].get(name, 0) for v in values or ())
