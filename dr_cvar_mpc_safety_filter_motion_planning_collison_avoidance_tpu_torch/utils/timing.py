"""Timing and profiling utilities, and the port's recorder of its own
spans and counters.

Port of the JAX package's utils/timing.py: the `Timer` context manager,
`time_blocked`, and the profiling hooks `trace` / `annotate`.  Where JAX
waits with `block_until_ready`, the port calls `torch.cuda.synchronize()`
when the value holds a CUDA tensor; `trace` is a `torch.profiler` capture
written as a Chrome trace.

The recorder is off unless `record(True)` or a `trace` block switches it
on.  Off, a span site (`with annotate(name):`) tests one module-level
flag and does nothing else, and `count` returns at once.  On, a span
opens a host-side range on the profiler's timeline, so that a device
trace puts the host's time between kernels down to the layer that spent
it, and adds its host-clock duration to `SPANS`; `count` adds to
`COUNTS`.  Spans are named by layer (`ipm.pass`, `halfspace.rows`, ...),
as `PERF.md` lists them.  A reader takes `totals()` and later `since()`
that reading, or clears both maps with `reset()` before the run it
should count, as `parallel.CENSUS` is read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch

RECORDING = False
SPANS: dict[str, list] = {}            # name -> [calls, host seconds]
COUNTS: collections.Counter = collections.Counter()
_OFF = contextlib.nullcontext()


def block_until_ready(value):
    """Wait for the device work behind `value` (a tensor, or a nested
    tuple / list / dict of them); CPU values are ready already."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            block_until_ready(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            block_until_ready(v)
    return value


class Timer:
    """Context-manager timer.  `stop(block=value)` waits for the device
    work behind `value` first, so asynchronous CUDA work is measured."""

    def __init__(self, name: str | None = None, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.start_time = None
        self.elapsed = 0.0

    def start(self):
        self.start_time = time.perf_counter()
        return self

    def stop(self, block=None):
        if self.start_time is None:
            raise ValueError("Timer not started")
        if block is not None:
            block_until_ready(block)
        self.elapsed = time.perf_counter() - self.start_time
        self.start_time = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *args):
        self.stop()
        if self.name and self.verbose:
            print(f"{self.name}: {self.elapsed:.6f} seconds")


def time_blocked(fn, *args, **kwargs):
    """Run `fn`, wait for its device results, return
    (result, elapsed_seconds)."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    block_until_ready(result)
    return result, time.perf_counter() - t0


def record(on: bool = True) -> bool:
    """Switch the recorder on or off; returns its previous state."""
    global RECORDING
    was, RECORDING = RECORDING, bool(on)
    return was


def reset():
    """Clear the recorder's totals."""
    SPANS.clear()
    COUNTS.clear()


def totals() -> dict:
    """A copy of the totals: {"spans": {name: [calls, host seconds]},
    "counts": {name: sum}}."""
    return {"spans": {k: list(v) for k, v in SPANS.items()},
            "counts": dict(COUNTS)}


def since(before: dict) -> dict:
    """The totals added since the reading `before` (a `totals()`), in
    its form; names that did not move are left out."""
    spans = {}
    for k, (n, s) in SPANS.items():
        n0, s0 = before["spans"].get(k, (0, 0.0))
        if n != n0:
            spans[k] = [n - n0, s - s0]
    counts = {k: v - before["counts"].get(k, 0) for k, v in COUNTS.items()
              if v != before["counts"].get(k, 0)}
    return {"spans": spans, "counts": counts}


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` while the recorder is on."""
    if RECORDING:
        COUNTS[name] += n


class _Span:
    """One span of the recorder: a host-side range on the profiler's
    timeline (it makes no device-side mirror, so it neither counts as a
    device operation nor takes kernels out of a `record_function` range
    around it) and a host-clock duration added to SPANS."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        entry = SPANS.setdefault(self.name, [0, 0.0])
        entry[0] += 1
        entry[1] += dt
        return False


def annotate(name: str):
    """The span `name` as a context manager: with the recorder on, a
    range on the profiler's timeline and a duration in SPANS; with it
    off, a shared no-op."""
    return _Span(name) if RECORDING else _OFF


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Optional `torch.profiler` trace of the enclosed block, written to
    `log_dir/trace.json` (Chrome trace format; Perfetto reads it), with
    the recorder on: its totals over the block go to `log_dir/spans.json`.
    CPU activity always, CUDA activity where torch sees a device.  None
    is a no-op, so callers can wrap code unconditionally:

        with trace(args.profile_dir):
            run_monte_carlo_simulation(...)
    """
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before, was = totals(), record(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        record(was)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump(since(before), fh, indent=1)
