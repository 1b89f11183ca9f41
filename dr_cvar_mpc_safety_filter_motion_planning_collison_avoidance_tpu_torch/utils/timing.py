"""Timing and profiling utilities.

Port of the JAX package's utils/timing.py: the `Timer` context manager,
the `timeit` decorator, `time_blocked`, the `TimingStats` aggregator,
and the profiling hooks `trace` / `annotate`.  Where JAX waits with
`block_until_ready`, the port calls `torch.cuda.synchronize()` when the
value holds a CUDA tensor; `trace` is a `torch.profiler` capture written
as a Chrome trace, and `annotate` a `torch.profiler.record_function`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np
import torch


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


def timeit(func):
    """Decorator printing wall-clock time."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with Timer(func.__name__):
            return func(*args, **kwargs)

    return wrapper


def time_blocked(fn, *args, **kwargs):
    """Run `fn`, wait for its device results, return
    (result, elapsed_seconds)."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    block_until_ready(result)
    return result, time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Optional `torch.profiler` trace of the enclosed block, written to
    `log_dir/trace.json` (Chrome trace format; Perfetto reads it).  CPU
    activity always, CUDA activity where torch sees a device.  None is a
    no-op, so callers can wrap code unconditionally:

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
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a `trace` capture (shows up on the trace
    timeline).  Usable as context manager or decorator."""
    return torch.profiler.record_function(name)


class TimingStats:
    """Accumulator with mean/std/min/max/count printout."""

    def __init__(self):
        self.data: dict[str, list[float]] = {}

    def add(self, name: str, time_value: float):
        self.data.setdefault(name, []).append(time_value)

    def get_stats(self, name: str):
        if not self.data.get(name):
            return None
        times = np.asarray(self.data[name])
        return {
            "mean": float(times.mean()),
            "std": float(times.std()),
            "min": float(times.min()),
            "max": float(times.max()),
            "count": int(times.size),
        }

    def print_stats(self):
        for name in self.data:
            stats = self.get_stats(name)
            print(f"{name}:")
            print(f"  Mean: {stats['mean']:.6f} seconds")
            print(f"  Std:  {stats['std']:.6f} seconds")
            print(f"  Min:  {stats['min']:.6f} seconds")
            print(f"  Max:  {stats['max']:.6f} seconds")
            print(f"  Count: {stats['count']}")
