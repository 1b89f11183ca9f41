#!/usr/bin/env python3
"""How torch.profiler mirrors nested `record_function` ranges on the card.

    python3 experiments/range_probe.py        # on a machine with a CUDA card

An outer "stage:outer" range holds inner ranges, with direct kernels
before and after them, before them only, or none; an inner range holds
an aten kernel and the batched Cholesky kernel, launched through ctypes
as the port's hand kernels are. Each case prints the CUDA-side events
with their times (us from the first), so one can read whether the outer
range's device mirror still spans the inner range's kernels, and whether
a range opened with `torch._C._profiler._RecordFunctionFast` makes a
device mirror at all.

On an H100 with torch 2.11: an inner `record_function` range takes its
kernels out of the outer range's mirror, which spans only the outer
range's own kernels (none: no mirror at all); a `_RecordFunctionFast`
range makes no mirror and leaves the outer one whole. So the port's own
spans (`utils/timing.py`) are ranges of the second kind.
"""

import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops.cuda_linalg import (  # noqa: E402
    batched_cholesky)


def user(name):
    return torch.profiler.record_function(name)


def fast(name):
    return torch._C._profiler._RecordFunctionFast(name)


def around(inner, S, x):
    """Direct kernels before and after the inner range."""
    with user("stage:outer"):
        a = x * 2.0
        with inner("stage:inner"):
            b = a + 1.0
            batched_cholesky(S)
        return b * 3.0


def only_inner(inner, S, x):
    """Every kernel of the outer range inside inner ranges."""
    with user("stage:outer"):
        with inner("stage:inner"):
            a = x * 2.0
        with inner("stage:inner"):
            b = a + 1.0
            batched_cholesky(S)
        return b


def inner_last(inner, S, x):
    """A direct kernel, then the inner range last."""
    with user("stage:outer"):
        a = x * 2.0
        with inner("stage:inner"):
            b = a + 1.0
            batched_cholesky(S)
        return b


def main():
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    M = torch.randn(64, 30, 30, device=dev)
    S = M @ M.transpose(1, 2) + 30 * torch.eye(30, device=dev)
    x = torch.randn(1 << 20, device=dev)
    for kind, inner, work in (("user", user, around), ("fast", fast, around),
                              ("user", user, only_inner),
                              ("fast", fast, only_inner),
                              ("user", user, inner_last)):
        work(inner, S, x)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            work(inner, S, x)
            torch.cuda.synchronize()
        evs = prof.events()
        t0 = min(e.time_range.start for e in evs)
        print(f"--- {work.__name__}, inner range: {kind}")
        for e in sorted(evs, key=lambda e: e.time_range.start):
            if e.device_type == DeviceType.CUDA:
                print(f"  CUDA {e.name[:60]:60s} "
                      f"{e.time_range.start - t0:9.1f} "
                      f"{e.time_range.end - t0:9.1f}")
        names = [e.name for e in evs if e.device_type == DeviceType.CPU]
        print("  CPU ranges:", [n for n in names if n.startswith("stage:")])


if __name__ == "__main__":
    main()
