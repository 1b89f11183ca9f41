#!/usr/bin/env python3
"""Where the time of the port's batch run goes, on one NVIDIA H100.

    python3 chip_profile.py          # from the root of a checkout

Drives `chip_smoke.py`'s batch run (256 multi_obstacle scenarios, 1000
samples per obstacle, 30 steps, float32) through `run_scenario_core`:
two warm-up drives, five unprofiled drives timed on the host clock, then
one drive under `torch.profiler` (CPU and CUDA activities).  Each stage
of the pipeline is wrapped in a `record_function` range for the trace
only; the port itself is not changed.  It prints:

  - the card's name and power limit, and the SM clock and power draw
    after the run (nvidia-smi);
  - the five unprofiled walls and the IPM iteration counts;
  - the profiled wall, the number of device kernels, the device-busy
    time (union of kernel intervals) and the idle share;
  - host and device ms per stage, the hand-written kernels' count and
    time, and the top kernels by device time.

It imports torch, the port and chip_smoke -- never jax.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time

import chip_smoke as cs

STAGES = ("generate_obstacle_scenarios", "straight_line_trajectory",
          "compute_safe_halfspaces_for_trajectory", "_filter_core",
          "simulate_linear_system", "compute_distance_to_collision")
HAND_KERNELS = ("halfspace_warp_kernel", "halfspace_block_kernel",
                "cholesky_kernel", "cho_solve_")
WARMUP, TIMED = 2, 5


def wrap_stages(torch, pipe) -> None:
    """Wrap each stage function the pipeline module calls in a range."""
    for name in STAGES:
        fn = getattr(pipe, name)

        @functools.wraps(fn)
        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function("stage:" + _name):
                return _fn(*args, **kwargs)

        setattr(pipe, name, ranged)


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    sys.path[:0] = [str(cs.ROOT), str(cs.ROOT / "tests")]
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    pt.models.pipeline.pin_matmul_precision(dev)
    wrap_stages(torch, pt.models.pipeline)
    params, scenario, statics = cs.batch_setup(pt, torch, dev)
    for _ in range(WARMUP):
        cs.run_batch(pt, torch, dev, params, scenario, statics)
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        res = cs.run_batch(pt, torch, dev, params, scenario, statics)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    iters = res.qp_iterations.float()
    print(f"[profile] unprofiled walls ms {[round(w, 3) for w in walls]}; "
          f"IPM iterations max {int(iters.max())}, mean "
          f"{float(iters.mean()):.4f}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cs.run_batch(pt, torch, dev, params, scenario, statics)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("stage:")]
    if not kernels:
        raise SystemExit("chip_profile: the trace holds no device kernel")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    print(f"[profile] profiled wall {wall_us / 1e3:.3f} ms; "
          f"{len(kernels)} device kernels; busy {busy / 1e3:.3f} ms; "
          f"idle {1 - busy / wall_us:.4f} of the wall")

    # Each stage range appears twice: as a host range (host time, and
    # the device time of the kernels it launched) and as its mirror on
    # the device timeline (the span from its first to its last kernel).
    stages = {}
    for e in prof.key_averages():
        if e.key.startswith("stage:"):
            row = stages.setdefault(e.key[6:], [0.0, 0.0, 0.0])
            if e.device_type == DeviceType.CPU:
                row[0] += e.cpu_time_total / 1e3
                row[1] += e.device_time_total / 1e3
            else:
                row[2] += e.device_time_total / 1e3
    for name, (host, kern, span) in stages.items():
        print(f"[profile] {name}: host {host:.3f} ms, device kernels "
              f"{kern:.3f} ms, device span {span:.3f} ms")
    by_name = {}
    for e in kernels:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1,
                           us + e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in ranked:
        if any(k in name for k in HAND_KERNELS):
            print(f"[profile] hand kernel {name[:60]}: {count} launches, "
                  f"{us / 1e3:.3f} ms")
    for name, (count, us) in ranked[:10]:
        print(f"[profile] top {us / 1e3:9.3f} ms {count:5d}x {name[:90]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
