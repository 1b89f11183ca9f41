"""The benchmark's harness: finds a cell's files by the names in
`BENCHMARK.json`, runs its set-up, warm-up, measured window, traced
stretch and output check, and builds the result line.

What belongs to one configuration, traffic mix, cell or per-layer metric
sits in files of its own, found by name:

  configs/<config>.json           the deployment (`file` in BENCHMARK.json)
  traffic/<traffic>.json          the traffic mix: its driver and parameters
  drivers/<driver>.py             the generator of one kind of traffic
  limits/<cell>.json              the limits of the numbers `correct` compares
  metrics/<metric>.py             the reader of one per-layer metric; a
                                  metric `a.b` without a file of its own is
                                  read by `metrics/a.py`

The harness imports torch when it runs a cell, the program (the `_torch`
package at the checkout's root) through the drivers, and never jax.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PORT = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax",
             "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu")


# --- discovery -------------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workload's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # limits/<cell>.json: {number: limit}
    driver: object         # drivers/<driver>.py
    end_to_end: list       # BENCHMARK.json's end-to-end metrics of the cell
    per_layer: list        # and its per-layer metrics


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str, overrides: dict | None = None) -> Cell:
    """The cell `name` with every file it names; `overrides` ({"config":
    {...}, "traffic": {...}}) replace keys (the tests' small sizes)."""
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    overrides = overrides or {}
    config = json.loads((root / conf["file"]).read_text())
    config.update(overrides.get("config", {}))
    base = root / bench["paths"][0]
    traffic = json.loads((base / "traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update(overrides.get("traffic", {}))
    limits = json.loads((base / "limits" / f"{name}.json").read_text())["limits"]
    driver = _load_module(base / "drivers" / f"{traffic['driver']}.py",
                          f"bench_driver_{traffic['driver']}")
    return Cell(name, entry, config, traffic, limits, driver,
                [m for m in bench["end_to_end"] if _in_cell(m, name)],
                [m for m in bench["per_layer"] if _in_cell(m, name)])


def metric_reader(base: Path, metric: str):
    """metrics/<metric>.py, else metrics/<metric up to its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_module(path, "bench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r}")


# --- arithmetic of the end-to-end metrics ----------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(spec: dict, units: float, elapsed: float, latencies) -> float:
    """A traffic file's metric: {"kind": "rate"} is all units completed
    over all of the window; {"kind": "percentile", "q": 95} is the q-th
    percentile over every call's latency, in ms."""
    if spec["kind"] == "rate":
        return units / elapsed
    if spec["kind"] == "percentile":
        return percentile(latencies, spec["q"]) * 1e3
    raise ValueError(f"unknown metric kind {spec['kind']!r}")


def derive_seed(seed: int, *keys) -> int:
    """A seed for one purpose of a run, from the run's seed."""
    words = [int(seed) % 2 ** 32, int(seed) // 2 ** 32]
    words += [sum(ord(c) << (8 * (i % 4)) for i, c in enumerate(str(k)))
              for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               % 2 ** 62)


# --- spans ----------------------------------------------------------------

class Spans:
    """Rebinds functions of the program's modules so that each call is a
    `record_function` range ("stage:<name>") and a host-clock span, and
    runs the readers' hooks on its arguments and result. The program's
    files are not changed; `restore` puts the originals back."""

    def __init__(self, torch, hooks):
        self.torch, self.hooks = torch, hooks   # {fname: [(key, fn)]}
        self.host_s, self.values, self._saved = {}, {}, []

    def reset(self):
        self.host_s, self.values = {}, {}

    def wrap(self, module, name: str):
        fn = getattr(module, name)
        self._saved.append((module, name, fn))
        torch, spans = self.torch, self

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with torch.profiler.record_function("stage:" + name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                spans.host_s.setdefault(name, []).append(time.perf_counter() - t0)
            for key, hook in spans.hooks.get(name, ()):
                spans.values.setdefault(key, []).append(hook(args, kwargs, out))
            return out

        setattr(module, name, ranged)

    def restore(self):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved = []


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


def merged(intervals):
    """The union of intervals as sorted disjoint [start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _values(x):
    """Hook values to plain numbers (tensors read once, after the window)."""
    if isinstance(x, (tuple, list)):
        return tuple(_values(v) for v in x)
    return float(x) if hasattr(x, "item") else x


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read."""
    config: dict
    traffic: dict
    calls: int                 # the window's calls of the driver
    spans: dict                # {fname: [host s a call]} over the window
    values: dict               # {hook key: [value a call]} over the window
    profiled_values: dict      # the same over the profiled stretch
    stage_device_s: dict       # {fname: device s inside its ranges}, profiled
    stage_calls: dict          # {fname: calls in the profiled stretch}
    busy_s: float              # union of device operations, profiled stretch
    window_s: float            # the profiled stretch's length
    profile_calls: int


def reduce_profile(prof, torch):
    """(kernels [(name, start us, end us)], cpu ops [(start, end, name)],
    {stage: device us}, {stage: calls}) of a torch.profiler run.

    A stage's device time is the device time that falls inside the
    device-side mirror of its ranges (from the first to the last operation
    launched inside it; one stream, so no other stage's work interleaves):
    the hand kernels are launched through ctypes, outside any aten op, and
    the host ranges' own `device_time_total` leaves them out."""
    from torch.autograd import DeviceType
    kernels, cpu, stage_n, mirrors = [], [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("stage:"):
                mirrors.setdefault(e.name[6:], []).append(
                    (e.time_range.start, e.time_range.end))
            else:
                kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
            if e.name.startswith("stage:"):
                stage_n[e.name[6:]] = stage_n.get(e.name[6:], 0) + 1
    busy = merged((s, e) for _, s, e in kernels)
    stage_us = {k: overlap_us(busy, merged(v)) for k, v in mirrors.items()}
    return kernels, cpu, stage_us, stage_n


def overlap_us(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def breakdown(kernels, cpu, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    between device operations summed by what the host was doing at each
    gap's middle (the innermost host operation open there)."""
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    import bisect
    gaps = {}
    busy = merged((s, e) for _, s, e in kernels)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        what = "host: no operation open"
        for j in range(i, max(i - 2000, -1), -1):
            if cpu[j][1] >= mid:
                what = cpu[j][2]
                break
        gaps[what] = gaps.get(what, 0.0) + (s1 - e0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle]}


# --- a run -----------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    """What a driver's set-up gets."""
    pt: object             # the program (the `_torch` package)
    torch: object
    device: object
    config: dict
    traffic: dict
    seed: int
    params: object         # the program's Parameters of the configuration
    scenario: object       # and its Scenario


def make_ctx(cell: Cell, seed: int, device, torch):
    pt = importlib.import_module(PORT)
    c = cell.config
    keys = {f.name for f in dataclasses.fields(pt.config.Parameters)}
    params = pt.config.Parameters(**{k: v for k, v in c.items() if k in keys})
    obs = c["obstacles"]
    f64 = lambda v: np.asarray(v, dtype=np.float64)   # noqa: E731
    scenario = pt.config.Scenario(
        name=c["scenario"], description=c["scenario"],
        ego_start=f64(c["ego_start"]), ego_goal=f64(c["ego_goal"]),
        obstacle_starts=f64([o["start"] for o in obs]),
        obstacle_directions=f64([o["direction"] for o in obs]),
        obstacle_speeds=f64([o["speed"] for o in obs]))
    return Ctx(pt, torch, torch.device(device), c, cell.traffic, seed, params,
               scenario)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Modules of jax, jaxlib, flax or the JAX package that this process
    holds, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(root, name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None, overrides=None,
        control: bool = False,
        log=lambda s: print(s, file=sys.stderr, flush=True)):
    """One run of a cell. Returns the result line's object, with the
    numbers compared under "check", last; raises RuntimeError when the
    process holds jax or the JAX package once the window has closed.
    With `control`, the result also holds, under "control", the same
    numbers of the control (the reference computed in TF32 in the
    program's place) on the kept calls' inputs (calibrate.py)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    cell = find_cell(root, name, overrides)
    drv, traffic = cell.driver, cell.traffic
    base = root / load_benchmark(root)["paths"][0]
    ctx = make_ctx(cell, seed, device, torch)

    readers, hooks = {}, {}
    if trace:
        for m in cell.per_layer:
            mod = metric_reader(base, m["name"])
            readers[m["name"]] = mod
            for fname, fn in getattr(mod, "HOOKS", {}).items():
                key = mod.__name__
                if all(k != key for k, _ in hooks.get(fname, [])):
                    hooks.setdefault(fname, []).append((key, fn))
    spans = Spans(torch, hooks)
    state = drv.setup(ctx)
    if trace:
        for target in traffic.get("spans", []):
            mod_name, fname = target.rsplit(".", 1)
            spans.wrap(importlib.import_module(f"{PORT}.{mod_name}"), fname)

    n_warm = traffic["warmup_calls"]
    for i in range(n_warm):
        drv.call(state, i)
    sync(torch, device)
    spans.reset()

    keep = random.Random(derive_seed(seed, "keep"))
    n_keep = traffic["check_calls"]
    kept, units, failed, raised, lat = [], 0.0, 0.0, 0, []
    calls = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        try:
            rec = drv.call(state, n_warm + calls)
        except Exception as exc:   # a call that raises: its answers never came
            log(f"call {calls} raised {type(exc).__name__}: {exc}")
            raised += 1
            units += drv.units(state)
            failed += drv.units(state)
            rec = None
        calls += 1
        if rec is not None:
            units += rec.units
            failed += rec.failed
            lat.append(rec.latency_s)
            if len(kept) < n_keep:
                kept.append(rec.keep)
            else:
                j = keep.randrange(calls)
                if j < n_keep:
                    kept[j] = rec.keep
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics, dev = {}, {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if cuda
                        else "cpu", "count": 1, "memory_peak_bytes": peak}
    extra = {}
    if trace:
        window_vals = {k: [_values(v) for v in vs] for k, vs in spans.values.items()}
        window_spans = dict(spans.host_s)
        spans.reset()
        n_prof = traffic["profile_calls"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            tp = time.perf_counter()
            for j in range(n_prof):
                drv.call(state, n_warm + calls + j)
            sync(torch, device)
            window_s = time.perf_counter() - tp
        kernels, cpu_ops, stage_us, stage_n = reduce_profile(prof, torch)
        busy_s = busy_us((s, e) for _, s, e in kernels) * 1e-6
        td = TraceData(cell.config, traffic, calls, window_spans, window_vals,
                       {k: [_values(v) for v in vs] for k, vs in spans.values.items()},
                       {k: v * 1e-6 for k, v in stage_us.items()}, stage_n,
                       busy_s, window_s, n_prof)
        spans.restore()
        for m in cell.per_layer:
            value = readers[m["name"]].read(td)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = busy_s, window_s
        if kernels:
            extra["breakdown"] = breakdown(kernels, cpu_ops)
    else:
        specs = traffic["metrics"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in specs:
                metrics[m["name"]] = {
                    "value": end_to_end(specs[m["name"]], units, elapsed, lat),
                    "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {', '.join(found)} after the window")

    # The output check, once the window has closed and the peak is read.
    numbers = drv.check(state, kept)
    if control:
        extra["control"] = drv.control(state, kept)
    del state
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = (raised == 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": int(units), "failed": int(failed),
              "metrics": metrics, "device": dev, **extra, "check": checks}
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
