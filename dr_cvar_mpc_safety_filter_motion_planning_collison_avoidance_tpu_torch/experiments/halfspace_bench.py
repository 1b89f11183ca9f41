"""Times of the halfspace kernels (all metrics, DR-CVaR alone) on one card.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.halfspace_bench \
        [--baseline OTHER.cu ...] [--probe OTHER.cu ...]

At the shapes the port's paths give the kernels -- the batch run's
23,040 x 1000 rows, the kernel benchmark's 32768 x 1000, Monte Carlo's
9,000 x 20, 8192 x 4096 (the block path) and 4,099 x 999 (an odd N: 8-byte
loads, a last block that is not full) -- it times
`ops/csrc/halfspace_kernels.cu` as `halfspace_plan` runs it and, where
the row fits a warp, under other plans: the block path forced, 1, 2 and
8 rows a block, 8-byte loads on aligned rows.  The plan's constants in
`ops/cuda_kernels.py` are set from these lines.  `--baseline` names
another version of the source (an earlier one, with its own C interface:
a source without a `values_per_lane` argument is called without a plan)
to be built and timed in the same process, on the same card, and says
for each shape whether its outputs equal this version's bit for bit;
`--probe` does the same for a source whose results are not expected to
be right.  The compiler looks for a quoted include beside the including
file first, so a baseline that needs its own commit's headers finds them
when they are saved beside it (`git show <commit>:<path>` for the source
and each `.cuh`, into one directory under `build/`).  What a phase of
the kernel costs is read from the kernel benchmark's variants
(`experiments/kbench.py`), which are the kernel with a stage swapped.

Each version is timed as a CUDA graph of REPS launches replayed under
CUDA events (device time, no host in the way); the wrappers are timed
launch by launch beside them (what a caller sees).  The versions run in
turns (a, b, ..., b, a) and each time is the mean of its two turns.  At
the first two shapes the samples (184 and 262 MB) exceed the card's
50 MB L2, so a replay does not run from cache; 9,000 x 20 (1.4 MB) and
4,099 x 999 (33 MB) fit in it, and their times are times from L2.  Every
checked output is held against the plain version first.  Needs a CUDA
device; there is no CPU measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..core.risk import cvar_k
from ..ops import _build, cuda_kernels as ck
from .kbench import cuda_ms, graph_ms, make_inputs
from .linalg_bench import in_turns, roofline_ms

SHAPES = ((23040, 1000), (32768, 1000), (9000, 20), (8192, 4096),
          (4099, 999))
ARGS = (0.2, 0.1, 0.15, 0.3, 0.3)   # alpha, delta, epsilon, radii (custom)
REPS = 50
H_TOL, G_ATOL, G_RTOL = 1e-5, 2e-4, 1e-5
# Float operations a sample (centring, projection, tail) and a sample and
# select pass; the bound counts the 4 passes a row can need.
FLOPS_PER_SAMPLE, SELECT_OPS_PER_PASS = 16, 4
SOURCE = "halfspace_kernels.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C interface of a source that has no plan arguments.
_NO_PLAN_SIGNATURES = {
    "drcvar_all_metrics_halfspaces": [_P] * 7 + [_I] * 3 + [_F] * 5 + [_P],
    "drcvar_fused_halfspace": [_P] * 4 + [_I] * 3 + [_F] * 4 + [_P],
}


def halfspace_bound_ms(B: int, N: int, out_floats: int) -> tuple[float, str]:
    """The least time the card needs for B rows of N samples: samples and
    ego read once, `out_floats` a row written once, against the float
    operations of the closed form and four select passes."""
    return roofline_ms(B * (N * 8 + 8 + out_floats * 4),
                       B * N * (FLOPS_PER_SAMPLE + 4 * SELECT_OPS_PER_PASS))


def other_plans(plan: ck.HalfspacePlan) -> dict:
    """The plans timed beside `halfspace_plan`'s own for a warp-path row."""
    if plan.entry != "warp":
        return {}
    plans = {"block": plan._replace(values_per_lane=0, rows_per_block=1),
             "rows1": plan._replace(rows_per_block=1),
             "rows2": plan._replace(rows_per_block=2),
             "rows8": plan._replace(rows_per_block=8)}
    if plan.load_bytes == 16:
        plans["load8"] = plan._replace(load_bytes=8)
    return plans


def _launcher(lib, all_metrics: bool, plan, samples, ego, outs):
    """A launch of one library's kernel 1 or 4 on (samples, ego) into
    `outs` (h_mean, g_mean, h, g_cvar, g_drcvar); `plan` None for a
    source without plan arguments."""
    B, N = samples.shape[:2]
    alpha, delta, epsilon, r_robot, r_obstacle = ARGS
    ints = (B, N, cvar_k(N, alpha)) + (() if plan is None else (
        plan.values_per_lane, plan.rows_per_block, plan.load_bytes,
        plan.cluster))
    if all_metrics:
        fn, what = lib.drcvar_all_metrics_halfspaces, "all_metrics_halfspaces"
        args = (samples.data_ptr(), ego.data_ptr(),
                *(t.data_ptr() for t in outs), *ints, 1.0 / N, alpha * N,
                r_robot + r_obstacle, delta, epsilon / alpha)
    else:
        fn, what = lib.drcvar_fused_halfspace, "fused_drcvar_halfspace"
        args = (samples.data_ptr(), ego.data_ptr(), outs[2].data_ptr(),
                outs[4].data_ptr(), *ints, 1.0 / N, alpha * N, delta,
                epsilon / alpha)

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), what)
    return launch


def _check(name, all_metrics, outs, ref) -> float:
    """Outputs against the plain version's; returns the max abs error."""
    fields = ck.MetricHalfspaces._fields
    pairs = zip(fields, outs, ref) if all_metrics else (
        ("h", outs[2], ref.h), ("g_drcvar", outs[4], ref.g_drcvar))
    worst = 0.0
    for field, a, b in pairs:
        diff = (a - b).abs()
        tol = H_TOL if field.startswith("h") else G_ATOL + G_RTOL * b.abs()
        if not bool((diff <= tol).all()):
            raise RuntimeError(f"{name}: {field} off by "
                               f"{float(diff.max()):.3e}")
        worst = max(worst, float(diff.max()))
    return worst


def _fmt(times: dict) -> str:
    return ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())


def print_ptxas(log: str) -> None:
    """Registers and spills of the halfspace kernels and their variants,
    from nvcc's log."""
    keep = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = any(part in line for part in (
                "halfspace_", "kth_largest", "variant_", "select_rounds"))
        if keep and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            print(f"[ptxas] {line.strip()}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help=f"another {SOURCE} to time beside")
    parser.add_argument("--probe", action="append", default=[],
                        help="the same, its results not checked")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("halfspace_bench measures on a CUDA device only "
                           "(torch.cuda.is_available() is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"halfspace_bench on {card}", flush=True)

    others = {Path(path).stem: path for path in args.baseline + args.probe}
    unchecked = {Path(path).stem for path in args.probe}
    builds = {"kernel": {}}
    for name, path in others.items():
        builds[name] = {"replace": (SOURCE, path)}
    with ThreadPoolExecutor(len(builds)) as pool:
        loaded = dict(zip(builds, pool.map(
            lambda kw: _build.load(**kw), builds.values())))
    has_plan = {"kernel": True}
    for name, path in others.items():
        has_plan[name] = "values_per_lane" in Path(path).read_text()
        if not has_plan[name]:
            for entry, argtypes in _NO_PLAN_SIGNATURES.items():
                getattr(loaded[name].lib, entry).argtypes = argtypes
    for name, lib in loaded.items():
        print(f"[build] {name}: nvcc {lib.build_seconds:.1f} s")
    print_ptxas(loaded["kernel"].log)

    dev = torch.device("cuda", 0)
    results = {}
    for B, N in SHAPES:
        samples, ego = make_inputs(B, N, dev, seed=N)
        plan = ck.halfspace_plan(B, N, samples.data_ptr() % 16 == 0)
        print(f"[plan] {B} x {N}: {plan}", flush=True)
        ref = ck.all_metrics_halfspaces_plain(samples, ego, *ARGS)
        versions = {"kernel": ("kernel", plan)}
        versions.update({name: ("kernel", p)
                         for name, p in other_plans(plan).items()})
        versions.update({name: (name, plan if has_plan[name] else None)
                         for name in others})
        for all_metrics, what, out_floats in (
                (True, "all_metrics_halfspaces", 7),
                (False, "fused_drcvar_halfspace", 3)):
            outs = {name: [torch.zeros((B, 2), device=dev),
                           torch.zeros((B,), device=dev),
                           torch.zeros((B, 2), device=dev),
                           torch.zeros((B,), device=dev),
                           torch.zeros((B,), device=dev)]
                    for name in versions}
            launches = {
                name: _launcher(loaded[lib].lib, all_metrics, p, samples,
                                ego, outs[name])
                for name, (lib, p) in versions.items()}
            for name, launch in launches.items():
                launch()
                torch.cuda.synchronize()
                if name not in unchecked:
                    _check(f"{what} {name} {B} x {N}", all_metrics,
                           outs[name], ref)
            for name in others:
                if name not in unchecked:
                    same = all(torch.equal(a, b) for a, b in zip(
                        outs[name], outs["kernel"]))
                    print(f"[equal] {what} {B} x {N}: {name} bit-equal to "
                          f"kernel: {same}", flush=True)
            device = in_turns(graph_ms, launches)
            wrapper = (ck.all_metrics_halfspaces if all_metrics
                       else ck.fused_drcvar_halfspace)
            host = in_turns(lambda f: cuda_ms(f, REPS), {
                "kernel": launches["kernel"],
                "wrapper": lambda: wrapper(samples, ego, *ARGS)})
            bound, by = halfspace_bound_ms(B, N, out_floats)
            results[what, B, N] = (device, host)
            print(f"[{what}] {B} x {N}: bound {bound:.4f} ms ({by}), "
                  f"{bound / device['kernel']:.1%} of it reached; graph ms: "
                  f"{_fmt(device)}; launch by launch ms: {_fmt(host)}",
                  flush=True)
        del samples, ego, ref, outs, launches
    return results


if __name__ == "__main__":
    main()
