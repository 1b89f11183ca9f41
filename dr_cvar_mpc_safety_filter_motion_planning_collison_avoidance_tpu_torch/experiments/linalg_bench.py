"""Times of the batched Cholesky and Cholesky-solve kernels on one card.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.linalg_bench \
        [--baseline OTHER.cu ...] [--probe OTHER.cu ...]

At the MPC's batch, [768, n, n] with n = 60 and 64 (and 62, which takes
the kernels' run-time-n instantiation), it builds
`ops/csrc/linalg_kernels.cu` three times: as it is, with every solve
sent to the warp-a-matrix kernel (`-DDRCVAR_SOLVE_WARP_MAX_K=256`) and
with every solve sent to the thread-a-right-hand-side kernel (`=0`).
The two forced builds, timed at k = 1, 2, 3, 4, 8, 16, 32 and 65, are what
the threshold in the source is set from.  `--baseline` names another
source with the same C interface (an earlier version of the file) to be
built and timed in the same process, on the same card; `--probe` does
the same for a source whose results are not expected to be right (a
kernel with a phase cut out, to see what the phase costs).

Each kernel is timed two ways: as a CUDA graph of REPS launches replayed
under CUDA events (device time, no host in the way), and through the
Python wrapper's path launch by launch (what a caller sees; the host's
enqueue time can exceed the kernel's).  The versions run in turns
(a, b, ..., b, a) and each time is the mean of its two turns.  One
PyTorch call for the same function (`torch.linalg.cholesky_ex`,
`torch.cholesky_solve`) is timed beside them; the port never calls it
on the card.  Every output is held against the plain version first.
Needs a CUDA device; there is no CPU measurement.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build, cuda_linalg as cl
from .kbench import cuda_ms, graph_ms

BATCH = 768
SIZES = (60, 64, 62)
RHS = (1, 2, 3, 4, 8, 16, 32, 65)
REPS = 50
RTOL = 1e-5
PEAK_BYTES_PER_S, PEAK_FLOPS = 3.35e12, 67e12   # H100 SXM, float32


def cholesky_bound_ms(B: int, n: int) -> tuple[float, str]:
    """The least time the card needs: read S once, write L once, against
    n^3 / 3 floating-point operations a matrix."""
    return roofline_ms(2 * B * n * n * 4, B * n ** 3 / 3)


def cho_solve_bound_ms(B: int, n: int, k: int) -> tuple[float, str]:
    """Read L and r once, write x once, against 2 n^2 k operations."""
    return roofline_ms(B * (n * n + 2 * n * k) * 4, B * 2 * n * n * k)


def roofline_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    float32 rate, in ms, and which of the two it is."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_flops = flops / PEAK_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_flops
            else (by_flops, "operations"))


def in_turns(timer, launches: dict) -> dict:
    """Time every launch forwards and then backwards; mean of the two."""
    names = list(launches)
    first = {name: timer(launches[name]) for name in names}
    second = {name: timer(launches[name]) for name in reversed(names)}
    return {name: (first[name] + second[name]) / 2 for name in names}


def _chol(lib, S, L):
    def launch():
        err = lib.drcvar_batched_cholesky(
            S.data_ptr(), L.data_ptr(), S.shape[0], S.shape[1],
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "batched_cholesky")
    return launch


def _solve(lib, L, r, x):
    k = 1 if r.dim() == 2 else r.shape[2]

    def launch():
        err = lib.drcvar_batched_cho_solve(
            L.data_ptr(), r.data_ptr(), x.data_ptr(), L.shape[0], L.shape[1],
            k, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "batched_cho_solve")
    return launch


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _fmt(times: dict) -> str:
    return ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help="another linalg_kernels.cu to time beside")
    parser.add_argument("--probe", action="append", default=[],
                        help="the same, its results not checked")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("linalg_bench measures on a CUDA device only "
                           "(torch.cuda.is_available() is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"linalg_bench: [{BATCH}, n, n] on {card}", flush=True)

    builds = {"kernel": {},
              "warp": {"extra_flags": ("-DDRCVAR_SOLVE_WARP_MAX_K=256",)},
              "col": {"extra_flags": ("-DDRCVAR_SOLVE_WARP_MAX_K=0",)}}
    others = {Path(path).stem: path for path in args.baseline + args.probe}
    unchecked = {Path(path).stem for path in args.probe}
    for name, path in others.items():
        builds[name] = {"replace": ("linalg_kernels.cu", path)}
    with ThreadPoolExecutor(len(builds)) as pool:
        loaded = dict(zip(builds, pool.map(
            lambda kw: _build.load(**kw), builds.values())))
    libs = {name: lib.lib for name, lib in loaded.items()}
    for name, lib in loaded.items():
        print(f"[build] {name}: nvcc {lib.build_seconds:.1f} s")
    keep = False
    for line in loaded["kernel"].log.splitlines():
        if "Compiling entry" in line:
            keep = "chol" in line or "cho_solve" in line
        if keep and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            print(f"[ptxas] {line.strip()}")
    print(f"[threshold] the source sends k <= "
          f"{libs['kernel'].drcvar_cho_solve_warp_max_k()} to the warp kernel")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    chol_libs = {name: lib for name, lib in libs.items()
                 if name == "kernel" or name in others}
    for n in SIZES:
        A = torch.randn(BATCH, n, n, generator=gen, device=dev)
        S = A @ A.mT + 3.0 * torch.eye(n, device=dev)
        L_ref = cl.batched_cholesky_plain(S)
        outs = {name: torch.empty_like(S) for name in chol_libs}
        launches = {name: _chol(lib, S, outs[name])
                    for name, lib in chol_libs.items()}
        for name, launch in launches.items():
            launch()
            torch.cuda.synchronize()
            rel = _rel(outs[name], L_ref)
            if not rel < RTOL and name not in unchecked:
                raise RuntimeError(f"cholesky {name} n={n}: rel err {rel:.3e}")
        device = in_turns(graph_ms, launches)
        launches["library"] = lambda: torch.linalg.cholesky_ex(S)
        launches["wrapper"] = lambda: cl.batched_cholesky(S)
        host = in_turns(lambda f: cuda_ms(f, REPS), launches)
        bound, by = cholesky_bound_ms(BATCH, n)
        results["cholesky", n] = (device, host)
        print(f"[cholesky] n={n}: bound {bound:.4f} ms ({by}); graph ms: "
              f"{_fmt(device)}; launch by launch ms: {_fmt(host)}", flush=True)
        L = outs["kernel"]
        for k in RHS:
            shape = (BATCH, n) if k == 1 else (BATCH, n, k)
            r = torch.randn(shape, generator=gen, device=dev)
            x_ref = cl.batched_cho_solve_plain(L, r)
            outs_x = {name: torch.empty_like(r) for name in libs}
            launches = {name: _solve(lib, L, r, outs_x[name])
                        for name, lib in libs.items()}
            for name, launch in launches.items():
                launch()
                torch.cuda.synchronize()
                rel = _rel(outs_x[name], x_ref)
                if not rel < RTOL and name not in unchecked:
                    raise RuntimeError(
                        f"solve {name} n={n} k={k}: rel err {rel:.3e}")
            device = in_turns(graph_ms, launches)
            r3 = r if r.dim() == 3 else r[..., None]
            launches["library"] = lambda: torch.cholesky_solve(r3, L)
            launches["wrapper"] = lambda: cl.batched_cho_solve(L, r)
            host = in_turns(lambda f: cuda_ms(f, REPS), launches)
            bound, by = cho_solve_bound_ms(BATCH, n, k)
            results["cho_solve", n, k] = (device, host)
            print(f"[cho_solve] n={n} k={k}: bound {bound:.4f} ms ({by}); "
                  f"graph ms: {_fmt(device)}; launch by launch ms: "
                  f"{_fmt(host)}", flush=True)
    return results


if __name__ == "__main__":
    main()
