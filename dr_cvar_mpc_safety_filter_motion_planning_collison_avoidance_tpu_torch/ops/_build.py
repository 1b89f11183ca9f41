"""Builds the CUDA kernels of `csrc/` on first use and binds them.

nvcc compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, loaded with ctypes.  The library goes to
`build/torch_kernels/<hash of the sources, headers and flags>/` beside the
package (git-ignored), so a checkout builds from its own sources and a
changed source never loads a stale library.  Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdrcvar_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every pointer and the stream are c_void_p: without argtypes ctypes
# would pass a Python int as a 32-bit int and cut the pointer.
_SIGNATURES = {
    "drcvar_all_metrics_halfspaces": [_P] * 7 + [_I] * 6 + [_F] * 5 + [_P],
    "drcvar_fused_halfspace": [_P] * 4 + [_I] * 6 + [_F] * 4 + [_P],
    "drcvar_variant": [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P],
    "drcvar_select_rounds": [_P] * 3 + [_I] * 6 + [_F, _P],
    "drcvar_kth_largest": [_P, _P] + [_I] * 5 + [_P],
    "drcvar_batched_cholesky": [_P, _P, _I, _I, _P],
    "drcvar_batched_cho_solve": [_P, _P, _P, _I, _I, _I, _P],
    "drcvar_cho_solve_warp_max_k": [],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
    log: str               # nvcc's output (ptxas register / smem report)


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from ops/csrc on first use")
    return found


@functools.cache
def load(extra_flags: tuple = (), replace: tuple = ()) -> KernelLibrary:
    """Build (if needed) and load the kernel library.

    The port calls it without arguments.  A benchmark that compares two
    builds passes `extra_flags` (more nvcc flags, e.g. a `-D`) or
    `replace=(name, path)`, which compiles the file at `path` in place
    of `csrc/<name>`; each combination is a library of its own.
    """
    flags = NVCC_FLAGS + tuple(extra_flags)
    swap = {replace[0]: Path(replace[1])} if replace else {}
    sources = [swap.get(p.name, p) for p in sorted(CSRC.glob("*.cu"))]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(swap.get(path.name, path).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log_path.write_text(_compile_and_link(sources, flags, out_dir,
                                              so_path))
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None and replace:
            continue    # a replaced source may lack a newer entry point
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.drcvar_error_string.argtypes = [ctypes.c_int]
    lib.drcvar_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, so_path, seconds, log)


def _compile_and_link(sources, flags, out_dir: Path, so_path: Path) -> str:
    """One nvcc per source, all at once, then one link; returns the log."""
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *flags, "-I", str(CSRC), "-c", "-o",
                               str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log = ""
    failed = []
    for src, proc in zip(sources, procs):
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(f"{src.name} (code {proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           f"{log[-6000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True,
                          check=False)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed with code {link.returncode}:"
                           f"\n{link.stderr[-6000:]}")
    os.replace(tmp, so_path)   # atomic: a reader never sees half a file
    for obj in objs:
        obj.unlink()
    return log


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = load().lib.drcvar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(entry: str, device, *args) -> None:
    """Call a C entry point on PyTorch's current stream of `device` and
    raise on its CUDA error.  The device is switched only when it is not
    the current one: the context manager costs more host time than the
    kernels take on the card."""
    fn = getattr(load().lib, entry)
    if device.index in (None, torch.cuda.current_device()):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, entry)
