"""Builds the CUDA kernels of `csrc/` on first use and binds them.

nvcc compiles every `csrc/*.cu` for sm_90a into one shared library with
a plain C interface, loaded with ctypes.  The library goes to
`build/torch_kernels/<hash of the sources and flags>/` beside the
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdrcvar_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every pointer and the stream are c_void_p: without argtypes ctypes
# would pass a Python int as a 32-bit int and cut the pointer.
_SIGNATURES = {
    "drcvar_all_metrics_halfspaces": [_P] * 7 + [_I] * 3 + [_F] * 5 + [_P],
    "drcvar_kth_largest": [_P, _P, _I, _I, _I, _P],
    "drcvar_batched_cholesky": [_P, _P, _I, _I, _P],
    "drcvar_batched_cho_solve": [_P, _P, _P, _I, _I, _I, _P],
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
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        seconds = time.perf_counter() - t0
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stderr[-6000:]}")
        os.replace(tmp, so_path)   # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.drcvar_error_string.argtypes = [ctypes.c_int]
    lib.drcvar_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, so_path, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = load().lib.drcvar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
