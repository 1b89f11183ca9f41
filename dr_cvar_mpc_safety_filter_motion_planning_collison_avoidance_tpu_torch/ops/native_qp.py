"""ctypes binding to the C++ host QP solver (native/qp_solver.cpp).

Port of the JAX package's ops/native_qp.py, with its API:
`NativeQPSolution`, `build_library`, `available`, `solve_qp_native`.
The solver is an independent dense primal-dual IPM in double precision
on the host: a cross-check of the batched solvers that needs no CVXPY.
It is not a kernel and runs no part of the pipeline.

The library is built on first use with g++ and the flags of
`native/Makefile` into `build/torch_native/<hash of the source, compiler
and flags>/libqp_oracle.so` beside the package (git-ignored), never into
`native/`.  Each build writes a file of its own and moves it into place
with `os.replace`, so processes that build at the same time all end with
a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "qp_solver.cpp"
BUILD_ROOT = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIB_NAME = "libqp_oracle.so"

_libs: dict = {}


class NativeQPSolution(NamedTuple):
    z: np.ndarray
    lam: np.ndarray
    gap: float
    prim_res: float
    dual_res: float
    iterations: int
    converged: bool


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path(build_root=None) -> Path:
    """Where the build of this source, compiler and flags goes."""
    digest = hashlib.sha256(" ".join((_compiler(),) + CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    root = BUILD_ROOT if build_root is None else Path(build_root)
    return root / digest.hexdigest()[:16] / LIB_NAME


def build_library(force: bool = False, build_root=None) -> str:
    """Compile the shared library unless this build exists; returns its
    path.  A failed compile raises with the compiler's output."""
    path = library_path(build_root)
    if path.exists() and not force:
        return str(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{LIB_NAME}.", suffix=".tmp",
                               dir=path.parent)
    os.close(fd)
    try:
        out = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp,
                              str(SOURCE)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{_compiler()} failed with code "
                               f"{out.returncode}:\n{out.stderr[-4000:]}")
        os.replace(tmp, path)   # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(path)


def _load(build_root=None):
    key = None if build_root is None else str(build_root)
    if key not in _libs:
        lib = ctypes.CDLL(build_library(build_root=build_root))
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.qp_solve.restype = ctypes.c_int
        lib.qp_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, dptr, dptr, dptr, dptr,
            ctypes.c_int, ctypes.c_double, dptr, dptr, dptr,
        ]
        _libs[key] = lib
    return _libs[key]


def available() -> bool:
    """True if the library can be built and loaded on this host."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _host_array(x) -> np.ndarray:
    """A contiguous float64 numpy array of an array or a CPU tensor; a
    tensor on another device raises (the caller moves it)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"solve_qp_native runs on the host: expected "
                             f"a CPU tensor, got one on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype=np.float64)


def solve_qp_native(P, q, G, h, max_iters: int = 60, tol: float = 1e-9,
                    build_root=None) -> NativeQPSolution:
    """Solve min 0.5 z'Pz + q'z s.t. Gz <= h with the C++ solver.

    P [n, n], q [n], G [m, n], h [m]: numpy arrays or CPU tensors.
    `build_root` (optional) builds and loads the library under another
    directory than `build/torch_native/`."""
    lib = _load(build_root)
    P, q, G, h = map(_host_array, (P, q, G, h))
    n, m = q.shape[0], h.shape[0]
    if P.shape != (n, n) or G.shape != (m, n):
        raise ValueError(f"expected P [{n}, {n}] and G [{m}, {n}], got "
                         f"{P.shape} and {G.shape}")
    z = np.zeros(n)
    lam = np.zeros(m)
    info = np.zeros(4)
    status = lib.qp_solve(n, m, P, q, G, h, max_iters, tol, z, lam, info)
    return NativeQPSolution(
        z=z, lam=lam, gap=float(info[0]), prim_res=float(info[1]),
        dual_res=float(info[2]), iterations=int(info[3]),
        converged=status == 0)
