"""Batched small dense Cholesky factorisation and solve: CUDA kernels + plain forms.

Port of the JAX package's ops/pallas_linalg.py (`batched_cholesky`,
`batched_cho_solve`).  The kernel source is `csrc/linalg_kernels.cu`;
its header says what bounds the kernels on an H100 and how they are
designed.  The JAX package's `custom_vmap` wrappers have no counterpart:
callers pass flat `[B, n, n]` batches.

Each wrapper dispatches on its input's device: on the CPU it runs the
plain PyTorch form (`torch.linalg.cholesky_ex` / `torch.cholesky_solve`,
any float dtype; the plain solve on a CUDA tensor is two triangular
solves); on a CUDA tensor it launches its kernel (float32, n <= 64) or
raises.  No fallback on the card.  What the kernels take is
decided by `check_factor` and `check_solve`, pure functions of device
type, dtype, shape and strides.

A matrix that is not positive definite (a pivot that is not positive)
factors to NaN in every entry, in the kernel as in the plain version;
the other matrices of the batch are not affected.  The kernels for
n = 60 and n = 64 (the MPC's sizes) keep rows in registers; the solve
picks one of two kernels from the number of right-hand sides (the
threshold is `solve_warp_max_k()`, a constant of the source).
"""

from __future__ import annotations

import torch

from . import _build

N_MAX = 64       # matrix size the kernels take (the MPC uses 60 and 64)
MAX_RHS = 256    # right-hand sides per solve (the polish uses 65)


def batched_cholesky_plain(S):
    """Lower Cholesky factors; NaN where a matrix is not positive
    definite (the JAX factorisation's convention, which the IPM's
    breakdown test relies on)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def batched_cho_solve_plain(L, r):
    """Solve L L' x = r; r is [B, n] or [B, n, k].  On a CUDA tensor as
    two triangular solves (cuBLAS): `torch.cholesky_solve`'s batched CUDA
    path (MAGMA) allocates device memory at every call, which a CUDA
    graph cannot capture."""
    vec = r.dim() == L.dim() - 1
    rr = r[..., None] if vec else r
    if L.is_cuda:
        x = torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, rr, upper=False),
            upper=True)
    else:
        x = torch.cholesky_solve(rr, L)
    return x[..., 0] if vec else x


def is_contiguous(shape, strides) -> bool:
    """Row-major contiguity from a shape and its strides (in elements)."""
    if 0 in shape:
        return True
    expected = 1
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _check_tensor(name, device_type, dtype, shape, strides) -> None:
    if dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {dtype}")
    if device_type != "cuda":
        raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got "
                         f"device type {device_type}")
    if not is_contiguous(shape, strides):
        raise ValueError(f"{name}: expected a contiguous tensor, got shape "
                         f"{tuple(shape)} with strides {tuple(strides)}")


def check_factor(name, device_type, dtype, shape, strides) -> tuple[int, int]:
    """(B, n) of a [B, n, n] batch the kernels take, or raise."""
    _check_tensor(name, device_type, dtype, shape, strides)
    if len(shape) != 3 or shape[1] != shape[2] or shape[1] > N_MAX:
        raise ValueError(f"{name}: expected [B, n, n] with n <= {N_MAX}, "
                         f"got {tuple(shape)}")
    return shape[0], shape[1]


def check_solve(L_desc, r_desc) -> tuple[int, int, int]:
    """(B, n, k) of factors [B, n, n] and a right-hand side [B, n]
    (k = 1) or [B, n, k] the solve kernels take, or raise.  Each argument
    is (device type, dtype, shape, strides)."""
    _check_tensor("r", *r_desc)
    B, n = check_factor("L", *L_desc)
    shape = r_desc[2]
    if len(shape) not in (2, 3):
        raise ValueError(f"r: expected [B, n] or [B, n, k], got "
                         f"{tuple(shape)}")
    k = 1 if len(shape) == 2 else shape[2]
    if tuple(shape[:2]) != (B, n) or not 1 <= k <= MAX_RHS:
        raise ValueError(f"r: expected [{B}, {n}] or [{B}, {n}, k] with "
                         f"1 <= k <= {MAX_RHS}, got {tuple(shape)}")
    return B, n, k


def _describe(t: torch.Tensor):
    return t.device.type, t.dtype, tuple(t.shape), t.stride()


def solve_warp_max_k() -> int:
    """The most right-hand sides the warp-a-matrix solve kernel takes;
    above it a thread owns a right-hand side (builds the kernels)."""
    return _build.load().lib.drcvar_cho_solve_warp_max_k()


def batched_cholesky(S):
    """Lower-Cholesky factors of a batch of SPD matrices S [B, n, n];
    all NaN for a matrix that is not positive definite."""
    if S.device.type == "cpu":
        return batched_cholesky_plain(S)
    B, n = check_factor("S", *_describe(S))
    L = torch.empty_like(S)
    if B == 0 or n == 0:
        return L
    _build.launch("drcvar_batched_cholesky", S.device, S.data_ptr(),
                  L.data_ptr(), B, n)
    batched_cholesky.launches += 1
    return L


batched_cholesky.launches = 0


def batched_cho_solve(L, r):
    """Solve L L' x = r for lower factors L [B, n, n]; r [B, n] or
    [B, n, k].  Returns x with r's shape."""
    if L.device.type == "cpu":
        return batched_cho_solve_plain(L, r)
    B, n, k = check_solve(_describe(L), _describe(r))
    if r.device != L.device:
        raise ValueError("L and r must be on the same device")
    x = torch.empty_like(r)
    if B == 0 or n == 0:
        return x
    _build.launch("drcvar_batched_cho_solve", L.device, L.data_ptr(),
                  r.data_ptr(), x.data_ptr(), B, n, k)
    batched_cho_solve.launches += 1
    return x


batched_cho_solve.launches = 0
