"""Batched small dense Cholesky factorisation and solve: CUDA kernels + plain forms.

Port of the JAX package's ops/pallas_linalg.py (`batched_cholesky`,
`batched_cho_solve`).  The kernel source is `csrc/linalg_kernels.cu`;
its header says what bounds the kernels on an H100 and how they are
designed.  The JAX package's `custom_vmap` wrappers have no counterpart:
callers pass flat `[B, n, n]` batches.

Each wrapper dispatches on its input's device: on the CPU it runs the
plain PyTorch form (`torch.linalg.cholesky_ex` / `torch.cholesky_solve`,
any float dtype); on a CUDA tensor it launches its kernel (float32, n <=
64) or raises.  No fallback on the card.
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
    """Solve L L' x = r; r is [B, n] or [B, n, k]."""
    if r.dim() == L.dim() - 1:
        return torch.cholesky_solve(r[..., None], L)[..., 0]
    return torch.cholesky_solve(r, L)


def _check(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got "
                         f"device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_factor(name: str, M: torch.Tensor) -> tuple[int, int]:
    _check(name, M)
    if M.dim() != 3 or M.shape[1] != M.shape[2] or M.shape[1] > N_MAX:
        raise ValueError(f"{name}: expected [B, n, n] with n <= {N_MAX}, "
                         f"got {tuple(M.shape)}")
    return M.shape[0], M.shape[1]


def batched_cholesky(S):
    """Lower-Cholesky factors of a batch of SPD matrices S [B, n, n]."""
    if S.device.type == "cpu":
        return batched_cholesky_plain(S)
    B, n = _check_factor("S", S)
    L = torch.empty_like(S)
    if B == 0 or n == 0:
        return L
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_batched_cholesky(
            S.data_ptr(), L.data_ptr(), B, n, stream)
    _build.check(err, "batched_cholesky")
    batched_cholesky.launches += 1
    return L


batched_cholesky.launches = 0


def batched_cho_solve(L, r):
    """Solve L L' x = r for lower factors L [B, n, n]; r [B, n] or
    [B, n, k].  Returns x with r's shape."""
    if L.device.type == "cpu":
        return batched_cho_solve_plain(L, r)
    _check("r", r)
    B, n = _check_factor("L", L)
    if r.device != L.device:
        raise ValueError("L and r must be on the same device")
    if r.dim() == 2:
        k = 1
    elif r.dim() == 3:
        k = r.shape[2]
    else:
        raise ValueError(f"r: expected [B, n] or [B, n, k], got "
                         f"{tuple(r.shape)}")
    if tuple(r.shape[:2]) != (B, n) or not 1 <= k <= MAX_RHS:
        raise ValueError(f"r: expected [{B}, {n}] or [{B}, {n}, k] with "
                         f"1 <= k <= {MAX_RHS}, got {tuple(r.shape)}")
    x = torch.empty_like(r)
    if B == 0 or n == 0:
        return x
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load().lib.drcvar_batched_cho_solve(
            L.data_ptr(), r.data_ptr(), x.data_ptr(), B, n, k, stream)
    _build.check(err, "batched_cho_solve")
    batched_cho_solve.launches += 1
    return x


batched_cho_solve.launches = 0
