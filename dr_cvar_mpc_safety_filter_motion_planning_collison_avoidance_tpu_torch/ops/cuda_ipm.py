"""The structured IPM's pass on hand-written CUDA kernels.

`qp_ipm_structured._fused_pass` runs a pass of the loop as six launches:
`ipm_residuals` (kernel A: merit, bookkeeping, scalings, the Schur
matrix S and the predictor's right-hand side), kernel 2 on S, kernel 3,
`ipm_predictor` (kernel B: the predictor's step and the corrector's
right-hand side), kernel 3 again and `ipm_step` (kernel C: the
corrector's step and the update).  The source is
`csrc/ipm_pass_kernels.cu`; its header says what bounds the kernels on
an H100 and how they are designed.

The plain version is the pass op by op, `qp_ipm_structured._one_pass`,
which the CPU runs and the tests hold these kernels to.  The wrappers
take CUDA tensors only and raise on anything else (no fallback); which
solves take them is `qp_ipm_structured.use_fused_pass`'s choice.

The kernels read the call's data and update the loop's state in place
through one table of 30 pointers (`TABLE`), checked by `check_pass`, a
pure function of each tensor's device type, dtype, shape and strides.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .cuda_linalg import N_MAX, is_contiguous

HP_MAX = 64     # rows of box_theta a lane the kernels take
M2_MAX = 256    # soft rows a lane the kernels' shared memory takes

_VECS = ("u", "s", "w1", "w2", "w3", "l1", "l2", "l3")
TABLE = ("P_uu", "T", "q_u", "h1", "A", "b", "p_ss", "q_s", "q_scale",
         *_VECS, *(f"best_{v}" for v in _VECS), "best_merit", "done",
         "stall", "iters", "active")


class Lanes(NamedTuple):
    """A pass's pointer table and the sizes the kernels need."""
    table: ctypes.Array
    device: torch.device
    B: int
    n: int
    hp: int
    m2: int


def _expected(B: int, n: int, hp: int, m2: int) -> list:
    """(shape, dtype) of each entry of TABLE."""
    m1 = 2 * n + 2 * hp
    f32 = torch.float32
    lens = {"u": n, "s": m2, "w1": m1, "w2": m2, "w3": m2, "l1": m1,
            "l2": m2, "l3": m2}
    vecs = [((B, lens[v]), f32) for v in _VECS]
    return ([((n, n), f32), ((hp, n), f32), ((B, n), f32), ((B, m1), f32),
             ((B, m2, n), f32), ((B, m2), f32), ((B, m2), f32),
             ((B, m2), f32), ((B,), f32)] + vecs + vecs
            + [((B,), f32), ((B,), torch.bool), ((B,), torch.int32),
               ((B,), torch.int32), ((B,), torch.bool)])


def check_pass(descs) -> tuple[int, int, int, int]:
    """(B, n, hp, m2) of the tensors of TABLE, each described as (device
    type, dtype, shape, strides), that the kernels take, or raise."""
    if len(descs) != len(TABLE):
        raise ValueError(f"expected {len(TABLE)} tensors, got {len(descs)}")
    shapes = dict(zip(TABLE, (tuple(d[2]) for d in descs)))
    if len(shapes["q_u"]) != 2 or len(shapes["T"]) != 2 or \
            len(shapes["b"]) != 2:
        raise ValueError("expected q_u [B, n], T [hp, n] and b [B, m2]")
    (B, n), hp, m2 = shapes["q_u"], shapes["T"][0], shapes["b"][1]
    if not (1 <= n <= N_MAX and 0 <= hp <= HP_MAX and 1 <= m2 <= M2_MAX):
        raise ValueError(f"the pass kernels take n <= {N_MAX}, hp <= "
                         f"{HP_MAX} and 1 <= m2 <= {M2_MAX}; got n={n}, "
                         f"hp={hp}, m2={m2}")
    for name, (dev, dtype, shape, strides), (want, want_dtype) in zip(
            TABLE, descs, _expected(B, n, hp, m2)):
        if dev != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got device "
                             f"type {dev}")
        if tuple(shape) != want or dtype != want_dtype:
            raise ValueError(f"{name}: expected {want_dtype} of shape {want},"
                             f" got {dtype} of shape {tuple(shape)}")
        if not is_contiguous(shape, strides):
            raise ValueError(f"{name}: expected a contiguous tensor, got "
                             f"strides {tuple(strides)}")
    return B, n, hp, m2


def lanes(tensors) -> Lanes:
    """The checked pointer table of TABLE's tensors (in its order)."""
    tensors = tuple(tensors)
    B, n, hp, m2 = check_pass([(t.device.type, t.dtype, tuple(t.shape),
                                t.stride()) for t in tensors])
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("the pass's tensors must be on one device")
    table = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    return Lanes(table, device, B, n, hp, m2)


def work_floats(n: int, hp: int, m2: int) -> int:
    """Floats of a lane's work row (builds the kernels)."""
    return _build.load().lib.drcvar_ipm_work_floats(n, hp, m2)


def ipm_residuals(lanes_: Lanes, reg: float, tol: float, max_iters: int):
    """Kernel A: the merit and the bookkeeping of every active lane
    (best iterate, best merit, done, stall, iterations and active updated
    in place), and for the lanes that step its Schur matrix, predictor
    right-hand side and work row.  Returns (S [B, n, n], rhs [B, n],
    work [B, work_floats])."""
    B, n = lanes_.B, lanes_.n
    f32 = dict(dtype=torch.float32, device=lanes_.device)
    S = torch.empty(B, n, n, **f32)
    rhs = torch.empty(B, n, **f32)
    work = torch.empty(B, work_floats(n, lanes_.hp, lanes_.m2), **f32)
    _build.launch("drcvar_ipm_residuals", lanes_.device,
                  ctypes.addressof(lanes_.table), S.data_ptr(),
                  rhs.data_ptr(), work.data_ptr(), B, n, lanes_.hp,
                  lanes_.m2, _m_total(lanes_), reg, tol, max_iters)
    ipm_residuals.launches += 1
    return S, rhs, work


ipm_residuals.launches = 0


def _check(name: str, t, lanes_: Lanes, width: int) -> None:
    shape = (lanes_.B, width)
    if (t.device != lanes_.device or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 tensor "
                         f"of shape {shape} on {lanes_.device}")


def _check_step(lanes_: Lanes, work, *vectors) -> None:
    _check("work", work, lanes_, work_floats(lanes_.n, lanes_.hp, lanes_.m2))
    for t in vectors:
        _check("du / rhs", t, lanes_, lanes_.n)


def ipm_predictor(lanes_: Lanes, work, du, rhs) -> None:
    """Kernel B: from the predictor's solution `du`, its step, mu_aff and
    the centring; writes the corrector's right-hand side into `rhs` and
    its targets into `work`."""
    _check_step(lanes_, work, du, rhs)
    _build.launch("drcvar_ipm_predictor", lanes_.device,
                  ctypes.addressof(lanes_.table), work.data_ptr(),
                  du.data_ptr(), rhs.data_ptr(), lanes_.B, lanes_.n,
                  lanes_.hp, lanes_.m2, _m_total(lanes_))
    ipm_predictor.launches += 1


ipm_predictor.launches = 0


def ipm_step(lanes_: Lanes, work, du) -> None:
    """Kernel C: from the corrector's solution `du`, the step at 0.99 and
    the update of every stepping lane's iterate in place."""
    _check_step(lanes_, work, du)
    _build.launch("drcvar_ipm_step", lanes_.device,
                  ctypes.addressof(lanes_.table), work.data_ptr(),
                  du.data_ptr(), lanes_.B, lanes_.n, lanes_.hp, lanes_.m2)
    ipm_step.launches += 1


ipm_step.launches = 0


def _m_total(lanes_: Lanes) -> int:
    """Rows of the QP: m1 = 2n + 2hp box rows and 2 m2 soft ones."""
    return 2 * lanes_.n + 2 * lanes_.hp + 2 * lanes_.m2
