"""The yardstick of the rooflines: the card's published peaks and the
operations and bytes each measured stage needs, from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit
(dense, no sparsity): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32
outside the tensor cores. A card set below 700 W runs slower; `card_line`
reads its name and power limit, printed beside every run's numbers.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4
POLISH_REFINEMENTS = 2     # the IPM's polish refines its KKT solve twice
HALFSPACE_OUT_FLOATS = 7   # h_mean, g_mean, h, g_cvar, g_drcvar
HALFSPACE_OPS_PER_SAMPLE = 8   # centre (2), mean (2), project (3), compare


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of its two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def factor_work(n: int):
    """Cholesky of an n x n matrix: n^3 / 3 operations; reads the matrix
    and writes its factor."""
    return n ** 3 / 3.0, 2 * n * n * F32


def solve_work(n: int, k: int):
    """Two triangular solves with k right-hand sides: 2 n^2 k operations;
    reads the factor and the right-hand sides, writes the solutions."""
    return 2.0 * n * n * k, (n * n + 2 * n * k) * F32


def qp_work(lanes: int, n: int, rows: int, passes: int):
    """(operations, bytes) of the Schur systems of one call of the
    structured IPM on `lanes` QPs of n unknowns and `rows` constraint
    rows of u (boxes and soft rows) that made `passes` passes: a factor
    and two single solves a pass, and the polish's factors of K (n) and
    M (k = min(n + 4, rows)), K solved for k + 1 right-hand sides, M once,
    and a solve of each in every refinement."""
    k = min(n + 4, rows)
    parts = ([factor_work(n)] + [solve_work(n, 1)] * 2) * passes
    parts += [factor_work(n), solve_work(n, k + 1), factor_work(k),
              solve_work(k, 1)]
    parts += [solve_work(n, 1), solve_work(k, 1)] * POLISH_REFINEMENTS
    flops = sum(p[0] for p in parts) * lanes
    nbytes = sum(p[1] for p in parts) * lanes
    return flops, nbytes


def halfspace_work(rows: int, n_samples: int, ego_floats: int):
    """(operations, bytes) of the halfspace stage on `rows` rows of
    `n_samples` 2-D float32 samples: every sample read once, the ego
    reference (`ego_floats` float32) read once, seven float32 a row
    written once."""
    nbytes = (rows * n_samples * 2 + ego_floats + rows * HALFSPACE_OUT_FLOATS) * F32
    return float(rows * n_samples * HALFSPACE_OPS_PER_SAMPLE), nbytes


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), with the peaks."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi not available ({type(exc).__name__})"
    return (f"card: {out}; peaks {PEAK_BYTES_S / 1e12:.2f} TB/s, "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s float32 (H100 SXM, 700 W)")
