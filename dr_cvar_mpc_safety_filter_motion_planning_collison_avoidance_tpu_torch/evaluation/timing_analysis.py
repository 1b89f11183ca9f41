"""Timing benchmark for the CVaR / DR-CVaR halfspace solvers.

Port of the JAX package's evaluation/timing_analysis.py: the paper's
DR-CVaR computation-time study.  Each (sample size, run) cell is an
instance of a BATCHED solve: all `n_runs` instances of a size go through
one call of the closed forms `dr_cvar_g_star` / `cvar_g_star` (plain
torch ops, as the JAX package leaves them to XLA: no kernel).

Same semantics as the JAX sweep: "setup" is a fresh host -> device copy
of the batch, made complete by reading one element back, divided by
`n_runs`; "solve" is the batched solve including the readback of its
result, divided by `n_runs`; the first call of each solver and size is
excluded.  Same artifacts when `save_dir` is given:
`timing_comparison.csv` (same columns), `timing_data.npz`,
`timing_data.txt` and `dr_cvar_computation_time{,_with_outliers}.png`.
With `save_dir=None` nothing is written and nothing is imported for
plots (matplotlib is imported by `plot_timing_results` alone), and the
table is printed without pandas.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, Parameters
from ..models.pipeline import pin_matmul_precision
from ..ops.halfspace import cvar_g_star, dr_cvar_g_star

TIMING_KEYS = ("setup_times", "solve_times", "call_times",
               "cvar_setup_times", "cvar_solve_times", "cvar_call_times")
TABLE_COLUMNS = ("Samples", "DR-CVaR Setup", "DR-CVaR Solve",
                 "DR-CVaR Call", "CVaR Setup", "CVaR Solve", "CVaR Call")


def _make_batched_solvers(params: Parameters):
    """Batched solvers: samples [B, N, 2], h [2] -> g values [B]."""

    def dr_batch(samples, h):
        g_star, _ = dr_cvar_g_star(
            samples, h, params.alpha, params.delta, params.epsilon,
            params.robot_radius, params.obstacle_radius)
        return g_star

    def cvar_batch(samples, h):
        return cvar_g_star(samples, h, params.alpha, params.delta,
                           params.robot_radius, params.obstacle_radius)

    return dr_batch, cvar_batch


def save_timing_data(timing_data, path):
    """Persist the nested timing dict to an .npz checkpoint (the JAX
    package's keys: `<key>__<n>`)."""
    flat = {}
    for key, by_n in timing_data.items():
        for n, values in by_n.items():
            flat[f"{key}__{int(n)}"] = np.asarray(values, np.float64)
    np.savez(path, **flat)


def load_timing_data(path):
    """Inverse of `save_timing_data`: .npz -> {key: {n: [ms, ...]}}."""
    timing_data = {}
    with np.load(path) as archive:
        for flat_key in archive.files:
            key, n = flat_key.rsplit("__", 1)
            timing_data.setdefault(key, {})[int(n)] = list(archive[flat_key])
    return timing_data


def analyze_dr_cvar_computation_time(sample_sizes=(10, 50, 100, 500, 1000,
                                                   1500),
                                     n_runs: int = 50, save_dir=None,
                                     params: Parameters | None = None,
                                     repeats: int = 20, seed: int = 0,
                                     dtype=torch.float32, device=DEFAULT_DEVICE,
                                     verbose=True, resume: bool = False):
    """Sweep sample sizes and time batched halfspace solves.

    Per size: `n_runs` Gaussian instances about [0.5, 0] with scale 0.1
    and the fixed normal h = [1, 1]/sqrt(2), from
    `np.random.default_rng(seed)`; `repeats` timed repetitions of setup
    and solve per solver (see the module docstring).  With `resume=True`
    and a `save_dir`, sizes already in `save_dir/timing_data.npz` are
    skipped and the checkpoint is extended.

    Returns {key: {n: [ms, ...]}} with the keys of TIMING_KEYS.
    """
    if params is None:
        params = Parameters()
    device = torch.device(device)
    pin_matmul_precision(device)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    npz_path = os.path.join(save_dir, "timing_data.npz") if save_dir else None

    timing_data = {k: {n: [] for n in sample_sizes} for k in TIMING_KEYS}
    done_sizes = set()
    if resume and npz_path and os.path.exists(npz_path):
        previous = load_timing_data(npz_path)
        for k, by_n in previous.items():
            for n, values in by_n.items():
                if values:
                    timing_data.setdefault(k, {})[n] = values
                    done_sizes.add(n)
        if verbose and done_sizes:
            print(f"Resuming: sizes {sorted(done_sizes)} loaded from "
                  f"{npz_path}")

    dr_batch, cvar_batch = _make_batched_solvers(params)
    h = torch.as_tensor(np.array([1.0, 1.0]) / np.sqrt(2.0), dtype=dtype,
                        device=device)
    rng = np.random.default_rng(seed)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    for n_samples in sample_sizes:
        if n_samples in done_sizes:
            continue
        if verbose:
            print(f"Testing with {n_samples} samples...")
        # Host numpy in the target dtype, so each repeat times a real
        # host -> device copy.
        samples_np = np.asarray(
            np.array([0.5, 0.0])
            + 0.1 * rng.normal(size=(n_runs, n_samples, 2)), dtype=np_dtype)

        for solver, prefix in ((dr_batch, ""), (cvar_batch, "cvar_")):
            # First copy and call, excluded.
            solver(torch.tensor(samples_np, device=device), h).cpu()
            for _ in range(repeats):
                t0 = time.perf_counter()
                samples = torch.tensor(samples_np, device=device)
                float(samples[0, 0, 0])
                setup_ms = (time.perf_counter() - t0) * 1e3 / n_runs

                t0 = time.perf_counter()
                solver(samples, h).cpu()
                solve_ms = (time.perf_counter() - t0) * 1e3 / n_runs
                timing_data[prefix + "setup_times"][n_samples].append(setup_ms)
                timing_data[prefix + "solve_times"][n_samples].append(solve_ms)
                timing_data[prefix + "call_times"][n_samples].append(
                    setup_ms + solve_ms)
        if npz_path:
            save_timing_data(timing_data, npz_path)  # checkpoint per size

    if save_dir:
        plot_timing_results(timing_data, list(sample_sizes), save_dir)
    create_comparison_table(timing_data, list(sample_sizes), save_dir,
                            verbose=verbose)
    return timing_data


def plot_timing_results(timing_data, sample_sizes, save_dir):
    """3-panel boxplots, filtered and unfiltered, and `timing_data.txt`
    (the per-size outlier-removal lines), as the JAX package writes
    them."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    setup_threshold, solve_threshold, call_threshold = 2, 100, 400  # ms

    lines = []
    for n in sample_sizes:
        lines.append(f"Sample size {n}:")
        for key, thr, label in (
                ("setup_times", setup_threshold, "Setup Time"),
                ("solve_times", solve_threshold, "Solve Time"),
                ("call_times", call_threshold, "Call Time")):
            arr = np.asarray(timing_data[key][n])
            removed = int((arr >= thr).sum())
            lines.append(f"  {label}: Removed {removed}/{len(arr)} "
                         f"outliers > {thr}ms")
    with open(os.path.join(save_dir, "timing_data.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    def panel(ax, key, threshold, title):
        data = []
        for n in sample_sizes:
            arr = np.asarray(timing_data[key][n])
            data.append(arr[arr < threshold] if threshold else arr)
        ax.boxplot(data, tick_labels=[str(n) for n in sample_sizes])
        ax.set_title(title)
        ax.set_ylabel("Time (ms)")

    for suffix, thresholds in (
        ("", (setup_threshold, solve_threshold, call_threshold)),
        ("_with_outliers", (None, None, None)),
    ):
        fig, axs = plt.subplots(3, 1, figsize=(10, 12))
        label = ("(outliers > {}ms removed)" if suffix == "" else
                 "(with outliers)")
        panel(axs[0], "setup_times", thresholds[0],
              f"Setup Time {label.format(setup_threshold)}")
        panel(axs[1], "solve_times", thresholds[1],
              f"Solve Time {label.format(solve_threshold)}")
        panel(axs[2], "call_times", thresholds[2],
              f"Call Time {label.format(call_threshold)}")
        axs[2].set_xlabel("Number Samples")
        fig.tight_layout()
        fig.savefig(os.path.join(
            save_dir, f"dr_cvar_computation_time{suffix}.png"))
        plt.close(fig)


def create_comparison_table(timing_data, sample_sizes, save_dir=None,
                            verbose=True):
    """Mean-timing table: printed, and written as `timing_comparison.csv`
    (the JAX package's columns) when `save_dir` is given.  Returns the
    rows as lists."""
    rows = [[n] + [float(np.mean(timing_data[k][n])) for k in TIMING_KEYS]
            for n in sample_sizes]
    if verbose:
        cells = [list(TABLE_COLUMNS)] + [[str(r[0])] + [f"{v:.6f}"
                                                        for v in r[1:]]
                                         for r in rows]
        widths = [max(len(row[i]) for row in cells)
                  for i in range(len(TABLE_COLUMNS))]
        print("\nTiming Comparison (times in ms):")
        for row in cells:
            print(" ".join(c.rjust(w) for c, w in zip(row, widths)))
    if save_dir:
        with open(os.path.join(save_dir, "timing_comparison.csv"), "w",
                  newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")   # as pandas
            writer.writerow(TABLE_COLUMNS)
            writer.writerows(rows)
    return rows
