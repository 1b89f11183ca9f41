#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ops/csrc with nvcc, holds every
kernel against its plain PyTorch version on the card, runs the seeded
end-to-end scenarios against the CPU float64 path and the scipy oracle,
and drives the port's paths once each at a size users run: the scenario
pipeline (`run_scenario_core`, 256 multi_obstacle scenarios with 1000
samples per obstacle), the kernel benchmark (`experiments.kbench`,
32768 rows of 1000 samples), the Monte Carlo study (`cli --mode
monte_carlo --mc_runs 300`) and the timing sweep at the JAX defaults.
It imports torch, numpy, scipy, the port and the numpy-only helpers in
tests/ -- never jax.

Phases (each prints its lines; any failed gate raises and the exit code
is non-zero):
  1. device: nvidia-smi name and power limit, versions, TF32 flags;
  2. build: the kernels' nvcc build;
  3. kernels against their plain versions at the paths' shapes, each
     with its roofline bound; for the batched Cholesky and solve also
     the device time as a CUDA graph of launches, the one PyTorch call
     for the same function, a grid of sizes, matrices that are not
     positive definite and the systems of a real IPM run; the kernel
     benchmark's variants also on a grid of N across both of their
     paths; then the kernel benchmark's attribution lines (launch counts
     from 0);
  4. seeded end to end: the reference's seed-42 streams (N = 20);
  5. the batch run, with its launch counts, checks and wall time;
  6. the entry points: Monte Carlo (twice from one seed, launch counts
     from 0, a CPU float64 re-run of its first runs) and the timing
     sweep.
The line before the last is the kernels' JSON record (for every kernel
but `minimal_planes` `ms` is the device time as a CUDA graph of launches
and `wrapper_ms` the time launch by launch; the solve's top-level numbers
are k = 1's and `k65` holds k = 65's); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"
TPU_PKG = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu"

ARGS = (0.2, 0.1, 0.15, 0.3, 0.3)   # alpha, delta, epsilon, radii (custom)
H_TOL, G_ATOL, G_RTOL, LINALG_RTOL = 1e-5, 2e-4, 1e-5, 1e-5
ORACLE_TOL = 1e-4
LINALG_RESIDUAL = 64 * 2.0 ** -24   # n eps: a backward-stable n <= 64 solve
BATCH = dict(scenarios=256, n_samples=1000, sim_time=6.0, qp_iters=35,
             qp_tol=3e-5, seed=0, recheck=8)
MC = dict(runs=300, recheck=8, tol=1e-3)
# The JAX halfspace bench's shapes (bench.py) for the DR-CVaR solve.
DRCVAR_SHAPES = ((32768, 1000), (8192, 4096), (1, 1000))
# Operation counts a sample for the halfspace kernels' bounds (all of
# them are bound by bytes: these are 5-10 times below).
FLOPS_PER_SAMPLE, FLOPS_PER_SAMPLE_READ_ONLY, SELECT_OPS_PER_PASS = 16, 4, 4


class GateFailed(RuntimeError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def plain_vs_kernel_ms(plain, kernel, reps: int):
    """Times in turns (plain, kernel, kernel, plain) within this call:
    CUDA events over `reps` launches after a warm-up (kbench's timer)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.kbench import (
        cuda_ms)

    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel,
                                                 plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def graph_and_wrapper_ms(pt, plain, kernel, reps: int):
    """(device ms as a CUDA graph of launches, ms launch by launch, plain
    ms): the graph timed twice around the turns of `plain_vs_kernel_ms`."""
    graph_ms = pt.experiments.kbench.graph_ms
    first = graph_ms(kernel)
    wrapper_ms, plain_ms = plain_vs_kernel_ms(plain, kernel, reps)
    return (first + graph_ms(kernel)) / 2, wrapper_ms, plain_ms


def check_close(names, out, ref, label, exact=False):
    """Kernel outputs against their plain versions: normals (names
    starting with "h") to H_TOL, offsets to G_ATOL + G_RTOL |g|, or
    bit-equal; returns the max abs error."""
    import torch

    err = 0.0
    for name, a, b in zip(names, out, ref):
        gate(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        diff = (a - b).abs()
        if exact:
            gate(torch.equal(a, b), f"{label}: {name} not bit-equal")
        elif name.startswith("h"):
            gate(float(diff.max()) <= H_TOL,
                 f"{label}: {name} off by {float(diff.max()):.3e}")
        else:
            gate(bool((diff <= G_ATOL + G_RTOL * b.abs()).all()),
                 f"{label}: {name} off by {float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    return err


def check_halfspaces(ck, samples, ego, alpha, label, far_from_ego=False):
    """Kernel 1 against its plain version; returns the max abs error.

    `far_from_ego` is for rows whose mean may lie near the origin while
    the ego is far from it (Monte Carlo's head_on rows).  The kernel sums
    ego-centred samples, so its float32 mean carries an absolute error of
    a few ulps of |mean - ego|, and h_mean, the mean's direction from the
    ORIGIN, divides that by |mean|: there h_mean is held to H_TOL plus
    4 eps |mean - ego| / |mean| (2e-7 on the batch run's rows)."""
    import torch

    out = ck.all_metrics_halfspaces(samples, ego, alpha, *ARGS[1:])
    torch.cuda.synchronize()
    ref = ck.all_metrics_halfspaces_plain(samples, ego, alpha, *ARGS[1:])
    fields = out._fields
    worst = 0.0
    if far_from_ego:
        mean = samples.double().mean(1)
        slack = (4 * 2.0 ** -24 * (mean - ego).norm(dim=-1)
                 / mean.norm(dim=-1))[:, None]
        diff = (out.h_mean - ref.h_mean).abs()
        gate(bool((diff <= H_TOL + slack).all()),
             f"{label}: h_mean off by {float(diff.max()):.3e}")
        worst = float(diff.max())
        fields = fields[1:]
    return max(worst, check_close(fields, [getattr(out, f) for f in fields],
                                  [getattr(ref, f) for f in fields], label))


def check_hg(out, ref, label, exact=False):
    """(h, g) of a kernel against its plain version (see check_close)."""
    return check_close(("h", "g"), out, ref, label, exact)


def kernel_rows(pt, torch, statics, obstacles, ego_start, ego_goal,
                velocity):
    """Kernel 1's rows as the pipeline builds them."""
    S = obstacles.samples.shape[0]
    start = torch.as_tensor(ego_start, dtype=torch.float32,
                            device=statics.env.device).expand(S, 2)
    goal = torch.as_tensor(ego_goal, dtype=torch.float32,
                           device=statics.env.device).expand(S, 2)
    x_ref, _, _ = pt.models.straight_line_trajectory(statics.planner, start,
                                                     goal, velocity)
    rows, ego, _ = pt.simulation.environment.halfspace_rows(
        statics.env, obstacles.samples, x_ref)
    return rows, ego


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (each input read once, each output
    written once: the roofline's byte count)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def halfspace_entry(pt, err, k_ms, p_ms, tensors, flops_per_sample,
                    select_passes=0.0, wrapper_ms=None) -> dict:
    """A halfspace kernel's entry of the record.  Its bound: the bytes of
    its inputs and outputs against `flops_per_sample` float operations a
    sample (centring, moments, projection) plus SELECT_OPS_PER_PASS for
    each pass of the select over the samples (the production select
    makes its 4 passes whatever the data; where a kernel stops early,
    the caller passes what this run's data needed)."""
    n_samples = tensors[0].numel() // 2
    bound, by = pt.experiments.linalg_bench.roofline_ms(
        tensor_bytes(*tensors), n_samples * (
            flops_per_sample + SELECT_OPS_PER_PASS * select_passes))
    entry = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                 bound_by=by, library_ms=None)
    if wrapper_ms is not None:
        entry["wrapper_ms"] = wrapper_ms
    return entry


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm())


def gate_linalg(out, plain, residual, label) -> float:
    """A factor or a solution against its plain version: within
    LINALG_RTOL relative in norm.  Where the matrix is too badly
    conditioned for two float32 algorithms to agree that closely (the
    IPM's late Schur matrices reach condition numbers of 1e7-1e8), the
    relative residual `residual(out)`, evaluated in float64, is held to
    LINALG_RESIDUAL instead: it does not grow with the condition number.
    Returns the relative difference from the plain version."""
    rel = rel_err(out, plain)
    if rel < LINALG_RTOL:
        return rel
    gate(residual is not None, f"{label}: rel err {rel:.3e}")
    ours, theirs = residual(out), residual(plain)
    gate(ours < LINALG_RESIDUAL, f"{label}: {rel:.3e} from the plain version, "
         f"residual {ours:.3e} (the plain version's {theirs:.3e})")
    print(f"[kernels] {label}: {rel:.3e} from the plain version; relative "
          f"residual {ours:.3e}, the plain version's {theirs:.3e}")
    return rel


def capture_ipm_systems(pt, torch, dev, streams):
    """The Schur matrices and right-hand sides of every factorisation and
    solve of one `solve_mpc_qp` run: the seeded multi_obstacle scenario
    (custom preset, N = 20) through the float32 pipeline on the card."""
    qp = pt.ops.qp_ipm_structured
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    obs = streams.reference_rng_obstacles(scenario, params.sim_time,
                                          params.dt, params.num_samples)
    factored, solved = [], []
    chol, solve = qp.batched_cholesky, qp.batched_cho_solve

    def spy_chol(S):
        factored.append(S)
        return chol(S)

    def spy_solve(L, r):
        solved.append((L, r))
        return solve(L, r)

    qp.batched_cholesky, qp.batched_cho_solve = spy_chol, spy_solve
    try:
        pt.models.run_scenario_with_obstacles(
            pt.models.make_statics(scenario, params, torch.float32, dev),
            pt.convert.obstacle_data(obs, torch.float32, dev, True),
            scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    finally:
        qp.batched_cholesky, qp.batched_cho_solve = chol, solve
    return factored, solved


def phase_linalg(pt, torch, dev, streams, gen):
    """Kernels 2 and 3 against their plain versions: timed at the QP
    batch's shapes, then untimed over a grid of sizes, a batch with
    matrices that are not positive definite, and the systems of a real
    IPM run.  Returns their entries of the kernels' record."""
    cl = pt.ops.cuda_linalg
    lb, kb = pt.experiments.linalg_bench, pt.experiments.kbench
    f32 = dict(dtype=torch.float32, device=dev)

    def spd(B, n):
        A = torch.randn(B, n, n, generator=gen, **f32)
        return A @ A.mT + 3.0 * torch.eye(n, **f32)

    warp_max_k = cl.solve_warp_max_k()
    print(f"[kernels] batched_cho_solve: k <= {warp_max_k} goes to the "
          f"warp-a-matrix kernel, larger k to a thread a right-hand side")

    # Timed, at the QP batch (768 = 256 scenarios x 3 metrics): wrapper
    # against plain in turns, the kernel alone as a CUDA graph of
    # launches (device time), and the one library call beside them.
    B = 768
    entries = {}
    errs = {"batched_cholesky": 0.0, "batched_cho_solve": 0.0}
    for n in (60, 64):
        S = spd(B, n)
        L = cl.batched_cholesky(S)
        L_ref = cl.batched_cholesky_plain(S)
        rel = rel_err(L, L_ref)
        gate(rel < LINALG_RTOL, f"cholesky n={n}: rel err {rel:.3e}")
        gate(float(L.triu(1).abs().max()) == 0.0, "cholesky: upper part")
        errs["batched_cholesky"] = max(errs["batched_cholesky"],
                                       float((L - L_ref).abs().max()))
        cases = [("batched_cholesky", None, lambda: cl.batched_cholesky(S),
                  lambda: cl.batched_cholesky_plain(S),
                  lambda: torch.linalg.cholesky_ex(S),
                  lb.cholesky_bound_ms(B, n))]
        for k in (1, 65):
            r = torch.randn((B, n) if k == 1 else (B, n, k), generator=gen,
                            **f32)
            r3 = r if r.dim() == 3 else r[..., None]
            x = cl.batched_cho_solve(L, r)
            x_ref = cl.batched_cho_solve_plain(L, r)
            rel = rel_err(x, x_ref)
            gate(rel < LINALG_RTOL, f"solve n={n} k={k}: rel err {rel:.3e}")
            errs["batched_cho_solve"] = max(errs["batched_cho_solve"],
                                            float((x - x_ref).abs().max()))
            cases.append(("batched_cho_solve", k,
                          lambda r=r: cl.batched_cho_solve(L, r),
                          lambda r=r: cl.batched_cho_solve_plain(L, r),
                          lambda r3=r3: torch.cholesky_solve(r3, L),
                          lb.cho_solve_bound_ms(B, n, k)))
        for name, k, kernel, plain, library, (bound, bound_by) in cases:
            wrapper_ms, plain_ms = plain_vs_kernel_ms(plain, kernel, reps=20)
            graph_ms = (kb.graph_ms(kernel) + kb.graph_ms(kernel)) / 2
            library_ms = kb.cuda_ms(library, 20)
            what = name + ("" if k is None else f" k={k}")
            print(f"[kernels] {what} [{B}, {n}, {n}]: {graph_ms:.4f} ms as a "
                  f"CUDA graph of launches, {wrapper_ms:.4f} ms launch by "
                  f"launch (plain {plain_ms:.4f} ms, library call "
                  f"{library_ms:.4f} ms); bound {bound:.4f} ms by "
                  f"{bound_by}, {bound / graph_ms:.1%} of it reached")
            if n == 60:
                entry = dict(ms=graph_ms, wrapper_ms=wrapper_ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by, library_ms=library_ms)
                if k == 65:
                    entries[name]["k65"] = entry
                else:
                    entries[name] = entry
    for name, err in errs.items():
        entries[name]["max_abs_err"] = err

    # Untimed: sizes on both sides of 32 and of the solve's threshold.
    worst = 0.0
    for B in (1, 5):
        for n in (1, 2, 31, 32, 33, 60, 64):
            S = spd(B, n)
            L = cl.batched_cholesky(S)
            L_ref = cl.batched_cholesky_plain(S)
            worst = max(worst, gate_linalg(L, L_ref, None,
                                           f"cholesky B={B} n={n}"))
            gate(float(L.triu(1).abs().max()) == 0.0,
                 f"cholesky B={B} n={n}: upper part")
            for k in (1, 2, 31, 32, 33, 65, 256):
                r = torch.randn(B, n, k, generator=gen, **f32)
                worst = max(worst, gate_linalg(
                    cl.batched_cho_solve(L, r),
                    cl.batched_cho_solve_plain(L, r), None,
                    f"solve B={B} n={n} k={k}"))
            r = torch.randn(B, n, generator=gen, **f32)
            x = cl.batched_cho_solve(L, r)
            gate(x.shape == r.shape, "solve: [B, n] shape")
            worst = max(worst, gate_linalg(
                x, cl.batched_cho_solve_plain(L, r), None,
                f"solve B={B} n={n} vector"))
    print(f"[kernels] batched_cholesky / batched_cho_solve: B in (1, 5), n in "
          f"(1, 2, 31, 32, 33, 60, 64), k in (1, 2, 31, 32, 33, 65, 256) "
          f"within {LINALG_RTOL} rel (worst {worst:.2e})")

    # Matrices that are not positive definite, mixed into a batch: NaN
    # where the plain version has NaN, the others bit for bit untouched.
    for n in (33, 60, 64):
        S = spd(8, n)
        L_clean = cl.batched_cholesky(S)
        S_bad = S.clone()
        S_bad[2] = -S[2]
        S_bad[5, n // 2, n // 2] = -1.0
        L = cl.batched_cholesky(S_bad)
        L_ref = cl.batched_cholesky_plain(S_bad)
        gate(torch.equal(torch.isnan(L), torch.isnan(L_ref)),
             f"cholesky n={n}: NaN pattern differs from the plain version")
        gate(bool(torch.isnan(L[[2, 5]]).all()), "cholesky: bad not NaN")
        good = [0, 1, 3, 4, 6, 7]
        gate(torch.equal(L[good], L_clean[good]),
             f"cholesky n={n}: a bad matrix changed its neighbours")
        for k in (1, 65):
            r = torch.randn(8, n, k, generator=gen, **f32)
            x = cl.batched_cho_solve(L, r)
            gate(bool(torch.isnan(x[[2, 5]]).all()),
                 "solve: NaN factor gave a finite solution")
            gate(torch.equal(x[good], cl.batched_cho_solve(L_clean, r)[good]),
                 f"solve n={n} k={k}: a NaN factor changed its neighbours")
    print("[kernels] not positive definite in a batch (n = 33, 60, 64): NaN "
          "where the plain version has NaN, the other matrices bit-equal")

    # The systems of a real IPM run.
    factored, solved = capture_ipm_systems(pt, torch, dev, streams)
    worst_l = worst_x = worst_cond = 0.0
    for S in factored:
        finite = torch.isfinite(cl.batched_cholesky_plain(S)).all(-1).all(-1)
        S = S[finite]
        S64 = S.double()
        worst_l = max(worst_l, gate_linalg(
            cl.batched_cholesky(S), cl.batched_cholesky_plain(S),
            lambda L: rel_err(L.double() @ L.double().mT, S64),
            f"IPM cholesky n={S.shape[1]}"))
        worst_cond = max(worst_cond, float(torch.linalg.cond(S64).max()))
    for L, r in solved:
        finite = torch.isfinite(L).all(-1).all(-1)
        L, r = L[finite], r[finite]
        r64, L64 = r.double().reshape(*r.shape[:2], -1), L.double()

        def residual(x):
            x64 = x.double().reshape(r64.shape)
            return float((L64 @ (L64.mT @ x64) - r64).norm()
                         / (L64.norm() ** 2 * x64.norm() + r64.norm()))

        worst_x = max(worst_x, gate_linalg(
            cl.batched_cho_solve(L, r), cl.batched_cho_solve_plain(L, r),
            residual, f"IPM solve n={L.shape[1]}"))
    print(f"[kernels] one IPM run's systems (seeded multi_obstacle): "
          f"{len(factored)} factorisations (condition number up to "
          f"{worst_cond:.2e}) {worst_l:.2e} and {len(solved)} solves "
          f"{worst_x:.2e} relative from the plain versions")
    return entries


def phase_kernels(pt, torch, dev, streams):
    """Every kernel against its plain version; returns, per kernel of the
    path, (max_abs_err, kernel ms, plain ms) at the main path's shape."""
    ck, cl = pt.ops.cuda_kernels, pt.ops.cuda_linalg
    f32 = dict(dtype=torch.float32, device=dev)
    record = {}
    # The batch run's rows: the same seeded draw as phase 5.
    params, scenario, statics = batch_setup(pt, torch, dev)
    obstacles = pt.simulation.generate_obstacle_scenarios(
        torch.Generator(device=dev).manual_seed(BATCH["seed"]),
        *(torch.as_tensor(v, **f32) for v in (scenario.obstacle_starts,
                                              scenario.obstacle_directions,
                                              scenario.obstacle_speeds)),
        int(params.sim_time / params.dt), params.dt, params.num_samples,
        params.noise_var, BATCH["scenarios"])
    rows, ego = kernel_rows(pt, torch, statics, obstacles,
                            scenario.ego_start, scenario.ego_goal,
                            params.ego_velocity)
    del obstacles
    # The custom preset's N = 20 rows: head_on on the seed-42 streams.
    p20 = pt.config.get_parameters("custom")
    s20 = pt.config.get_scenario_config("head_on")
    obs20 = pt.convert.obstacle_data(
        streams.reference_rng_obstacles(s20, p20.sim_time, p20.dt,
                                        p20.num_samples),
        torch.float32, dev, add_batch=True)
    mc_statics = pt.models.make_statics(s20, p20, torch.float32, dev)
    small_rows = kernel_rows(pt, torch, mc_statics, obs20, s20.ego_start,
                             s20.ego_goal, p20.ego_velocity)

    # Kernel 1 at the batch run's rows, then its edges.
    plan = ck.halfspace_plan(*rows.shape[:2], rows.data_ptr() % 16 == 0)
    print(f"[kernels] all_metrics_halfspaces B={rows.shape[0]} "
          f"N={rows.shape[1]} runs as {plan}")
    err = check_halfspaces(ck, rows, ego, ARGS[0], "batch rows")
    k_ms, w_ms, p_ms = graph_and_wrapper_ms(
        pt, lambda: ck.all_metrics_halfspaces_plain(rows, ego, *ARGS),
        lambda: ck.all_metrics_halfspaces(rows, ego, *ARGS), reps=5)
    record["all_metrics_halfspaces"] = halfspace_entry(
        pt, err, k_ms, p_ms, (rows, ego, *ck.all_metrics_halfspaces(
            rows, ego, *ARGS)), FLOPS_PER_SAMPLE, 4, w_ms)
    print(f"[kernels] all_metrics_halfspaces B={rows.shape[0]} "
          f"N={rows.shape[1]}: max_abs_err {err:.3e}, {k_ms:.4f} ms as a "
          f"CUDA graph of launches, {w_ms:.4f} ms launch by launch (plain "
          f"{p_ms:.4f} ms)")
    check_halfspaces(ck, *small_rows, ARGS[0], "N=20 rows")
    # Monte Carlo's rows: 300 head_on runs, N = 20 (1.4 MB: from L2).
    mc_obs = pt.evaluation.monte_carlo.run_obstacles(
        mc_statics, pt.evaluation.monte_carlo.run_seeds(42, MC["runs"]),
        s20, p20, int(p20.sim_time / p20.dt))
    mc_rows, mc_ego = kernel_rows(pt, torch, mc_statics, mc_obs,
                                  s20.ego_start, s20.ego_goal,
                                  p20.ego_velocity)
    err_mc = check_halfspaces(ck, mc_rows, mc_ego, ARGS[0],
                              "Monte Carlo rows", far_from_ego=True)
    k_mc, w_mc, p_mc = graph_and_wrapper_ms(
        pt, lambda: ck.all_metrics_halfspaces_plain(mc_rows, mc_ego, *ARGS),
        lambda: ck.all_metrics_halfspaces(mc_rows, mc_ego, *ARGS), reps=20)
    print(f"[kernels] all_metrics_halfspaces B={mc_rows.shape[0]} "
          f"N={mc_rows.shape[1]} (Monte Carlo's rows, "
          f"{tensor_bytes(mc_rows) / 1e6:.1f} MB: they stay in L2): "
          f"max_abs_err {err_mc:.3e}, {k_mc:.4f} ms as a CUDA graph of "
          f"launches, {w_mc:.4f} ms launch by launch (plain {p_mc:.4f} ms)")
    del mc_obs
    # Both sides of the warp path's limit of 1024, odd N (8-byte loads),
    # B off the rows-a-block multiple, every number of values a lane.
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, N in ((4, 4096), (13, 1001), (11, 50), (1, 1), (9, 1024),
                 (6, 1025), (10, 999), (7, 130), (5, 300), (3, 64), (3, 65)):
        x = 2.0 + 0.1 * torch.randn(B, N, 2, generator=gen, **f32)
        check_halfspaces(ck, x, torch.randn(B, 2, generator=gen, **f32),
                         ARGS[0], f"B={B} N={N}")
    # A view that starts 8 bytes into its storage takes the 8-byte loads
    # and gives the 16-byte loads' results bit for bit.
    x = 2.0 + 0.1 * torch.randn(9, 1000, 2, generator=gen, **f32)
    e = torch.randn(9, 2, generator=gen, **f32)
    view = torch.empty(x.numel() + 2, **f32)[2:].view_as(x).copy_(x)
    gate(view.data_ptr() % 16 == 8, "misaligned view: is aligned")
    check_close(ck.MetricHalfspaces._fields,
                ck.all_metrics_halfspaces(view, e, *ARGS),
                ck.all_metrics_halfspaces(x, e, *ARGS), "misaligned view",
                exact=True)
    rng = np.random.default_rng(7)
    for case in ("ties", "constant", "outlier", "negative", "laplace",
                 "alpha_mid"):
        vals = streams.adversarial_samples(case, rng, 8, 64)
        check_halfspaces(ck, torch.as_tensor(vals, **f32),
                         torch.as_tensor(rng.normal(size=(8, 2)), **f32),
                         0.5 if case == "alpha_mid" else ARGS[0], case)
    # The select alone, bit for bit, on the plain path's projections and
    # on both paths' sizes.
    h = ck.all_metrics_halfspaces_plain(rows, ego, *ARGS).h
    centered = rows - ego[:, None, :]
    mean = centered.mean(1, keepdim=True)
    x = -((centered - mean) * h[:, None, :]).sum(-1).contiguous()
    n = x.shape[1]
    k = pt.core.risk.cvar_k(n, ARGS[0])
    v = ck.kth_largest(x, k)
    ref = torch.kthvalue(x, n - k + 1, dim=-1).values
    gate(torch.equal(v, ref), "select: k-th value not bit-equal")
    replay, passes = ck.radix_select_plain(x, k)
    gate(torch.equal(v, replay), "select: differs from its torch replay")
    print(f"[kernels] select: k-th largest (k={k}) bit-equal to "
          f"torch.kthvalue on {x.shape[0]} rows; passes a row mean "
          f"{float(passes.float().mean()):.3f} of 4")
    for n in (20, 1024, 1025, 4096):
        x = torch.randn(67, n, generator=gen, **f32)
        x[:8] = torch.round(x[:8])            # heavy ties, signed zeros
        x[8:16] = x[8:16, :1]                 # constant rows
        for k in (1, pt.core.risk.cvar_k(n, ARGS[0]), n):
            gate(torch.equal(ck.kth_largest(x, k),
                             torch.kthvalue(x, n - k + 1, dim=-1).values),
                 f"select N={n} k={k}: k-th value not bit-equal")
    print("[kernels] select: bit-equal to torch.kthvalue at N = 20, 1024, "
          "1025, 4096 with k = 1, ceil(alpha N), N (ties and constant rows "
          "among them)")
    print("[kernels] all_metrics_halfspaces: N=20, Monte Carlo's rows, "
          "N=1024 / 1025, odd N, ragged B/N and the six adversarial cases "
          "within h 1e-5, g 2e-4 + 1e-5 rel; a misaligned view bit-equal")

    record.update(phase_linalg(pt, torch, dev, streams, gen))

    # Kernel 4: bit-equal to kernel 1 on the batch run's rows; within
    # kernel 1's tolerance of its plain version at the JAX bench shapes.
    out = ck.fused_drcvar_halfspace(rows, ego, *ARGS)
    ref = ck.all_metrics_halfspaces(rows, ego, *ARGS)
    check_hg(out, (ref.h, ref.g_drcvar), "drcvar vs kernel 1", exact=True)
    check_hg(out, ck.fused_drcvar_halfspace_plain(rows, ego, *ARGS),
             "drcvar batch rows")
    print(f"[kernels] fused_drcvar_halfspace B={rows.shape[0]} "
          f"N={rows.shape[1]}: (h, g) bit-equal to all_metrics_halfspaces' "
          f"(h, g_drcvar)")
    # Kernel 7 on the same rows: equal to its plain version row by row,
    # so its mean is the mean of the production select's replayed passes.
    cv = pt.ops.cuda_variants
    passes = cv.select_rounds(rows, ego, ARGS[0])
    passes_ref = cv.select_rounds_plain(rows, ego, ARGS[0])
    gate(torch.equal(passes, passes_ref), "select_rounds on the batch rows: "
         f"differs from plain on {int((passes != passes_ref).sum())} rows")
    gate(float(passes.float().mean()) == float(passes_ref.float().mean()),
         "select_rounds on the batch rows: mean differs from the replay's")
    print(f"[kernels] select_rounds B={rows.shape[0]} N={rows.shape[1]}: "
          f"equal to radix_select_plain's passes on its own projections on "
          f"every row, mean {float(passes.float().mean()):.3f} of 4")
    del rows, ego, out, ref, passes, passes_ref
    kb = pt.experiments.kbench
    err4 = 0.0
    for B, N in DRCVAR_SHAPES:
        x, e = kb.make_inputs(B, N, dev, seed=B)
        err4 = max(err4, check_hg(
            ck.fused_drcvar_halfspace(x, e, *ARGS),
            ck.fused_drcvar_halfspace_plain(x, e, *ARGS), f"drcvar B={B}"))
        k_ms, w_ms, p_ms = graph_and_wrapper_ms(
            pt, lambda: ck.fused_drcvar_halfspace_plain(x, e, *ARGS),
            lambda: ck.fused_drcvar_halfspace(x, e, *ARGS), reps=5)
        print(f"[kernels] fused_drcvar_halfspace B={B} N={N}: {k_ms:.4f} ms "
              f"as a CUDA graph of launches, {w_ms:.4f} ms launch by launch "
              f"(plain {p_ms:.4f} ms), {B * N * 8 / k_ms / 1e6:.1f} GB/s "
              f"implied")
        if (B, N) == DRCVAR_SHAPES[0]:
            record["fused_drcvar_halfspace"] = halfspace_entry(
                pt, err4, k_ms, p_ms, (x, e, *ck.fused_drcvar_halfspace(
                    x, e, *ARGS)), FLOPS_PER_SAMPLE, 4, w_ms)
        del x, e
    record["fused_drcvar_halfspace"]["max_abs_err"] = err4

    # Kernels 5-7 at the kernel benchmark's shape.
    x, e = kb.make_inputs(kb.BATCH, kb.N_SAMPLES, dev)
    plan = ck.halfspace_plan(*x.shape[:2], x.data_ptr() % 16 == 0)
    print(f"[kernels] drcvar_variant / select_rounds B={kb.BATCH} "
          f"N={kb.N_SAMPLES} run as {plan}")
    prod = cv.drcvar_variant(x, e, "prod")
    err5 = 0.0
    for v in cv.VARIANTS[1:]:
        out = cv.drcvar_variant(x, e, v)
        err = check_hg(out, cv.drcvar_variant_plain(x, e, v), f"variant {v}")
        err5 = max(err5, err)
        if v in ("r3", "fixed22"):
            # Both bisect to the exact k-th value: the production solve
            # to float32 rounding.
            check_hg(out, prod, f"variant {v} against prod")
        k_ms, w_ms, p_ms = graph_and_wrapper_ms(
            pt, lambda: cv.drcvar_variant_plain(x, e, v),
            lambda: cv.drcvar_variant(x, e, v), reps=3)
        print(f"[kernels] drcvar_variant {v} B={kb.BATCH} N={kb.N_SAMPLES}: "
              f"max_abs_err {err:.3e}, {k_ms:.4f} ms as a CUDA graph of "
              f"launches, {w_ms:.4f} ms launch by launch (plain {p_ms:.4f} "
              f"ms)")
        if v == "r3":
            # r3's bisection stops early: its bound counts the rounds
            # this run's rows need (and is still the bytes').
            moved = cv.bisect_rounds_plain(x, e).float()
            print(f"[kernels] drcvar_variant r3: rounds a row mean "
                  f"{float(moved.mean()):.3f} max {int(moved.max())} of 22")
            record["drcvar_variant"] = halfspace_entry(
                pt, err, k_ms, p_ms, (x, e, *out), FLOPS_PER_SAMPLE,
                float(moved.mean()), w_ms)
    record["drcvar_variant"]["max_abs_err"] = err5
    err6 = check_hg(cv.minimal_planes(x, e), cv.minimal_planes_plain(x, e),
                    "minimal_planes")
    record["minimal_planes"] = halfspace_entry(pt, err6, *plain_vs_kernel_ms(
        lambda: cv.minimal_planes_plain(x, e),
        lambda: cv.minimal_planes(x, e), reps=5),
        (x, e, *cv.minimal_planes(x, e)), FLOPS_PER_SAMPLE_READ_ONLY)
    rounds = cv.select_rounds(x, e, ARGS[0])
    rounds_ref = cv.select_rounds_plain(x, e, ARGS[0])
    gate(torch.equal(rounds, rounds_ref), "select_rounds: differs from plain "
         f"on {int((rounds != rounds_ref).sum())} rows")
    k_ms, w_ms, p_ms = graph_and_wrapper_ms(
        pt, lambda: cv.select_rounds_plain(x, e, ARGS[0]),
        lambda: cv.select_rounds(x, e, ARGS[0]), reps=3)
    record["select_rounds"] = halfspace_entry(
        pt, float((rounds - rounds_ref).abs().max()), k_ms, p_ms,
        (x, e, rounds), FLOPS_PER_SAMPLE, float(rounds.float().mean()), w_ms)
    print(f"[kernels] minimal_planes B={kb.BATCH} N={kb.N_SAMPLES}: "
          f"max_abs_err {err6:.3e}, {record['minimal_planes']['ms']:.4f} ms "
          f"(plain {record['minimal_planes']['plain_ms']:.4f} ms)")
    print(f"[kernels] select_rounds B={kb.BATCH} N={kb.N_SAMPLES}: equal to "
          f"its plain version on every row (mean "
          f"{float(rounds.float().mean()):.3f} of 4 passes), {k_ms:.4f} ms "
          f"as a CUDA graph of launches, {w_ms:.4f} ms launch by launch "
          f"(plain {p_ms:.4f} ms)")
    del x, e, prod, out, rounds, rounds_ref
    # Every variant and select_rounds on every number of values a lane,
    # both sides of the warp path's limit, an odd N (8-byte loads), rows of
    # repeated samples and constant rows, and a view that starts 8 bytes
    # into its storage: bit-equal to the aligned rows' results.
    grid = (20, 64, 65, 999, 1000, 1024, 1025, 4096)
    for N in grid:
        B = 67
        x = 0.5 + 0.1 * torch.randn(B, N, 2, generator=gen, **f32)
        x[:4] = torch.round(x[:4] * 4) / 4
        x[4:8] = x[4:8, :1]
        e = 0.1 * torch.randn(B, 2, generator=gen, **f32)
        view = torch.empty(x.numel() + 2, **f32)[2:].view_as(x).copy_(x)
        gate(view.data_ptr() % 16 == 8, "misaligned view: is aligned")
        for v in cv.VARIANTS[1:]:
            out = cv.drcvar_variant(x, e, v)
            check_hg(out, cv.drcvar_variant_plain(x, e, v),
                     f"variant {v} N={N}")
            check_hg(cv.drcvar_variant(view, e, v), out,
                     f"variant {v} N={N} misaligned view", exact=True)
        rounds = cv.select_rounds(x, e, ARGS[0])
        gate(torch.equal(rounds, cv.select_rounds_plain(x, e, ARGS[0])),
             f"select_rounds N={N}: differs from plain")
        gate(torch.equal(rounds, cv.select_rounds(view, e, ARGS[0])),
             f"select_rounds N={N}: a misaligned view differs")
        want = 4 if N <= ck.WARP_MAX_N else 1    # every key tied
        gate(rounds[4:8].tolist() == [want] * 4,
             f"select_rounds N={N}: constant rows give {rounds[4:8].tolist()}")
    torch.cuda.synchronize()
    print(f"[kernels] variants and select_rounds at N = "
          f"{', '.join(map(str, grid))}: within tolerance of / equal to their "
          f"plain versions, a misaligned view bit-equal; constant rows run 4 "
          f"passes on the warp path (N <= {ck.WARP_MAX_N})")
    for name, entry in record.items():
        print(f"[kernels] {name}: bound {entry['bound_ms']:.4f} ms by "
              f"{entry['bound_by']}, {entry['bound_ms'] / entry['ms']:.1%} "
              f"of it reached")
    print(f"[kernels] variants within h {H_TOL}, g {G_ATOL} + {G_RTOL} rel; "
          "select_rounds equal to its plain version on every row")
    return record


def drive_kbench(pt, torch):
    """The kernel benchmark's path: counts from 0, every variant once
    through `experiments.kbench.measure`; returns the launch counts."""
    ck, cv = pt.ops.cuda_kernels, pt.ops.cuda_variants
    kernels = (ck.fused_drcvar_halfspace, cv.drcvar_variant,
               cv.minimal_planes, cv.select_rounds)
    for fn in kernels:
        fn.launches = 0
    pt.experiments.kbench.measure(pt.experiments.kbench.NAMES)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    gate(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    print(f"[kbench] launches {launches}")
    return launches


def phase_e2e(pt, torch, dev, streams):
    """Seeded scenarios: GPU float32 against CPU float64 and the oracle."""
    for preset, name in streams.E2E_CASES:
        params = pt.config.get_parameters(preset)
        scenario = pt.config.get_scenario_config(name, preset)
        sim_time = scenario.sim_time or params.sim_time
        obs = streams.reference_rng_obstacles(scenario, sim_time, params.dt,
                                              params.num_samples)
        runs = {}
        for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            statics = pt.models.make_statics(scenario, params, dtype, device)
            runs[device] = pt.models.run_scenario_with_obstacles(
                statics, pt.convert.obstacle_data(obs, dtype, device, True),
                scenario.ego_start, scenario.ego_goal, params.ego_velocity)
        gpu, cpu = runs[dev], runs["cpu"]
        gate(bool(torch.isfinite(gpu.filtered_u).all()), f"{name}: not finite")
        gate(bool(gpu.qp_converged.all()), f"{preset}/{name}: not converged")
        u_gpu = gpu.filtered_u[0].cpu().double().numpy()
        dev_cpu = float(np.abs(u_gpu - cpu.filtered_u[0].numpy()).max())
        line = f"[e2e] {preset}/{name}: |u_gpu - u_cpu_f64| {dev_cpu:.3e}"
        if preset == "custom" and name in ("head_on", "multi_obstacle"):
            halfspaces = {m: (cpu.halfspaces.by_metric(m).h[0].numpy(),
                              cpu.halfspaces.by_metric(m).g_tilde[0].numpy())
                          for m in pt.models.METRICS}
            oracle = streams.oracle_controls(params, scenario,
                                             cpu.x_ref[0].numpy(), halfspaces)
            worst = max(float(np.abs(u_gpu[mi] - oracle[m]).max())
                        for mi, m in enumerate(pt.models.METRICS))
            gate(worst < ORACLE_TOL,
                 f"{name}: GPU controls {worst:.3e} from the oracle")
            line += f", |u_gpu - u_oracle| {worst:.3e} (gate {ORACLE_TOL})"
        else:
            line += " (not gated)"
        print(line)


def batch_setup(pt, torch, dev):
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 num_samples=BATCH["n_samples"],
                                 sim_time=BATCH["sim_time"])
    scenario = pt.config.get_scenario_config("multi_obstacle")
    statics = pt.models.make_statics(scenario, params, torch.float32, dev)
    return params, scenario, statics


def run_batch(pt, torch, dev, params, scenario, statics):
    gen = torch.Generator(device=dev).manual_seed(BATCH["seed"])
    return pt.models.run_scenario_core(
        statics, gen, scenario.ego_start, scenario.ego_goal,
        scenario.obstacle_starts, scenario.obstacle_directions,
        scenario.obstacle_speeds, int(params.sim_time / params.dt),
        params.num_samples, params.noise_var, params.ego_velocity,
        qp_iters=BATCH["qp_iters"], qp_tol=BATCH["qp_tol"],
        n_scenarios=BATCH["scenarios"])


def phase_entry_points(pt, torch, dev, card):
    """Monte Carlo through the CLI (twice from one seed) and the timing
    sweep at the JAX defaults."""
    ck, cl = pt.ops.cuda_kernels, pt.ops.cuda_linalg
    kernels = (ck.all_metrics_halfspaces, cl.batched_cholesky,
               cl.batched_cho_solve)
    argv = ["--mode", "monte_carlo", "--mc_runs", str(MC["runs"]),
            "--device", "cuda"]
    runs, walls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            res = pt.cli.main(argv + ["--save_dir", tmp])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = {fn.__name__: fn.launches for fn in kernels}
            gate(min(launches.values()) > 0,
                 f"monte_carlo: a kernel never launched: {launches}")
            runs.append(res)
        gate((Path(tmp) / "head_on_mc_data.npz").exists(),
             "monte_carlo: head_on_mc_data.npz not written")
    first, second = runs
    gate(first.min_distances.shape == (MC["runs"], 4), "monte_carlo shape")
    gate(bool(torch.isfinite(first.min_distances).all()),
         "monte_carlo: min distances not finite")
    gate(torch.equal(first.min_distances, second.min_distances),
         "monte_carlo: two runs from one seed differ")
    # The first runs' obstacle draws again, through the CPU float64 path.
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("head_on")
    n_re = MC["recheck"]
    statics = pt.models.make_statics(scenario, params, torch.float32, dev)
    obs = pt.evaluation.monte_carlo.run_obstacles(
        statics, pt.evaluation.monte_carlo.run_seeds(42, MC["runs"])[:n_re],
        scenario, params, int(params.sim_time / params.dt))
    cpu = pt.models.run_scenario_with_obstacles(
        pt.models.make_statics(scenario, params, torch.float64, "cpu"),
        pt.simulation.ObstacleData(*(t.cpu().double() for t in obs)),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    md_cpu, _ = pt.evaluation.monte_carlo.reduce_runs(cpu)
    dev_md = float((first.min_distances[:n_re].cpu().double() - md_cpu)
                   .abs().max())
    gate(dev_md < MC["tol"], f"monte_carlo: min distances {dev_md:.3e} from "
         "the CPU float64 run")
    conv = float(first.qp_converged.float().mean())
    probs = ", ".join(f"{m} {float(p):.3f}" for m, p in zip(
        list(pt.models.METRICS) + ["reference"], first.collision_probs))
    print(f"[mc] {MC['runs']} runs of head_on (custom, N = "
          f"{params.num_samples}): collision probabilities {probs}")
    print(f"[mc] converged {conv:.4f}; wall {walls[0]:.1f} ms and "
          f"{walls[1]:.1f} ms (CLI, host clock, save included) on {card}; "
          f"launches {launches}; the two runs' min distances are identical; "
          f"the first {n_re} runs within {dev_md:.2e} of CPU float64")

    data = pt.evaluation.analyze_dr_cvar_computation_time(
        save_dir=None, device=dev, verbose=False)
    for n in sorted(data["solve_times"]):
        dr, cvar = (float(np.mean(data[k][n]))
                    for k in ("solve_times", "cvar_solve_times"))
        setup = float(np.mean(data["setup_times"][n]))
        gate(np.isfinite([dr, cvar, setup]).all(), "timing: not finite")
        print(f"[timing] N={n}: solve ms per instance dr_cvar {dr:.6f}, "
              f"cvar {cvar:.6f}, setup {setup:.6f} (50 runs, 20 repeats)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 card (H100), "
                         f"found capability {cap}")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ is not beside this script; "
                         "run it from a checkout of the repository")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch_port_streams as streams
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.cli  # noqa: F401,E501
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.kbench  # noqa: F401,E501
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.linalg_bench  # noqa: F401,E501

    dev = torch.device("cuda", 0)
    ck, cl = pt.ops.cuda_kernels, pt.ops.cuda_linalg

    # 1. Device.
    card = nvidia_smi()
    pt.models.pipeline.pin_matmul_precision(dev)
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()}")

    # 2. Build.
    t0 = time.perf_counter()
    lib = pt.ops._build.load()
    print(f"[build] {lib.path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s; 0 = reused)")
    for line in lib.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # 3. Kernels against their plain versions, at the paths' shapes; then
    # the kernel benchmark's path.
    record = phase_kernels(pt, torch, dev, streams)
    kbench_launches = drive_kbench(pt, torch)

    # 4. Seeded end to end.
    phase_e2e(pt, torch, dev, streams)

    # 5. The batch run: a warm-up drive, then counters from 0 and one
    # measured drive of the main path.
    params, scenario, statics = batch_setup(pt, torch, dev)
    warm = run_batch(pt, torch, dev, params, scenario, statics)
    for fn in (ck.all_metrics_halfspaces, cl.batched_cholesky,
               cl.batched_cho_solve):
        fn.launches = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = run_batch(pt, torch, dev, params, scenario, statics)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    device_ms = start.elapsed_time(end)
    launches = {"all_metrics_halfspaces": ck.all_metrics_halfspaces.launches,
                "batched_cholesky": cl.batched_cholesky.launches,
                "batched_cho_solve": cl.batched_cho_solve.launches}
    gate(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    S = BATCH["scenarios"]
    gate(res.filtered_u.shape == (S, 3, params.horizon, 2), "batch shape")
    for name in ("filtered_u", "filtered_x", "objective", "distances",
                 "reference_distance"):
        gate(bool(torch.isfinite(getattr(res, name)).all()),
             f"batch: {name} not finite")
    for m in pt.models.METRICS:
        hs = res.halfspaces.by_metric(m)
        gate(bool(torch.isfinite(hs.h).all() & torch.isfinite(hs.g_tilde)
                  .all()), f"batch: {m} halfspaces not finite")
    gate(torch.equal(res.filtered_u, warm.filtered_u),
         "batch: two runs from the same seed differ")

    # Re-run the first scenarios through the CPU float64 plain path on
    # the same obstacle data.
    n_re = BATCH["recheck"]
    cpu_statics = pt.models.make_statics(scenario, params, torch.float64,
                                         "cpu")
    sub = pt.simulation.ObstacleData(*(t[:n_re].cpu().double()
                                       for t in res.obstacles))
    cpu = pt.models.run_scenario_with_obstacles(
        cpu_statics, sub, scenario.ego_start, scenario.ego_goal,
        params.ego_velocity, BATCH["qp_iters"], BATCH["qp_tol"])
    gate(torch.equal(cpu.qp_converged, res.qp_converged[:n_re].cpu()),
         "batch: converged flags differ from the CPU float64 run")
    obj_rel = float(((res.objective[:n_re].cpu().double() - cpu.objective)
                     .abs() / cpu.objective.abs().clamp(min=1e-12)).max())
    gate(obj_rel < 1e-4, f"batch: objectives off by {obj_rel:.3e} relative")

    conv = float(res.qp_converged.float().mean())
    iters = float(res.qp_iterations.float().mean())
    print(f"[batch] {S} x multi_obstacle, N={params.num_samples}, "
          f"{int(params.sim_time / params.dt)} steps, horizon "
          f"{params.horizon}: {res.halfspaces.mean.g_tilde.numel()} "
          f"halfspace rows, "
          f"{3 * S} QPs; {res.obstacles.samples.numel() * 4 / 1e6:.0f} MB "
          f"of samples on the device")
    print(f"[batch] converged {conv:.4f}, IPM iterations mean {iters:.4f} max "
          f"{int(res.qp_iterations.max())}, "
          f"wall {device_ms:.1f} ms by CUDA events ({host_ms:.1f} ms host) "
          f"on {card}")
    print(f"[batch] CPU float64 re-run of {n_re} scenarios: converged flags "
          f"agree, objectives within {obj_rel:.2e} relative")
    print(f"[batch] launches {launches}")
    launches.update(kbench_launches)

    # 6. The entry points.
    phase_entry_points(pt, torch, dev, card)

    source = f"{PKG}/ops/csrc/"
    kernels = [
        ("all_metrics_halfspaces", "halfspace_kernels.cu",
         f"{TPU_PKG}/ops/pallas_kernels.py:82"),
        ("batched_cholesky", "linalg_kernels.cu",
         f"{TPU_PKG}/ops/pallas_linalg.py:46"),
        ("batched_cho_solve", "linalg_kernels.cu",
         f"{TPU_PKG}/ops/pallas_linalg.py:71"),
        ("fused_drcvar_halfspace", "halfspace_kernels.cu",
         f"{TPU_PKG}/ops/pallas_kernels.py:380"),
        ("drcvar_variant", "halfspace_variants.cu", "experiments/kbench.py:176"),
        ("minimal_planes", "halfspace_variants.cu", "experiments/kbench.py:272"),
        ("select_rounds", "halfspace_variants.cu", "experiments/kbench.py:388"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source + src,
         "replaces": replaces, "launches": launches[name], **record[name]}
        for name, src, replaces in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
