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
monte_carlo --mc_runs 300`) and the timing sweep at the JAX defaults,
the same Monte Carlo split over a mesh of processes (`--mesh`, and two
ranks sharing the card), the sample-parallel solve at 1,024 rows of
100,000 samples, the generic IPM at 768 QPs and the QP planner.
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
     from 0); then the draw kernel on a head_on_n20 study (300 runs) and
     a 1,024-run chunk, bit-equal to the loop of one card generator a run
     from the same seeds, as a CUDA graph of launches against the loop;
  4. seeded end to end: the reference's seed-42 streams (N = 20);
  5. the batch run, with its launch counts, checks and wall time; then
     the IPM pass's three fused kernels on its 768 QPs (n = 60, 60 box
     rows of T, 90 soft rows): one fused pass against the plain pass,
     each kernel as a CUDA graph of 50 launches with its bound and the
     plain pass's device time for the same work, and a pass's graph
     nodes and device time, fused and plain;
  6. the single-scenario filter API, launch counts from 0:
     `filter_trajectory` per metric on the seeded multi_obstacle
     scenario against the oracle and the pipeline, both fallbacks, the
     bounds dropped, `filter_core_batched` at 2,048 QPs in chunks of 512
     against one flat call, and a warm-started `solve_mpc_qp`;
  7. what the hand kernels do not take, on the card all the same (the
     call sites choose by dtype and shape): `cli --dtype float64` in
     single and Monte Carlo mode, 393,217 samples a row, horizons 31 and
     40; and rows of 49,153 and 100,000 samples, one launch of kernel 1's
     cluster path each;
  8. the entry points: Monte Carlo (twice from one seed, launch counts
     from 0, one draw kernel launch a chunk, a CPU float64 re-run of its
     first runs on the same draws, which phase 3 holds to the loop's) and
     the timing sweep;
  9. parallel/ and the generic solvers, counts from 0 before each drive:
     `[mesh]` the CLI's Monte Carlo with --mesh data=1 in this process on
     NCCL (equal to phase 8's run, one collective), the timing sweep's
     files with and without it, then two spawned ranks on cuda:0 over
     Gloo at data = 2 (each rank's block equal to its runs solved alone,
     float64 split against flat, the float32 distance printed);
     `[sample_parallel]` the same two ranks at samples = 2 on 1,024 x
     100,000 samples (g against float64, the k-th value bit-equal to
     torch.kthvalue, rounds and collectives); `[qp_ipm]`
     `solve_qp_batched` on 768 random QPs (n = 60, m = 240) against CPU
     float64; `[planner]` `plan_trajectory` with bounds at H = 30 against
     the scipy oracle; both launch kernels 2 and 3;
 10. the last modules, counts from 0 before each drive: `[qpbench]` chol,
     bt, diag and pnone at batch 2048; `[native]` the C++ host solver
     built with g++ on 8 of the batch run's QPs against the card's
     float64 IPM; `[gallery]` custom head_on through
     `experiments.make_gallery` and `[demo]` both demos on the card.
The line before the last is the kernels' JSON record (for every kernel
but `minimal_planes` `ms` is the device time as a CUDA graph of launches
and, for kernels 1-7, `wrapper_ms` the time launch by launch; the solve's
top-level numbers are k = 1's and `k65` holds k = 65's; kernels 1-3 also
list the launches of phases 9 and 10's paths; the draw kernel's
`launches` are phase 8's, its `plain_ms` the loop's host-bound time); the
last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
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
# Phase 3: the draw kernel on mc300's study and on a whole default chunk.
DRAWS = dict(studies=((42, 300), (7, 1024)), reps=3)
CHUNKED = dict(qps=2048, chunk=512)   # filter_core_batched against flat
# Phase 9: Monte Carlo over two ranks sharing the card (Gloo), its float64
# check, the sample-parallel solve at the JAX module's N >> 1e5 setting,
# the generic IPM at the batch run's QP size, the planner at H = 30.
MESH = dict(runs=300, f64_runs=16, f64_tol=1e-9, timeout=600)
SAMPLE_PAR = dict(rows=1024, n=100_000, seed=0, rtol=1e-5)
QP = dict(batch=768, n=60, m=240, seed=0, tol=3e-5,
          merit_rounding=1.1)   # see phase_generic_qp
PLAN = dict(x0=(-4.0, 0.0, 0.0, 0.0), goal=(4.0, 0.0, 0.0, 0.0),
            u_lim=0.3, x_lim=(10.0, 10.0, 5.0, 5.0), obj_rtol=1e-5,
            viol=1e-5)
# Phase 10: the last modules on the batch run's QPs and the bench shape.
QPBENCH = dict(specs=("chol:2048", "bt:2048", "diag:2048", "pnone:2048"),
               repeats=3, k=4)
NATIVE = dict(qps=8, max_iters=200, obj_rtol=1e-6, viol=1e-7)
TIMING_CLI = ["--mode", "timing_analysis", "--sample_sizes", "10,1000",
              "--timing_runs", "5", "--device", "cuda"]
# The JAX halfspace bench's shapes (bench.py) for the DR-CVaR solve.
DRCVAR_SHAPES = ((32768, 1000), (8192, 4096), (1, 1000))
# Kernel 1's cluster path: the rows of a call of the benchmark's
# paper_multi_obstacle_n49153.halfspaces128 cell (128 x 26 x 3 rows of
# 49,153), and the sample-parallel solve's row length.
CLUSTER_SHAPES = ((9984, 49153), (1024, 100_000))
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
    """|a - b| / |b| in norm; 0 where a equals b (a zero solution too)."""
    diff = (a - b).norm()
    return 0.0 if float(diff) == 0.0 else float(diff / b.norm())


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


def phase_cluster(pt, torch, dev, gen) -> dict:
    """Kernel 1's cluster path at CLUSTER_SHAPES against its plain
    version, with its time as a CUDA graph of launches and launch by
    launch, its bound and the plain version's time; the select alone
    bit-equal to torch.kthvalue on the same rows' first 64."""
    ck = pt.ops.cuda_kernels
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    for B, N in CLUSTER_SHAPES:
        x = 2.0 + 0.1 * torch.randn(B, N, 2, generator=gen, **f32)
        e = torch.randn(B, 2, generator=gen, **f32)
        plan = ck.halfspace_plan(B, N, x.data_ptr() % 16 == 0)
        gate(plan.entry == "cluster", f"B={B} N={N}: plan {plan}")
        err = check_halfspaces(ck, x, e, ARGS[0], f"cluster B={B} N={N}")
        k_ms, w_ms, p_ms = graph_and_wrapper_ms(
            pt, lambda: ck.all_metrics_halfspaces_plain(x, e, *ARGS),
            lambda: ck.all_metrics_halfspaces(x, e, *ARGS), reps=3)
        entry = halfspace_entry(pt, err, k_ms, p_ms, (x, e, *ck.all_metrics_halfspaces(
            x, e, *ARGS)), FLOPS_PER_SAMPLE, 4, w_ms)
        proj = x[:64, :, 0].contiguous()
        k = pt.core.risk.cvar_k(N, ARGS[0])
        gate(torch.equal(ck.kth_largest(proj, k),
                         torch.kthvalue(proj, N - k + 1, dim=-1).values),
             f"cluster select N={N}: k-th value not bit-equal")
        out[f"{B}x{N}"] = entry
        print(f"[kernels] all_metrics_halfspaces B={B} N={N} runs as {plan}: "
              f"max_abs_err {err:.3e}, {k_ms:.4f} ms as a CUDA graph of "
              f"launches, {w_ms:.4f} ms launch by launch (plain {p_ms:.4f} "
              f"ms); bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
              f"{100 * entry['bound_ms'] / k_ms:.1f}% of it; the select "
              f"bit-equal to torch.kthvalue")
        del x, e, proj
        torch.cuda.empty_cache()
    return out


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
    record["all_metrics_halfspaces"]["cluster"] = phase_cluster(pt, torch,
                                                                dev, gen)

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


def phase_draws(pt, torch, dev) -> dict:
    """3b. The draw kernel on the custom preset's head_on (one obstacle,
    20 samples, 151 steps): a 300-run study and a 1,024-run chunk from
    their run seeds, every output bit-equal to the loop of one card
    generator a run (`draw_runs_loop`) and drawn in one launch; timed as
    a CUDA graph of launches, launch by launch, and the loop (host-bound:
    one generator and ~5 launches a run).  Returns the kernel's entry of
    the record, at the study's size."""
    obs_mod, mc = pt.simulation.obstacles, pt.evaluation.monte_carlo
    draws = pt.ops.cuda_draws.obstacle_draws
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("head_on")
    f32 = dict(dtype=torch.float32, device=dev)
    starts, directions, speeds = (torch.as_tensor(v, **f32) for v in (
        scenario.obstacle_starts, scenario.obstacle_directions,
        scenario.obstacle_speeds))
    n_steps = int(params.sim_time / params.dt)
    entry = None
    for seed, runs in DRAWS["studies"]:
        seeds = mc.run_seeds(seed, runs)
        args = (seeds, starts, directions, speeds, n_steps, params.dt,
                params.num_samples, params.noise_var)
        before = draws.launches
        got = obs_mod.draw_runs_kernel(*args)
        gate(draws.launches - before == 1,
             f"[draws] {runs} runs: {draws.launches - before} launches")
        want = obs_mod.draw_runs_loop(*args)
        for name, a, b in zip(got._fields, got, want):
            gate(a.shape == b.shape and torch.equal(
                a.view(torch.int32), b.view(torch.int32)),
                f"[draws] {runs} runs: {name} differs from the loop's")
        nominal = obs_mod.generate_nominal_trajectories(
            starts, directions, speeds, n_steps, params.dt)
        seeds_t = torch.tensor(seeds, dtype=torch.int64, device=dev)
        graph_ms, wrapper_ms, loop_ms = graph_and_wrapper_ms(
            pt, lambda: obs_mod.draw_runs_loop(*args),
            lambda: draws(nominal, seeds_t, params.num_samples,
                          params.noise_var), DRAWS["reps"])
        bound, by = pt.experiments.linalg_bench.roofline_ms(
            tensor_bytes(nominal, seeds_t, *got), 0)
        print(f"[draws] head_on, {runs} runs x {params.num_samples} samples "
              f"x {n_steps + 1} steps: one launch, nominal, samples and "
              f"realization bit-equal to the loop's; {graph_ms:.4f} ms as a "
              f"CUDA graph of launches ({wrapper_ms:.4f} ms launch by "
              f"launch), the loop {loop_ms:.2f} ms; bound {bound:.4f} ms by "
              f"{by} ({tensor_bytes(*got) / 1e6:.2f} MB written)")
        if entry is None:
            entry = dict(max_abs_err=0.0, ms=graph_ms, plain_ms=loop_ms,
                         bound_ms=bound, bound_by=by, library_ms=None,
                         wrapper_ms=wrapper_ms, runs=runs)
    return entry


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
    """Seeded scenarios: GPU float32 against CPU float64 and the oracle.
    Returns {name: (params, scenario, GPU run, oracle controls)} of the
    scenarios held to the oracle."""
    held = {}
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
            held[name] = (params, scenario, gpu, oracle)
        else:
            line += " (not gated)"
        print(line)
    return held


def path_kernels(pt):
    """The wrappers of kernels 1-3 and of the draw kernel, whose counters
    the paths are held to."""
    return (pt.ops.cuda_kernels.all_metrics_halfspaces,
            pt.ops.cuda_linalg.batched_cholesky,
            pt.ops.cuda_linalg.batched_cho_solve,
            pt.ops.cuda_draws.obstacle_draws)


def reset_launches(pt) -> None:
    for fn in path_kernels(pt):
        fn.launches = 0


def read_launches(pt) -> dict:
    return {fn.__name__: fn.launches for fn in path_kernels(pt)}


def gate_launched(pt, names, label) -> dict:
    """The counters since `reset_launches`: every kernel in `names`
    launched, every other kernel of the path did not."""
    launches = read_launches(pt)
    for name, count in launches.items():
        gate((count > 0) == (name in names),
             f"{label}: launches {launches}, expected only {sorted(names)}")
    return launches


LINALG = ("batched_cholesky", "batched_cho_solve")


def flat_qp_inputs(pt, torch, res, scenario):
    """The flat batch of S * 3 QPs the pipeline builds from a run (no
    padding: the run has a halfspace for every step of the horizon):
    (x0 [B, n], x_ref [B, H+1, n], hs_h [B, H, n_obs, 2], hs_g)."""
    S, H = res.x_ref.shape[0], res.u_ref.shape[1]
    hs_h = torch.stack([res.halfspaces.by_metric(m).h
                        for m in pt.models.METRICS], dim=1)
    hs_g = torch.stack([res.halfspaces.by_metric(m).g_tilde
                        for m in pt.models.METRICS], dim=1)
    gate(hs_h.shape[2] == H, "flat_qp_inputs: the run needs padding")
    x0 = torch.zeros((S, res.x_ref.shape[-1]), dtype=res.x_ref.dtype,
                     device=res.x_ref.device)
    x0[:, :2] = torch.as_tensor(scenario.ego_start, dtype=x0.dtype,
                                device=x0.device)
    return (x0.repeat_interleave(3, dim=0),
            res.x_ref.repeat_interleave(3, dim=0),
            hs_h.flatten(0, 1), hs_g.flatten(0, 1))


def box_bounds(pt, torch, dtype, device):
    """(u_min, u_max, p_min, p_max) as the pipeline passes them."""
    pipe = pt.models.pipeline
    return (*(torch.as_tensor(v, dtype=dtype, device=device)
              for v in pipe.INPUT_BOUNDS),
            *(torch.as_tensor(v[:2], dtype=dtype, device=device)
              for v in pipe.STATE_BOUNDS))


def timed_ms(torch, fn):
    """(result, wall ms by the host clock around a synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_filter(pt, torch, dev, held, card):
    """`filter_trajectory`, `filter_core_batched` and the warm start, in
    float32 on the card, on the seeded multi_obstacle scenario of phase 4
    (H = 30, seed-42 streams) and on the batch run's QPs (N = 1000)."""
    pipe = pt.models.pipeline
    params, scenario, run, oracle = held["multi_obstacle"]
    f32, f64 = torch.float32, torch.float64
    mpc = pt.models.make_statics(scenario, params, f32, dev).mpc
    mpc64 = pt.models.make_statics(scenario, params, f64, "cpu").mpc
    H = params.horizon
    x0, x_ref, hs_h, hs_g = flat_qp_inputs(pt, torch, run, scenario)
    u_ref = run.u_ref.repeat_interleave(3, dim=0)
    bounds = dict(input_bounds=pipe.INPUT_BOUNDS,
                  position_bounds=pipe.STATE_BOUNDS)

    # One call per metric, as a user makes it, and the three as a batch
    # (the pipeline's own batch, so the same arithmetic lane by lane).
    reset_launches(pt)
    worst_oracle = worst_single = 0.0
    for mi, m in enumerate(pt.models.METRICS):
        res = pt.filter_trajectory(mpc, x0[mi], x_ref[mi], u_ref[mi],
                                   hs_h[mi], hs_g[mi], **bounds, device=dev)
        gate(res.u_filtered.shape == (H, 2) and res.x_filtered.shape
             == (H + 1, 4), f"filter {m}: shapes")
        gate(bool(torch.isfinite(res.x_filtered).all()),
             f"filter {m}: not finite")
        gate(bool(res.status) and not bool(res.used_fallback),
             f"filter {m}: not converged")
        off = float(np.abs(res.u_filtered.cpu().double().numpy()
                           - oracle[m]).max())
        gate(off < ORACLE_TOL, f"filter {m}: controls {off:.3e} from the "
             "oracle")
        single = float((res.u_filtered - run.filtered_u[0, mi]).abs().max())
        gate(single < ORACLE_TOL, f"filter {m}: controls {single:.3e} from "
             "the pipeline's")
        worst_oracle, worst_single = max(worst_oracle, off), max(worst_single,
                                                                 single)
    batch = pt.filter_trajectory(mpc, x0, x_ref, u_ref, hs_h, hs_g, **bounds,
                                 device=dev)
    launches = gate_launched(pt, LINALG, "filter_trajectory")
    as_batch = float((batch.u_filtered - run.filtered_u[0]).abs().max())
    gate(as_batch <= 1e-6, f"filter: the three metrics as one batch are "
         f"{as_batch:.3e} from the pipeline's controls")
    gate(batch.qp_iterations.tolist() == run.qp_iterations[0].tolist(),
         "filter: iteration counts differ from the pipeline's")
    print(f"[filter] filter_trajectory, multi_obstacle (H = {H}, seed-42 "
          f"streams), float32 on the card: |u - u_oracle| {worst_oracle:.3e} "
          f"(gate {ORACLE_TOL}); |u - u_pipeline| {as_batch:.3e} with the "
          f"three metrics as one batch (gate 1e-6), {worst_single:.3e} a "
          f"metric a call; launches {launches}")

    # Forced non-convergence: the shifted previous sequence, or u_ref.
    gen = torch.Generator(device=dev).manual_seed(3)
    last = torch.randn(3, H, 2, generator=gen, dtype=f32, device=dev)
    fb = pt.filter_trajectory(mpc, x0, x_ref, u_ref, hs_h, hs_g, **bounds,
                              last_optimal_u=last, has_last=True, max_iters=1,
                              device=dev)
    gate(bool(fb.used_fallback.all()) and not bool(fb.status.any()),
         "fallback: max_iters=1 converged")
    gate(torch.equal(fb.u_filtered,
                     torch.cat([last[:, 1:], u_ref[:, H - 1:H]], dim=1)),
         "fallback: not the shifted previous sequence")
    fb = pt.filter_trajectory(mpc, x0, x_ref, u_ref, hs_h, hs_g, **bounds,
                              max_iters=1, device=dev)
    gate(bool(fb.used_fallback.all()), "fallback: max_iters=1 converged")
    gate(torch.equal(fb.u_filtered, u_ref), "fallback: not u_ref")
    gate(bool(torch.isfinite(fb.x_filtered).all()), "fallback: rollout")
    print("[filter] max_iters=1: used_fallback on every lane; controls equal "
          "the shifted previous sequence with last_optimal_u, u_ref without")

    # Bounds dropped: the dense operators, then no box rows at all.  Held
    # at a float32 tolerance of 1e-5: at the default 3e-5 a lane can stop
    # one iteration earlier with an iterate whose polish is rejected, and
    # then sits ~1e-2 from float64 (the JAX package in float32 does the
    # same on the same inputs); that reading is printed, not gated.
    host = [t.cpu().double() for t in (x0, x_ref, u_ref, hs_h, hs_g)]
    for label, kept in (("input_bounds=None",
                         dict(position_bounds=pipe.STATE_BOUNDS)),
                        ("no bounds", {})):
        ref = pt.filter_trajectory(mpc64, *host, **kept, device="cpu")
        gate(bool(ref.status.all()), f"{label}: CPU float64 not converged")
        offs = {}
        for tol in (None, 1e-5):
            reset_launches(pt)
            res = pt.filter_trajectory(mpc, x0, x_ref, u_ref, hs_h, hs_g,
                                       **kept, tol=tol, device=dev)
            gate_launched(pt, LINALG, label)
            gate(bool(torch.isfinite(res.u_filtered).all()),
                 f"{label}: not finite")
            gate(bool(res.status.all()), f"{label}: not converged")
            offs[tol] = float((res.u_filtered.cpu().double()
                               - ref.u_filtered).abs().max())
        gate(offs[1e-5] < ORACLE_TOL,
             f"{label}: {offs[1e-5]:.3e} from CPU float64")
        print(f"[filter] {label}: converged, |u - u_cpu_f64| {offs[1e-5]:.3e} "
              f"at tol 1e-5 (gate {ORACLE_TOL}), {offs[None]:.3e} at the "
              f"default tol 3e-5 (not gated); |u| up to "
              f"{float(ref.u_filtered.abs().max()):.2f}")

    # The warm start: the solution of a perturbed problem (offsets moved
    # by 0.05) as the start of the original.
    core = pt.models.mpc_filter._filter_core
    box = box_bounds(pt, torch, f32, dev)
    cold = core(mpc, x0, x_ref, hs_h, hs_g, *box, 60, None)
    near = core(mpc, x0, x_ref, hs_h, hs_g + 0.05, *box, 60, None)[2]
    warm = core(mpc, x0, x_ref, hs_h, hs_g, *box, 60, None,
                warm=(near.u, near.s, *near.mults))
    gate(bool(cold[2].converged.all()) and bool(warm[2].converged.all()),
         "warm: not converged")
    off = float((warm[0] - cold[0]).abs().max())
    gate(off < ORACLE_TOL, f"warm: {off:.3e} from the cold optimum")
    it_cold, it_warm = (s.iterations.tolist() for s in (cold[2], warm[2]))
    gate(all(w <= c for w, c in zip(it_warm, it_cold)),
         f"warm: iterations {it_warm} above the cold solve's {it_cold}")
    print(f"[warm] solve_mpc_qp(warm=...) from the solution of the problem "
          f"with offsets + 0.05: |u_warm - u_cold| {off:.3e} (gate "
          f"{ORACLE_TOL}), iterations {it_warm} against cold {it_cold}")

    # filter_core_batched: three batch runs from shifted seeds give
    # 2,304 QPs at N = 1000; the first 2,048 in chunks of 512 against one
    # flat call.  In float64 the two agree lane by lane (1e-9, equal
    # iteration counts).  In float32 they cannot be held to that on the
    # card: cuBLAS picks its kernel from the batch size, so a lane's
    # products round otherwise at 512 than at 2,048, and a lane that
    # stops on an iterate whose polish is rejected then lands ~1e-2 away
    # (both answers converged).  There the chunked call is held, bit for
    # bit, to its chunks solved on their own, and its distance from the
    # flat call is printed.
    b_params, b_scenario, b_statics = batch_setup(pt, torch, dev)
    parts = []
    for shift in range(3):
        res = run_batch(pt, torch, dev, b_params, b_scenario, b_statics,
                        seed=BATCH["seed"] + shift)
        parts.append(flat_qp_inputs(pt, torch, res, b_scenario))
        del res
    n_qp, chunk = CHUNKED["qps"], CHUNKED["chunk"]
    gate(sum(p[0].shape[0] for p in parts) >= n_qp, "chunked: too few QPs")
    data = tuple(torch.cat(ts)[:n_qp] for ts in zip(*parts))
    del parts
    args = (b_statics.mpc, *data, *box, BATCH["qp_iters"], BATCH["qp_tol"])
    core(*args)                                      # warm-up
    reset_launches(pt)
    flat, flat_ms = timed_ms(torch, lambda: core(*args))
    flat_launches = gate_launched(pt, LINALG, "flat solve")
    reset_launches(pt)
    chunked, chunk_ms = timed_ms(
        torch, lambda: pt.filter_core_batched(*args, chunk=chunk))
    chunk_launches = gate_launched(pt, LINALG, "filter_core_batched")
    gate(bool(flat[2].converged.all()) and bool(chunked[2].converged.all()),
         "filter_core_batched: not converged")
    gate(chunked[0].shape == flat[0].shape
         and chunked[2].mults[0].shape == flat[2].mults[0].shape,
         "filter_core_batched: shapes")
    for i in range(0, n_qp, chunk):
        own = core(b_statics.mpc, *(t[i:i + chunk] for t in data), *box,
                   BATCH["qp_iters"], BATCH["qp_tol"])
        gate(torch.equal(own[0], chunked[0][i:i + chunk])
             and torch.equal(own[3], chunked[3][i:i + chunk])
             and torch.equal(own[2].iterations,
                             chunked[2].iterations[i:i + chunk]),
             f"filter_core_batched: chunk at {i} differs from its own solve")
    off = (chunked[0] - flat[0]).abs().amax((1, 2))
    moved = int((chunked[2].iterations != flat[2].iterations).sum())
    per_chunk = [int(chunked[2].iterations[i:i + chunk].max())
                 for i in range(0, n_qp, chunk)]
    print(f"[filter] filter_core_batched, {n_qp} QPs (multi_obstacle, N = "
          f"{b_params.num_samples}), chunk={chunk}, float32: every lane "
          f"converged; each chunk bit-equal to its own flat solve; against "
          f"ONE flat call (not gated: cuBLAS rounds by batch size) "
          f"{int((off <= 1e-6).sum())} lanes within 1e-6, "
          f"{int((off <= ORACLE_TOL).sum())} within {ORACLE_TOL}, max "
          f"{float(off.max()):.3e}, iterations differ on {moved} lanes (max "
          f"{int(flat[2].iterations.max())} flat, per chunk {per_chunk}); "
          f"wall {chunk_ms:.1f} ms in chunks, {flat_ms:.1f} ms flat (host "
          f"clock, not gated) on {card}; launches {chunk_launches} in "
          f"chunks, {flat_launches} flat")
    mpc64 = pt.models.make_statics(b_scenario, b_params, f64, dev).mpc
    args64 = (mpc64, *(t.double() for t in data),
              *box_bounds(pt, torch, f64, dev), 60, None)
    reset_launches(pt)
    flat64, flat64_ms = timed_ms(torch, lambda: core(*args64))
    chunked64, chunk64_ms = timed_ms(
        torch, lambda: pt.filter_core_batched(*args64, chunk=chunk))
    gate_launched(pt, (), "filter_core_batched float64")
    gate(torch.equal(chunked64[2].converged, flat64[2].converged),
         "filter_core_batched float64: converged flags differ")
    off64 = float((chunked64[0] - flat64[0]).abs().max())
    gate(off64 <= 1e-9, f"filter_core_batched float64: controls {off64:.3e} "
         "from the flat call's")
    gate(torch.equal(chunked64[2].iterations, flat64[2].iterations),
         "filter_core_batched float64: per-lane iterations differ from the "
         "flat call's")
    print(f"[filter] filter_core_batched, the same {n_qp} QPs in float64 on "
          f"the card (plain factorisations): chunk={chunk} against one flat "
          f"call, controls within {off64:.3e} (gate 1e-9), per-lane "
          f"iterations and converged flags equal (max "
          f"{int(flat64[2].iterations.max())}, converged "
          f"{float(flat64[2].converged.float().mean()):.4f} at tol 1e-9); wall "
          f"{chunk64_ms:.1f} ms in chunks, {flat64_ms:.1f} ms flat")


@contextlib.contextmanager
def count_linalg_systems(pt):
    """Counts, while the block runs, the solver's factorisations and
    solves by (function, n, right-hand sides): which went to the kernel
    wrappers and which to the plain versions.  The solver's cached graphs
    are dropped on the way in and out: they call the names bound when
    they were captured."""
    qp = pt.ops.qp_ipm_structured
    names = ("batched_cholesky", "batched_cholesky_plain",
             "batched_cho_solve", "batched_cho_solve_plain")
    real = {name: getattr(qp, name) for name in names}
    seen = collections.Counter()
    qp._GRAPHS.clear()

    def spy(name):
        def call(*args):
            k = (1 if "solve" not in name or args[1].dim() == 2
                 else args[1].shape[-1])
            seen[name, args[0].shape[-1], k] += 1
            return real[name](*args)
        return call

    for name in names:
        setattr(qp, name, spy(name))
    try:
        yield seen
    finally:
        for name in names:
            setattr(qp, name, real[name])
        qp._GRAPHS.clear()


def phase_beyond_kernels(pt, torch, dev, streams, card):
    """float64, rows of more than 49,152 samples and horizons above 30 on
    the card: the call sites send them to the plain versions on the same
    device, the rest of each run still goes through the kernels."""
    f32, f64 = torch.float32, torch.float64

    def cpu_rerun(scenario, params, obstacles, qp_iters=60):
        return pt.models.run_scenario_with_obstacles(
            pt.models.make_statics(scenario, params, f64, "cpu"),
            pt.simulation.ObstacleData(*(t.cpu().double()
                                         for t in obstacles)),
            scenario.ego_start, scenario.ego_goal, params.ego_velocity,
            qp_iters)

    # float64 through the CLI, single and Monte Carlo mode.
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("multi_obstacle")
    argv = ["--scenario", "multi_obstacle", "--dtype", "float64", "--device",
            dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(pt)
        res = pt.cli.main(argv + ["--mode", "single", "--save_dir", tmp])
        gate_launched(pt, (), "cli --dtype float64 --mode single")
        gate(res.filtered_u.dtype == f64
             and res.filtered_u.device.type == dev.type,
             "f64 single: not float64 on the card")
        gate(bool(torch.isfinite(res.filtered_u).all()), "f64 single: finite")
        gate(bool(res.qp_converged.all()), "f64 single: not converged")
        cpu = cpu_rerun(scenario, params, res.obstacles)
        off = float((res.filtered_u.cpu() - cpu.filtered_u).abs().max())
        gate(off <= 1e-6, f"f64 single: controls {off:.3e} from CPU float64")

        n_runs = 8
        reset_launches(pt)
        mc = pt.cli.main(argv + ["--mode", "monte_carlo", "--mc_runs",
                                 str(n_runs), "--save_dir", tmp])
        gate_launched(pt, (), "cli --dtype float64 --mode monte_carlo")
    gate(mc.min_distances.dtype == f64
         and mc.min_distances.device.type == dev.type,
         "f64 monte_carlo: not float64 on the card")
    gate(bool(torch.isfinite(mc.min_distances).all()), "f64 monte_carlo")
    gate(bool(mc.qp_converged.all()), "f64 monte_carlo: not converged")
    mcm = pt.evaluation.monte_carlo
    obs = mcm.run_obstacles(
        pt.models.make_statics(scenario, params, f64, dev),
        mcm.run_seeds(42, n_runs), scenario, params,
        int(params.sim_time / params.dt))
    md_cpu, _ = mcm.reduce_runs(cpu_rerun(scenario, params, obs))
    off_mc = float((mc.min_distances.cpu() - md_cpu).abs().max())
    gate(off_mc <= 1e-6, f"f64 monte_carlo: min distances {off_mc:.3e} from "
         "CPU float64")
    print(f"[f64] cli --dtype float64 --device {dev.type}, multi_obstacle: single "
          f"converged, |u - u_cpu_f64| {off:.3e} (gate 1e-6); monte_carlo "
          f"{n_runs} runs converged, min distances within {off_mc:.3e} of "
          f"CPU float64 (gate 1e-6); launches {read_launches(pt)}: float64 "
          f"takes the closed forms and the plain factorisations on the card")

    # Rows past the block path, float32: one scenario, one obstacle, 8
    # steps.  49,153 and 100,000 samples take kernel 1's cluster path
    # (2 and 3 blocks a row) in one launch; 393,217, one more than the
    # cluster path takes, the closed forms with no launch.
    ck = pt.ops.cuda_kernels
    scenario = pt.config.get_scenario_config("head_on")
    n_steps = 7
    statics = pt.models.make_statics(scenario, params, f32, dev)
    env64 = pt.models.make_statics(scenario, params, f64, "cpu").env
    for n_big, launches in ((ck.BLOCK_MAX_N + 1, 1), (100_000, 1),
                            (ck.MAX_N_SAMPLES + 1, 0)):
        obs = pt.simulation.generate_obstacle_scenarios(
            torch.Generator(device=dev).manual_seed(5),
            *(torch.as_tensor(v, dtype=f32, device=dev)
              for v in (scenario.obstacle_starts, scenario.obstacle_directions,
                        scenario.obstacle_speeds)),
            n_steps, params.dt, n_big, params.noise_var, 1)
        x_ref = pt.models.straight_line_trajectory(
            statics.planner, *(torch.as_tensor(v, dtype=f32, device=dev)[None]
                               for v in (scenario.ego_start, scenario.ego_goal)),
            params.ego_velocity)[0]
        reset_launches(pt)
        hs = pt.simulation.compute_safe_halfspaces_for_trajectory(
            statics.env, obs.samples, x_ref)
        torch.cuda.synchronize()
        got = gate_launched(pt, ("all_metrics_halfspaces",) if launches else (),
                            f"N = {n_big}")
        gate(got["all_metrics_halfspaces"] == launches,
             f"N = {n_big}: launches {got}, expected {launches} of kernel 1")
        ref = pt.simulation.compute_safe_halfspaces_for_trajectory(
            env64, obs.samples.cpu().double(), x_ref.cpu().double())
        gate(hs.mean.h.shape == (1, n_steps + 1, 1, 2), f"N = {n_big}: shape")
        err = 0.0
        for m in pt.models.METRICS:
            ours, want = hs.by_metric(m), ref.by_metric(m)
            err = max(err, check_hg((ours.h.cpu().double(),
                                     ours.g_tilde.cpu().double()),
                                    (want.h, want.g_tilde), f"N = {n_big} {m}"))
        path = (f"kernel 1's cluster path ({ck.halfspace_plan(1, n_big, True).cluster} "
                f"blocks a row), {launches} launch" if launches
                else "the closed forms, no kernel launch")
        print(f"[bigN] N = {n_big} samples a row (1 obstacle, {n_steps + 1} "
              f"steps), float32 on the card: {path}; max abs err {err:.3e} "
              f"from CPU float64 (h {H_TOL}, g {G_ATOL} + {G_RTOL} rel)")
        del obs, hs, ref

    # Horizons 31 and 40 in float32 at N = 1000.  head_on on the seed-42
    # streams is held to CPU float64 at the oracle's tolerance.
    # multi_obstacle through `run_single_scenario` is held to everything
    # but that: in float32 its QPs can stop on an iterate whose polish is
    # rejected, at any horizon (30 too), and then sit ~1e-2 from float64
    # at merit < 10 tol, as the JAX package's do; its distance is printed.
    base = pt.config.get_parameters("custom")
    for name, horizon in (("head_on", 31), ("head_on", 40),
                          ("multi_obstacle", 31), ("multi_obstacle", 40)):
        scenario = pt.config.get_scenario_config(name)
        params = dataclasses.replace(
            base, horizon=horizon, num_samples=BATCH["n_samples"],
            sim_time=(horizon + 0.5) * base.dt)
        gated = name == "head_on"
        reset_launches(pt)
        with count_linalg_systems(pt) as seen:
            if gated:
                obs = streams.reference_rng_obstacles(
                    scenario, params.sim_time, params.dt, params.num_samples)
                res = pt.models.run_scenario_with_obstacles(
                    pt.models.make_statics(scenario, params, f32, dev),
                    pt.convert.obstacle_data(obs, f32, dev, True),
                    scenario.ego_start, scenario.ego_goal,
                    params.ego_velocity)
            else:
                res = pt.models.run_single_scenario(
                    scenario, params, seed=42, dtype=f32, device=dev)
        n, k_sel = 2 * horizon, 2 * horizon + 4
        to_kernel = {key for key in seen if not key[0].endswith("_plain")}
        for fn_name, size, k in seen:
            gate(fn_name.endswith("_plain") == (size > 64),
                 f"H = {horizon}: {fn_name} took a system of size {size}")
        gate({key[1] for key in seen} == {n, k_sel}, f"H = {horizon}: sizes")
        gate_launched(pt, ("all_metrics_halfspaces",) + (LINALG if n <= 64
                                                         else ()),
                      f"{name} H = {horizon}")
        gate(res.filtered_u.shape == (1, 3, horizon, 2), "longH: shape")
        gate(bool(torch.isfinite(res.filtered_u).all()), "longH: finite")
        gate(bool(res.qp_converged.all()),
             f"{name} H = {horizon}: not converged")
        cpu = cpu_rerun(scenario, params, res.obstacles)
        off = float((res.filtered_u.cpu().double() - cpu.filtered_u)
                    .abs().max())
        if gated:
            gate(off < ORACLE_TOL, f"{name} H = {horizon}: controls "
                 f"{off:.3e} from CPU float64")
        systems = ", ".join(
            f"{fn_name} n={size} k={k} x{count}"
            for (fn_name, size, k), count in sorted(seen.items()))
        print(f"[longH] {name}, horizon {horizon} (n = {n}, the polish's "
              f"second system {k_sel} wide), N = {params.num_samples}, "
              f"float32 on the card: converged, IPM iterations "
              f"{res.qp_iterations[0].tolist()}, |u - u_cpu_f64| {off:.3e} "
              f"({'gate ' + str(ORACLE_TOL) if gated else 'not gated'}); "
              f"{len(to_kernel)} of {len(seen)} kinds of system to the "
              f"kernels: {systems}; launches {read_launches(pt)}")


def batch_setup(pt, torch, dev):
    params = dataclasses.replace(pt.config.get_parameters("custom"),
                                 num_samples=BATCH["n_samples"],
                                 sim_time=BATCH["sim_time"])
    scenario = pt.config.get_scenario_config("multi_obstacle")
    statics = pt.models.make_statics(scenario, params, torch.float32, dev)
    return params, scenario, statics


def run_batch(pt, torch, dev, params, scenario, statics, seed=BATCH["seed"]):
    gen = torch.Generator(device=dev).manual_seed(seed)
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
    argv = ["--mode", "monte_carlo", "--mc_runs", str(MC["runs"]),
            "--device", "cuda"]
    runs, walls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            reset_launches(pt)
            t0 = time.perf_counter()
            res = pt.cli.main(argv + ["--save_dir", tmp])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = read_launches(pt)
            gate(min(launches.values()) > 0,
                 f"monte_carlo: a kernel never launched: {launches}")
            gate(launches["obstacle_draws"] == 1, f"monte_carlo: "
                 f"{MC['runs']} runs in one chunk, launches {launches}")
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
    return first, launches["obstacle_draws"]


def mesh_ranks(rank, world):
    """Body of each of phase 9's two spawned ranks, which share cuda:0
    over Gloo (NCCL refuses two ranks on one card): Monte Carlo at
    data = 2 with its checks, then the sample-parallel solve at
    samples = 2.  Returns plain numbers for the parent to gate."""
    import torch

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pt.models.pipeline.pin_matmul_precision(dev)
    par, mc = pt.parallel, pt.evaluation.monte_carlo
    params = pt.config.get_parameters("custom")
    scenario = pt.config.get_scenario_config("head_on")
    n_steps = int(params.sim_time / params.dt)

    def monte_carlo(n_runs, dtype, mesh=None):
        return mc.run_monte_carlo_simulation(scenario, params, n_runs=n_runs,
                                             seed=42, dtype=dtype,
                                             device=dev, mesh=mesh)

    out = {}
    mesh = par.make_mesh(2, 1, device=dev)
    monte_carlo(MESH["runs"], torch.float32, mesh)       # warm-up
    reset_launches(pt)
    par.CENSUS.clear()
    split, wall = timed_ms(torch, lambda: monte_carlo(
        MESH["runs"], torch.float32, mesh))
    out["wall_ms"], out["launches"] = wall, read_launches(pt)
    out["collectives"] = sum(par.CENSUS.values())
    # This rank's block, solved alone as one batch of the same size.
    b = MESH["runs"] // world
    rows = slice(rank * b, (rank + 1) * b)
    statics = pt.models.make_statics(scenario, params, torch.float32, dev)
    alone = pt.models.run_scenario_with_obstacles(
        statics, mc.run_obstacles(statics, mc.run_seeds(42, MESH["runs"])[rows],
                                  scenario, params, n_steps),
        scenario.ego_start, scenario.ego_goal, params.ego_velocity)
    md, conv = mc.reduce_runs(alone)
    out["block_equal"] = (torch.equal(split.min_distances[rows], md)
                          and torch.equal(split.qp_converged[rows], conv))
    flat = monte_carlo(MESH["runs"], torch.float32)
    out["f32_vs_flat"] = float((split.min_distances - flat.min_distances)
                               .abs().max())
    out["f32_probs_equal"] = torch.equal(split.collision_probs,
                                         flat.collision_probs)
    out["f64_vs_flat"] = float(
        (monte_carlo(MESH["f64_runs"], torch.float64, mesh).min_distances
         - monte_carlo(MESH["f64_runs"], torch.float64).min_distances)
        .abs().max())
    out["probs"] = split.collision_probs.tolist()

    # Sample-parallel: each rank holds the whole [B, N, 2] (the host
    # value) and solves its half of N.
    mesh_s = par.make_mesh(1, 2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SAMPLE_PAR["seed"])
    rows_n, n = SAMPLE_PAR["rows"], SAMPLE_PAR["n"]
    samples = (torch.tensor([0.5, 0.0], device=dev)
               + 0.1 * torch.randn(rows_n, n, 2, device=dev, generator=gen))
    h = torch.nn.functional.normalize(
        torch.randn(rows_n, 2, device=dev, generator=gen), dim=-1)
    par.CENSUS.clear()
    (g, rounds), wall = timed_ms(torch, lambda: par.dr_cvar_g_sample_parallel(
        mesh_s, samples, h, *ARGS, return_rounds=True))
    out["sp"] = dict(wall_ms=wall, rounds=rounds,
                     collectives=sum(par.CENSUS.values()),
                     mb=samples.numel() * 4 / 1e6)
    g_ref, _ = pt.ops.dr_cvar_g_star(samples.double(), h.double(), *ARGS)
    out["sp"]["rel"] = float(((g.double() - g_ref).abs() / g_ref.abs()).max())
    k = max(min(int(np.ceil(ARGS[0] * n - 1e-12)), n), 1)
    half = n // 2
    x_local = -pt.ops.halfspace._project(
        samples[:, rank * half:(rank + 1) * half], h)
    v, _, _ = par.sample_parallel.distributed_kth_largest(x_local, k, n,
                                                          mesh_s)
    x = (-pt.ops.halfspace._project(samples, h)).to(torch.float32)
    out["sp"]["kth_equal"] = torch.equal(
        v, torch.kthvalue(x, n - k + 1, dim=-1).values)
    return out


def phase_mesh(pt, torch, dev, card, mc_plain):
    """9a. parallel/ on the card: the CLI's --mesh data=1 in this process
    (NCCL), the timing sweep's files with and without it, then two
    spawned ranks on cuda:0 (Gloo)."""
    import torch.distributed as dist
    import torch_parallel_worker as workers

    argv = ["--mode", "monte_carlo", "--mc_runs", str(MC["runs"]),
            "--device", "cuda", "--mesh", "data=1"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(pt)
        pt.parallel.CENSUS.clear()
        res, wall = timed_ms(torch, lambda: pt.cli.main(argv + ["--save_dir",
                                                              tmp]))
        launches, census = read_launches(pt), dict(pt.parallel.CENSUS)
    gate(not dist.is_initialized(), "--mesh data=1: the CLI left its "
         "process group open")
    gate(min(launches.values()) > 0,
         f"--mesh data=1: a kernel never launched: {launches}")
    gate(sum(census.values()) == 1,
         f"--mesh data=1: collectives {census}, expected one gather")
    gate(torch.equal(res.min_distances, mc_plain.min_distances)
         and torch.equal(res.qp_converged, mc_plain.qp_converged),
         "--mesh data=1: Monte Carlo differs from phase 8's meshless run")
    probe = pt.parallel.make_mesh(1, device=dev)
    backend = dist.get_backend()
    probe.close()
    gate(backend == "nccl", f"--mesh data=1 on the card: backend {backend}")
    print(f"[mesh] cli --mode monte_carlo --mc_runs {MC['runs']} --mesh data=1 "
          f"--device cuda in this process ({backend}, a world of one): "
          f"equal to phase 8's meshless run; collectives {census}; launches "
          f"{launches}; wall {wall:.1f} ms (CLI, host clock, save included) "
          f"on {card}")

    for extra in ([], ["--mesh", "data=1"]):
        with tempfile.TemporaryDirectory() as tmp:
            pt.cli.main(TIMING_CLI + extra + ["--save_dir", tmp])
            files = sorted(p.name for p in Path(tmp).iterdir())
        gate({"timing_comparison.csv", "timing_data.txt"} <= set(files),
             f"timing_analysis {extra}: wrote {files}")
        print(f"[mesh] cli --mode timing_analysis {' '.join(extra) or '(no mesh)'}"
              f" --save_dir: wrote {', '.join(files)}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = workers.run_cluster(2, mesh_ranks, store_dir=tmp,
                                    timeout=MESH["timeout"])
        spawn_s = time.perf_counter() - t0
    half = MESH["runs"] // 2
    for rank, out in enumerate(ranks):
        gate(min(out["launches"].values()) > 0,
             f"rank {rank}: a kernel never launched: {out['launches']}")
        gate(out["collectives"] == 1,
             f"rank {rank}: {out['collectives']} collectives, expected 1")
        gate(out["block_equal"], f"rank {rank}: its {half} runs differ from "
             "the same runs solved alone")
        gate(out["f64_vs_flat"] < MESH["f64_tol"],
             f"rank {rank}: float64 split {out['f64_vs_flat']:.3e} from flat")
        sp = out["sp"]
        gate(sp["rel"] < SAMPLE_PAR["rtol"],
             f"rank {rank}: sample-parallel g {sp['rel']:.3e} from float64")
        gate(sp["kth_equal"], f"rank {rank}: the k-th value differs from "
             "torch.kthvalue")
        gate(sp["collectives"] == sp["rounds"] + 4,
             f"rank {rank}: {sp['collectives']} collectives for "
             f"{sp['rounds']} rounds")
    r0 = ranks[0]
    print(f"[mesh] 2 spawned ranks on cuda:0 over Gloo ({spawn_s:.1f} s with "
          f"start-up): Monte Carlo {MC['runs']} runs at data = 2, launches "
          f"{[r['launches'] for r in ranks]}, one collective a rank; each "
          f"block of {half} runs equal to the same runs solved alone; wall "
          f"{r0['wall_ms']:.1f} / {ranks[1]['wall_ms']:.1f} ms a rank on {card}")
    print(f"[mesh] float64, {MESH['f64_runs']} runs: split "
          f"{max(r['f64_vs_flat'] for r in ranks):.3e} from flat (gate "
          f"{MESH['f64_tol']}); float32, {MESH['runs']} runs: split "
          f"{r0['f32_vs_flat']:.3e} from flat (not gated: cuBLAS rounds a "
          f"lane's products by the batch size), collision probabilities "
          f"{'equal' if r0['f32_probs_equal'] else 'differ'} "
          f"({', '.join(f'{p:.3f}' for p in r0['probs'])})")
    sp = r0["sp"]
    print(f"[sample_parallel] {SAMPLE_PAR['rows']} rows x {SAMPLE_PAR['n']} "
          f"samples ({sp['mb']:.0f} MB float32) at samples = 2 on cuda:0 "
          f"over Gloo: g {max(r['sp']['rel'] for r in ranks):.3e} relative "
          f"from dr_cvar_g_star in float64 on the card (gate "
          f"{SAMPLE_PAR['rtol']}); the k-th value bit-equal to "
          f"torch.kthvalue; {sp['rounds']} rounds, {sp['collectives']} "
          f"collectives; wall {sp['wall_ms']:.1f} / "
          f"{ranks[1]['sp']['wall_ms']:.1f} ms a rank on {card}")


def qp_merit64(P, q, G, h, z, lam):
    """The generic IPM's scaled KKT merit of (z, lam), evaluated in
    float64 with the true slacks h - Gz (the solver's own merit uses its
    slack iterate): (mu + violation + dual residual) / max(max|q|, 1) in
    the row-equilibrated geometry; and the duality gap f(z) - d(lam),
    which bounds f(z) - f* from above; and |lam| times the largest
    violation, which bounds f* - f(z) (z may violate by rounding)."""
    rs = np.maximum(np.abs(G).max(-1), 1e-8)
    Gs, hs, ls = G / rs[..., None], h / rs, lam * rs
    slack = hs - np.einsum("bmn,bn->bm", Gs, z)
    r = np.einsum("bij,bj->bi", P, z) + q + np.einsum("bmn,bm->bn", Gs, ls)
    merit = (((ls * np.maximum(slack, 0)).sum(-1) / G.shape[1]
              + np.maximum(-slack, 0).max(-1) + np.abs(r).max(-1))
             / np.maximum(np.abs(q).max(-1), 1.0))
    gap = (ls * slack).sum(-1) + 0.5 * np.einsum(
        "bi,bi->b", r, np.linalg.solve(P, r[..., None])[..., 0])
    excess = np.maximum(-slack, 0).max(-1) * np.abs(ls).sum(-1)
    return merit, gap, excess


def phase_generic_qp(pt, torch, dev, card) -> dict:
    """9b. The generic IPM (`solve_qp_batched`) and `plan_trajectory` on
    the card; both reach kernels 2 and 3.  Returns their launches."""
    from scipy.optimize import minimize

    rng = np.random.default_rng(QP["seed"])
    B, n, m = QP["batch"], QP["n"], QP["m"]
    L = rng.normal(size=(B, n, n))
    P = L @ L.transpose(0, 2, 1) + np.eye(n)
    q = rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n))
    h = rng.uniform(0.1, 2.0, size=(B, m))
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (P, q, G, h)]
    pt.ops.solve_qp_batched(*args)                        # warm-up
    reset_launches(pt)
    sol, wall = timed_ms(torch, lambda: pt.ops.solve_qp_batched(*args))
    qp_launches = gate_launched(pt, LINALG, "solve_qp_batched")
    ref = pt.ops.solve_qp_batched(*(torch.as_tensor(a) for a in (P, q, G, h)))
    conv = sol.converged.cpu().numpy()
    gate(conv.mean() > 0.95, f"solve_qp_batched: converged {conv.mean():.4f}")
    z, lam = (t.cpu().double().numpy() for t in (sol.z, sol.lam))
    merit, gap, excess = qp_merit64(P, q, G, h, z, lam)
    # The solver accepts on its float32 merit; evaluated again in float64
    # it moves by that evaluation's rounding (CPU float32: median 0.24%,
    # at most 6.2% on these lanes), hence the allowance.
    limit = 10 * QP["tol"] * QP["merit_rounding"]
    gate(merit[conv].max() < limit, f"solve_qp_batched: float64 merit "
         f"{merit[conv].max():.3e} of a converged lane (limit {limit:.3e})")
    # The objective: 1e-4 relative is below the float32 solver's floor (a
    # merit of 1e-5 leaves a duality gap of ~1e-3 relative); what holds is
    # that the float64 optimum lies within the card's own bracket
    # f(z) - gap <= f* <= f(z) + |lam| viol.
    f32 = 0.5 * np.einsum("bi,bij,bj->b", z, P, z) + (q * z).sum(-1)
    f64 = ref.obj.numpy()
    both = conv & ref.converged.numpy()
    slack = 1e-9 * np.abs(f64)
    inside = ((f64 >= f32 - gap - slack)
              & (f64 <= f32 + excess + slack))[both]
    gate(inside.all(), f"solve_qp_batched: {int((~inside).sum())} lanes whose "
         "float64 optimum lies outside their duality bracket")
    rel = np.abs(sol.obj.cpu().double().numpy() - f64) / np.abs(f64)
    z_dist = np.abs(z - ref.z.numpy())[both].max()
    print(f"[qp_ipm] solve_qp_batched, {B} seeded random QPs (n = {n}, m = {m},"
          f" float32) on the card: converged {conv.mean():.4f}, iterations "
          f"mean {sol.iterations.float().mean().item():.4f} max "
          f"{int(sol.iterations.max())}, wall {wall:.1f} ms on {card}; "
          f"launches {qp_launches}")
    print(f"[qp_ipm] converged lanes: float64 merit at most "
          f"{merit[conv].max():.3e} (10 tol = {10 * QP['tol']:.1e}); the CPU "
          f"float64 optimum inside every lane's duality bracket; objective "
          f"{rel[both].max():.3e} relative from CPU float64 at most "
          f"({int((rel[both] > 1e-4).sum())} of {int(both.sum())} lanes above "
          f"1e-4, not gated: the float32 floor), z {z_dist:.3e} (not gated)")

    dt, H = 0.2, 30
    A, Bm, C = pt.core.dynamics.create_double_integrator_matrices(
        dt, dtype=torch.float32, device=dev)
    planner = pt.models.Planner(A, Bm, C, 2.0, 1.0, H, dt)
    u_lim, x_lim = np.full(2, PLAN["u_lim"]), np.asarray(PLAN["x_lim"])
    bounds = dict(input_bounds=(-u_lim, u_lim), state_bounds=(-x_lim, x_lim),
                  has_bounds=True)
    reset_launches(pt)
    (x_ref, u_ref, info), wall = timed_ms(torch, lambda: pt.models
                                          .plan_trajectory(planner, PLAN["x0"],
                                                           PLAN["goal"],
                                                           **bounds))
    plan_launches = gate_launched(pt, LINALG, "plan_trajectory")
    gate(bool(info["converged"]), "plan_trajectory: not converged")
    # The scipy oracle on the same condensed QP (float64).
    Phi, Gam = (t.numpy() for t in pt.core.dynamics.condensed_dynamics(
        A.cpu().double(), Bm.cpu().double(), H))
    n_u = Gam.shape[1]
    Pq = 2 * (2.0 * Gam.T @ Gam + np.eye(n_u))
    px = Phi @ np.asarray(PLAN["x0"])
    qq = 4.0 * Gam.T @ (px - np.tile(PLAN["goal"], H))
    Gq = np.vstack([np.eye(n_u), -np.eye(n_u), Gam, -Gam])
    hq = np.concatenate([np.tile(u_lim, H), np.tile(u_lim, H),
                         np.tile(x_lim, H) - px, px + np.tile(x_lim, H)])
    oracle = minimize(lambda v: 0.5 * v @ Pq @ v + qq @ v, np.zeros(n_u),
                      jac=lambda v: Pq @ v + qq, method="SLSQP",
                      constraints=[{"type": "ineq", "fun": lambda v: hq - Gq @ v,
                                    "jac": lambda v: -Gq}],
                      options={"ftol": 1e-11, "maxiter": 1000})
    gate(oracle.success, f"planner oracle: {oracle.message}")
    u = u_ref.cpu().double().numpy().reshape(-1)
    obj = 0.5 * u @ Pq @ u + qq @ u
    obj_rel = abs(obj - oracle.fun) / abs(oracle.fun)
    viol = float((Gq @ u - hq).max())
    gate(obj_rel < PLAN["obj_rtol"], f"plan_trajectory: objective {obj_rel:.3e} "
         "relative from the oracle")
    gate(viol < PLAN["viol"], f"plan_trajectory: bounds violated by {viol:.3e}")
    x_dyn = float((x_ref[1:] - (x_ref[:-1] @ A.T + u_ref @ Bm.T)).abs().max())
    print(f"[planner] plan_trajectory with bounds, H = {H} (n_u = {n_u}, "
          f"{Gq.shape[0]} rows, float32) on the card: converged, objective "
          f"{obj_rel:.3e} relative from the scipy oracle (gate "
          f"{PLAN['obj_rtol']}), bounds violated by at most {max(viol, 0):.3e}, "
          f"u {np.abs(u - oracle.x).max():.3e} from the oracle (not gated), "
          f"dynamics residual {x_dyn:.1e}; launches {plan_launches}; wall "
          f"{wall:.1f} ms on {card}")
    return {name: {"qp_ipm": qp_launches[name], "planner": plan_launches[name]}
            for name in LINALG}


def batch_qps(pt, torch, res, scenario, dtype, dev):
    """The QPs of the batch run (768 = 256 scenarios x 3 metrics) as the
    filter assembles them, in `dtype` on `dev`: (the arguments it hands
    `solve_mpc_qp`, its keyword arguments).  The filter is stopped at
    that call: nothing is solved here."""
    class Captured(Exception):
        pass

    def capture(*args, **kwargs):
        raise Captured(args, kwargs)

    params = batch_setup(pt, torch, dev)[0]
    mpc = pt.models.make_statics(scenario, params, dtype, dev).mpc
    x0, x_ref, hs_h, hs_g = (t.to(dtype) for t in flat_qp_inputs(
        pt, torch, res, scenario))
    mf = pt.models.mpc_filter
    real, mf.solve_mpc_qp = mf.solve_mpc_qp, capture
    try:
        mf._filter_core(mpc, x0, x_ref, hs_h, hs_g,
                        *box_bounds(pt, torch, dtype, dev),
                        BATCH["qp_iters"], BATCH["qp_tol"])
    except Captured as got:
        return got.args
    finally:
        mf.solve_mpc_qp = real
    raise GateFailed("batch_qps: the filter never called solve_mpc_qp")


FUSED = ("ipm_residuals", "ipm_predictor", "ipm_step")
# The plain pass's spans whose kernels (less kernels 2 and 3) each fused
# kernel takes over: A the residuals (and the predictor's right-hand
# side, which the plain pass computes at the start of its first Newton
# span), B the rest of the first Newton span, C the second and the step.
FUSED_SPANS = {"ipm_residuals": (0,), "ipm_predictor": (2,),
               "ipm_step": (3, 4)}


def fused_work(B: int, n: int, hp: int, m2: int) -> dict:
    """(float32 operations, bytes) of each fused kernel on B stepping
    lanes: every input read once, every output written once (kernel A's
    best-iterate copy left out: the timed launches find no better
    merit)."""
    m1, nt = 2 * n + 2 * hp, hp + m2
    x = n + 2 * m1 + 5 * m2             # the iterate's eight vectors
    rows = hp * n + B * m2 * n          # T and each lane's A
    a_reads = rows + n * n + B * (x + n + m1 + 3 * m2 + 1)
    a_writes = B * (n * n + n + 2 * m1 + 7 * m2 + n)
    a_ops = B * (n * (n + 1) * nt + 2 * nt * n * 3 + 2 * n * n
                 + 30 * (m1 + m2))
    b_reads = rows + B * (n + 2 * m1 + 4 * m2 + 2 * m1 + 8 * m2 + n)
    b_writes = B * (m1 + 3 * m2 + n)
    b_ops = B * (2 * nt * n * 2 + 40 * (m1 + m2))
    c_reads = rows + B * (n + x + 3 * m1 + 8 * m2)
    c_ops = B * (2 * nt * n + 30 * (m1 + m2))
    return {"ipm_residuals": (a_ops, 4 * (a_reads + a_writes)),
            "ipm_predictor": (b_ops, 4 * (b_reads + b_writes)),
            "ipm_step": (c_ops, 4 * (c_reads + B * x))}


def plain_span_ms(pt, torch, d, spec, st) -> list:
    """Device ms of the plain pass's kernels under each of its five spans
    (residuals, factor, newton, newton, step), kernels 2 and 3 left out:
    one op-by-op pass under torch.profiler with the recorder on.  None
    where the profiler saw no device time."""
    qps, timing = pt.ops.qp_ipm_structured, pt.utils.timing
    skip = ("cholesky_kernel", "cho_solve")

    def device_us(e):
        own = sum(k.duration for k in e.kernels
                  if not any(s in k.name for s in skip))
        return own + sum(device_us(c) for c in e.cpu_children)

    warm, timed = st.dense(), st.dense()     # a pass writes its state
    qps._one_pass(d, spec, warm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    was = timing.record(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            qps._one_pass(d, spec, timed)
            torch.cuda.synchronize()
    finally:
        timing.record(was)
    spans = sorted((e for e in prof.events() if e.name in (
        "ipm.residuals", "ipm.factor", "ipm.newton", "ipm.step")),
        key=lambda e: e.time_range.start)
    ms = [device_us(e) / 1e3 for e in spans]
    return ms if len(ms) == 5 and sum(ms) > 0 else None


def replay_pass(torch, graphs, d, st):
    """(device ms by CUDA events, device operations the profiler sees) of
    one replay of a key's pass graph from the state `st`."""
    graphs.load(d, st)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graphs.pass_graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    graphs.load(d, st)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graphs.pass_graph.replay()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return ms, ops


def phase_fused_pass(pt, torch, dev, res, scenario) -> dict:
    """5b. The fused pass on the batch run's 768 QPs: one pass against the
    plain pass from the state after a first plain pass (flags equal,
    iterate within 1e-3 relative); each kernel as a CUDA graph of 50
    launches (the lanes' stall and iteration counts set far below their
    limits, so every timed launch does a stepping lane's work), its
    bound, and the plain pass's device time for its share of the pass;
    a pass's graph nodes and device time, fused and plain.  Returns the
    three kernels' entries of the record."""
    qps, ci, kb = (pt.ops.qp_ipm_structured, pt.ops.cuda_ipm,
                   pt.experiments.kbench)
    args, kwargs = batch_qps(pt, torch, res, scenario, torch.float32, dev)
    d, spec = qps._prepare(*args, kwargs["max_iters"], kwargs["tol"],
                           kwargs["box_theta"])
    gate(qps._pass_of(d) is qps._fused_pass,
         "fused pass: batch256's QPs not taken")
    st = qps._one_pass(d, spec, qps._start(d, spec, None).dense())
    gate(bool(st.active.all()), "fused pass: a lane stopped at pass 1")

    # One pass each way from copies of st.
    plain = qps._one_pass(d, spec, st.dense())
    dd = qps._Data(*qps._dense(d))
    fused = qps._fused_pass(dd, spec, st.dense())
    torch.cuda.synchronize()
    for name in ("done", "stall", "iters", "active"):
        gate(torch.equal(getattr(fused, name), getattr(plain, name)),
             f"fused pass: {name} differs from the plain pass")
    worst = max(rel_err(a, b) for a, b in zip(fused.x, plain.x))
    gate(worst < 1e-3, f"fused pass: iterate {worst:.3e} from the plain pass")

    # The kernels one by one, on copies whose lanes never stop: no merit
    # is better than -inf nor below a tolerance of -inf, and the stall and
    # iteration counts start far below their limits.
    ts = st.dense()
    ts.best_merit.fill_(float("-inf"))
    ts.stall.fill_(-10 ** 6)
    ts.iters.fill_(-10 ** 6)
    lanes = qps._lanes(dd, ts)
    never = float("-inf")
    S, rhs, work = ci.ipm_residuals(lanes, spec.reg, never, spec.max_iters)
    du = pt.ops.cuda_linalg.batched_cho_solve(
        pt.ops.cuda_linalg.batched_cholesky(S), rhs)
    rhs_c = rhs.clone()        # kernel B's output, written at each launch
    launch = {
        "ipm_residuals": lambda: ci.ipm_residuals(
            lanes, spec.reg, never, spec.max_iters),
        "ipm_predictor": lambda: ci.ipm_predictor(lanes, work, du, rhs_c),
        "ipm_step": lambda: ci.ipm_step(lanes, work, du)}
    B, n = d.q_u.shape
    hp, m2 = d.T.shape[0], d.b.shape[1]
    work_of = fused_work(B, n, hp, m2)
    spans = plain_span_ms(pt, torch, d, spec, st)
    entries = {}
    for name in FUSED:
        ms = (kb.graph_ms(launch[name]) + kb.graph_ms(launch[name])) / 2
        flops, nbytes = work_of[name]
        by_bytes, by_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
        bound = max(by_bytes, by_ops)
        plain_ms = (None if spans is None
                    else sum(spans[i] for i in FUSED_SPANS[name]))
        entries[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if by_bytes >= by_ops else "float32 operations",
            library_ms=None, max_abs_err=worst)
        print(f"[fused] {name} [{B} lanes, n {n}, hp {hp}, m2 {m2}]: "
              f"{ms:.4f} ms as a CUDA graph of launches; bound "
              f"{bound:.4f} ms by {entries[name]['bound_by']} "
              f"({bound / ms:.1%} of it reached); the plain pass's share "
              + ("not measured" if plain_ms is None
                 else f"{plain_ms:.4f} ms"))

    # A pass from st through each key's graphs: nodes and device time.
    qps._ipm_graphs(d, spec, None)
    real = qps.use_fused_pass
    qps.use_fused_pass = lambda *a: False
    try:
        qps._ipm_graphs(d, spec, None)
    finally:
        qps.use_fused_pass = real
    keys = {name: qps._graph_key(d, spec, step) for name, step in
            (("fused", qps._fused_pass), ("plain", qps._one_pass))}
    passes = {k: replay_pass(torch, qps._GRAPHS[key], d, st)
              for k, key in keys.items()}
    print(f"[fused] one pass of 768 lanes from a CUDA graph: fused "
          f"{passes['fused'][0]:.4f} ms, {passes['fused'][1]} device "
          f"operations; plain {passes['plain'][0]:.4f} ms, "
          f"{passes['plain'][1]} device operations (0: the profiler saw "
          f"none); one fused pass within {worst:.2e} of the plain pass, "
          f"flags equal")
    return entries


def phase_benches(pt, torch, dev, card) -> dict:
    """10a. qpbench's variants at batch 2048 (the bench shape).  Returns
    the launches of kernels 2 and 3."""
    import importlib

    qb = importlib.import_module(f"{PKG}.experiments.qpbench")
    qps = pt.ops.qp_ipm_structured
    names = ("_factor", "_solve", "_polish", "_select_rows",
             "POLISH_REFINEMENTS")
    before = {name: getattr(qps, name) for name in names}
    reset_launches(pt)
    runs = qb.run(QPBENCH["specs"], dev, QPBENCH["repeats"], QPBENCH["k"])
    launches = read_launches(pt)
    gate(all(getattr(qps, name) is before[name] for name in names),
         "[qpbench] a variant left the solver rebound")
    for spec, r in runs:
        gate(np.isfinite([r["ms"], r["ms_min"], r["ms_max"]]).all()
             and r["ms"] > 0, f"[qpbench] {spec['spec']}: time {r}")
        if spec["name"] in ("chol", "bt"):
            gate(r["converged"] > 0.9, f"[qpbench] {spec['spec']}: converged "
                 f"{r['converged']:.4f}")
        print(f"[qpbench] {qb.format_line(spec['spec'], r)}")
    gate(min(launches[name] for name in LINALG) > 0,
         f"[qpbench] kernels 2 and 3 never ran: {launches}")
    print(f"[qpbench] on {card}, {QPBENCH['repeats']} repeats of "
          f"{QPBENCH['k']} chained solves; launches {launches}")
    return launches


def phase_native(pt, torch, dev, res, scenario) -> None:
    """10b. The C++ host solver on the first QPs of the batch run against
    the card's float64 IPM, in the generic form z = [u; s].

    Both stop at float64's tolerance (merit 1e-9), which on these QPs
    leaves objectives up to 2.3e-7 relative and controls up to 7e-4
    apart (CPU float64, 96 such QPs: the interior-point answers violate
    rows by ~1e-8 where the polished one is exactly feasible, and P_uu's
    smallest eigenvalue turns a 1e-5 objective difference into 1e-3 in
    u).  So the objective and the feasibility are gated, the controls'
    distance printed."""
    nq = pt.ops.native_qp
    t0 = time.perf_counter()
    path = nq.build_library()
    build_s = time.perf_counter() - t0
    qp, kw = batch_qps(pt, torch, res, scenario, torch.float64, dev)
    k = NATIVE["qps"]
    P_uu, q_u, G_u, h1, A, b = (t.cpu() for t in qp[:6])
    card = pt.ops.qp_ipm_structured.solve_mpc_qp(
        qp[0], qp[1][:k], qp[2], qp[3][:k], qp[4][:k], qp[5][:k], *qp[6:],
        **{**kw, "tol": None, "max_iters": 60})
    gate(bool(card.converged.all()), "[native] the card's float64 IPM")
    f64 = torch.float64
    n, m1, m2 = P_uu.shape[0], G_u.shape[0], b.shape[1]
    rel = viol = u_dist = 0.0
    iters = []
    for i in range(k):
        P = torch.zeros(n + m2, n + m2, dtype=f64)
        P[:n, :n] = P_uu
        P[n:, n:] = qp[6] * torch.eye(m2, dtype=f64)
        q = torch.cat([q_u[i], torch.full((m2,), qp[7], dtype=f64)])
        G = torch.zeros(m1 + 2 * m2, n + m2, dtype=f64)
        G[:m1, :n] = G_u
        G[m1:m1 + m2, :n] = A[i]
        G[m1:, n:] = -torch.eye(m2, dtype=f64).repeat(2, 1)
        h = torch.cat([h1[i], b[i], torch.zeros(m2, dtype=f64)])
        sol = nq.solve_qp_native(P, q, G, h, max_iters=NATIVE["max_iters"])
        gate(sol.converged, f"[native] QP {i}: not converged in "
             f"{sol.iterations} iterations")
        z = torch.as_tensor(sol.z)
        z_card = torch.cat([card.u[i], card.s[i]]).cpu()
        f_native, f_card = (float(0.5 * v @ P @ v + q @ v)
                            for v in (z, z_card))
        rel = max(rel, abs(f_native - f_card) / abs(f_card))
        viol = max(viol, float((G @ z - h).max()))
        u_dist = max(u_dist, float((z[:n] - z_card[:n]).abs().max()))
        iters.append(sol.iterations)
    gate(rel <= NATIVE["obj_rtol"], f"[native] objectives {rel:.3e} "
         "relative from the card's float64 IPM")
    gate(viol <= NATIVE["viol"], f"[native] rows violated by {viol:.3e}")
    print(f"[native] {Path(path).parent.name}/{Path(path).name} built with "
          f"g++ in {build_s:.1f} s (0 = reused); {k} of the batch run's QPs "
          f"(n = {n + m2}, m = {m1 + 2 * m2}) on the host: converged in "
          f"{iters} iterations; objectives {rel:.3e} relative from the "
          f"card's float64 IPM (gate {NATIVE['obj_rtol']}), rows violated "
          f"by at most {viol:.3e} (gate {NATIVE['viol']}), controls "
          f"{u_dist:.3e} apart (not gated: both at float64's tolerance)")


def phase_scripts(pt, torch, dev, card) -> dict:
    """10c. One gallery scenario (custom head_on, --skip_animate) and both
    demos on the card, counts from 0 before each."""
    import importlib

    gallery = importlib.import_module(f"{PKG}.experiments.make_gallery")
    demos = [importlib.import_module(f"{PKG}.demos.{name}")
             for name in ("single_obstacle", "multi_obstacle")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(pt)
        res, wall = timed_ms(torch, lambda: gallery.run(
            skip_animate=True, device=dev.type, out=tmp,
            scenarios=("head_on",), presets=gallery.PRESETS[:1]))
        out["gallery"] = gate_launched(pt, ("all_metrics_halfspaces",)
                                       + LINALG, "[gallery]")
        (run,) = res.values()
        gate(bool(torch.isfinite(run.distances).all())
             and bool(run.qp_converged.all()), "[gallery] head_on")
        print(f"[gallery] custom/head_on through cli --mode single "
              f"--skip_animate --device {dev.type}: converged, min distances "
              f"{[round(float(d), 4) for d in run.distances[0].amin(-1)]}, "
              f"wall {wall:.1f} ms on {card}; launches {out['gallery']}")
        for demo in demos:
            name = demo.__name__.rsplit(".", 1)[1]
            reset_launches(pt)
            got, wall = timed_ms(torch, lambda demo=demo: demo.main(
                ["--device", dev.type, "--save_dir", tmp]))
            out[name] = gate_launched(pt, ("all_metrics_halfspaces",)
                                      + LINALG, f"[demo] {name}")
            values = ([v[0] for verdicts in got.values()
                       for v in verdicts.values()]
                      if isinstance(got, dict) else [got])
            gate(bool(np.isfinite(values).all()), f"[demo] {name}: {values}")
            print(f"[demo] {name} --device {dev.type}: min distances "
                  f"{[round(v, 4) for v in values]}, wall {wall:.1f} ms on "
                  f"{card}; launches {out[name]}")
    return out


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
    record["obstacle_draws"] = phase_draws(pt, torch, dev)

    # 4. Seeded end to end.
    held = phase_e2e(pt, torch, dev, streams)

    # 5. The batch run: a warm-up drive, then counters from 0 and one
    # measured drive of the main path.
    params, scenario, statics = batch_setup(pt, torch, dev)
    warm = run_batch(pt, torch, dev, params, scenario, statics)
    reset_launches(pt)
    fused_before = {name: getattr(pt.ops.cuda_ipm, name).launches
                    for name in FUSED}
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
    launches = read_launches(pt)
    launches.update({name: getattr(pt.ops.cuda_ipm, name).launches
                     - fused_before[name] for name in FUSED})
    gate(launches.pop("obstacle_draws") == 0,
         "batch: the draw kernel launched")
    gate(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    gate(len({launches[name] for name in FUSED}) == 1,
         f"the fused kernels launched unequally: {launches}")
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
    record.update(phase_fused_pass(pt, torch, dev, res, scenario))

    # 6. The single-scenario filter API; 7. what the kernels do not take.
    phase_filter(pt, torch, dev, held, card)
    phase_beyond_kernels(pt, torch, dev, streams, card)

    # 8. The entry points.
    mc_plain, launches["obstacle_draws"] = phase_entry_points(pt, torch,
                                                              dev, card)

    # 9. parallel/ (the mesh, the sample-parallel solve), the generic IPM
    # and the planner.
    phase_mesh(pt, torch, dev, card, mc_plain)
    new_paths = phase_generic_qp(pt, torch, dev, card)

    # 10. The last modules: qpbench, the native host solver, the gallery
    # and the demos.
    paths = {"qpbench": phase_benches(pt, torch, dev, card)}
    phase_native(pt, torch, dev, res, scenario)
    scripts = phase_scripts(pt, torch, dev, card)
    paths.update(scripts)
    for name in LINALG:
        new_paths[name].update({path: counts[name]
                                for path, counts in paths.items()})
    new_paths["all_metrics_halfspaces"] = {
        path: counts["all_metrics_halfspaces"]
        for path, counts in scripts.items()}

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
        *((name, "ipm_pass_kernels.cu", "none: the JAX package leaves the "
           "IPM pass to XLA's fusion") for name in FUSED),
        ("obstacle_draws", "obstacle_draws.cu", "none: the JAX package "
         "splits one key a run and lets XLA batch the draws"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source + src,
         "replaces": replaces, "launches": launches[name], **record[name],
         **({"launches_new_paths": new_paths[name]} if name in new_paths
            else {})}
        for name, src, replaces in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
