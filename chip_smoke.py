#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ops/csrc with nvcc, holds every
kernel against its plain PyTorch version on the card, runs the seeded
end-to-end scenarios against the CPU float64 path and the scipy oracle,
and drives the port's main path (`run_scenario_core`) once at a size
users run: 256 multi_obstacle scenarios with 1000 samples per obstacle.
It imports torch, numpy, scipy, the port and the numpy-only helpers in
tests/ -- never jax.

Phases (each prints its lines; any failed gate raises and the exit code
is non-zero):
  1. device: nvidia-smi name and power limit, versions, TF32 flags;
  2. build: the kernels' nvcc build;
  3. kernels against their plain versions at the main path's shapes;
  4. seeded end to end: the reference's seed-42 streams (N = 20);
  5. the batch run, with its launch counts, checks and wall time.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"
TPU_PKG = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu"

ARGS = (0.2, 0.1, 0.15, 0.3, 0.3)   # alpha, delta, epsilon, radii (custom)
H_TOL, G_ATOL, G_RTOL, LINALG_RTOL = 1e-5, 2e-4, 1e-5, 1e-5
ORACLE_TOL = 1e-4
BATCH = dict(scenarios=256, n_samples=1000, sim_time=6.0, qp_iters=35,
             qp_tol=3e-5, seed=0, recheck=8)


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_vs_kernel_ms(plain, kernel, reps: int):
    """Times in turns (plain, kernel, kernel, plain) within this call."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel,
                                                 plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_halfspaces(ck, samples, ego, alpha, label):
    """Kernel 1 against its plain version; returns the max abs error."""
    import torch

    out = ck.all_metrics_halfspaces(samples, ego, alpha, *ARGS[1:])
    torch.cuda.synchronize()
    ref = ck.all_metrics_halfspaces_plain(samples, ego, alpha, *ARGS[1:])
    err = 0.0
    for name, a, b in zip(out._fields, out, ref):
        gate(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        diff = (a - b).abs()
        if name.startswith("h"):
            gate(float(diff.max()) <= H_TOL,
                 f"{label}: {name} off by {float(diff.max()):.3e}")
        else:
            bound = G_ATOL + G_RTOL * b.abs()
            gate(bool((diff <= bound).all()),
                 f"{label}: {name} off by {float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    return err


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
    small_rows = kernel_rows(
        pt, torch, pt.models.make_statics(s20, p20, torch.float32, dev),
        obs20, s20.ego_start, s20.ego_goal, p20.ego_velocity)

    # Kernel 1 at the batch run's rows, then its edges.
    err = check_halfspaces(ck, rows, ego, ARGS[0], "batch rows")
    k_ms, p_ms = plain_vs_kernel_ms(
        lambda: ck.all_metrics_halfspaces_plain(rows, ego, *ARGS),
        lambda: ck.all_metrics_halfspaces(rows, ego, *ARGS), reps=5)
    record["all_metrics_halfspaces"] = (err, k_ms, p_ms)
    print(f"[kernels] all_metrics_halfspaces B={rows.shape[0]} "
          f"N={rows.shape[1]}: max_abs_err {err:.3e}, {k_ms:.4f} ms "
          f"(plain {p_ms:.4f} ms)")
    check_halfspaces(ck, *small_rows, ARGS[0], "N=20 rows")
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, N in ((4, 4096), (13, 1001), (11, 50), (1, 1)):
        x = 2.0 + 0.1 * torch.randn(B, N, 2, generator=gen, **f32)
        check_halfspaces(ck, x, torch.randn(B, 2, generator=gen, **f32),
                         ARGS[0], f"B={B} N={N}")
    rng = np.random.default_rng(7)
    for case in ("ties", "constant", "outlier", "negative", "laplace",
                 "alpha_mid"):
        vals = streams.adversarial_samples(case, rng, 8, 64)
        check_halfspaces(ck, torch.as_tensor(vals, **f32),
                         torch.as_tensor(rng.normal(size=(8, 2)), **f32),
                         0.5 if case == "alpha_mid" else ARGS[0], case)
    # The select alone, bit for bit, on the plain path's projections.
    h = ck.all_metrics_halfspaces_plain(rows, ego, *ARGS).h
    centered = rows - ego[:, None, :]
    mean = centered.mean(1, keepdim=True)
    x = -((centered - mean) * h[:, None, :]).sum(-1).contiguous()
    n = x.shape[1]
    k = pt.core.risk.cvar_k(n, ARGS[0])
    v = ck.kth_largest(x, k)
    ref = torch.kthvalue(x, n - k + 1, dim=-1).values
    gate(torch.equal(v, ref), "select: k-th value not bit-equal")
    print(f"[kernels] select: k-th largest (k={k}) bit-equal to "
          f"torch.kthvalue on {x.shape[0]} rows")
    print("[kernels] all_metrics_halfspaces: N=20, N=4096, ragged B/N and "
          "the six adversarial cases within h 1e-5, g 2e-4 + 1e-5 rel")

    # Kernels 2 and 3 at the QP batch (768 = 256 scenarios x 3 metrics).
    errs = {"batched_cholesky": 0.0, "batched_cho_solve": 0.0}
    times = {}
    for n in (60, 64):
        A = torch.randn(768, n, n, generator=gen, **f32)
        S = A @ A.mT + 3.0 * torch.eye(n, **f32)
        L = cl.batched_cholesky(S)
        L_ref = cl.batched_cholesky_plain(S)
        rel = float((L - L_ref).norm() / L_ref.norm())
        gate(rel < LINALG_RTOL, f"cholesky n={n}: rel err {rel:.3e}")
        gate(float(L.triu(1).abs().max()) == 0.0, "cholesky: upper part")
        errs["batched_cholesky"] = max(errs["batched_cholesky"],
                                       float((L - L_ref).abs().max()))
        if n == 60:
            times["batched_cholesky"] = plain_vs_kernel_ms(
                lambda: cl.batched_cholesky_plain(S),
                lambda: cl.batched_cholesky(S), reps=20)
        for k in (1, 65):
            shape = (768, n) if k == 1 else (768, n, k)
            r = torch.randn(shape, generator=gen, **f32)
            xs = cl.batched_cho_solve(L, r)
            x_ref = cl.batched_cho_solve_plain(L, r)
            rel = float((xs - x_ref).norm() / x_ref.norm())
            gate(rel < LINALG_RTOL, f"solve n={n} k={k}: rel err {rel:.3e}")
            errs["batched_cho_solve"] = max(errs["batched_cho_solve"],
                                            float((xs - x_ref).abs().max()))
            if n == 60:
                times[f"batched_cho_solve_k{k}"] = plain_vs_kernel_ms(
                    lambda: cl.batched_cho_solve_plain(L, r),
                    lambda: cl.batched_cho_solve(L, r), reps=20)
        print(f"[kernels] batched_cholesky / batched_cho_solve "
              f"[768, {n}, {n}], k = 1 and 65: within {LINALG_RTOL} rel")
    for name, (k_ms, p_ms) in times.items():
        print(f"[kernels] {name} B=768 n=60: {k_ms:.4f} ms "
              f"(plain {p_ms:.4f} ms)")
    record["batched_cholesky"] = (errs["batched_cholesky"],
                                  *times["batched_cholesky"])
    record["batched_cho_solve"] = (errs["batched_cho_solve"],
                                   *times["batched_cho_solve_k1"])
    return record


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

    # 3. Kernels against their plain versions, at the main path's shapes.
    record = phase_kernels(pt, torch, dev, streams)

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
    cpu_statics = pt.models.make_statics(scenario, params, torch.float64)
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
    print(f"[batch] converged {conv:.4f}, mean IPM iterations {iters:.2f}, "
          f"wall {device_ms:.1f} ms by CUDA events ({host_ms:.1f} ms host) "
          f"on {card}")
    print(f"[batch] CPU float64 re-run of {n_re} scenarios: converged flags "
          f"agree, objectives within {obj_rel:.2e} relative")
    print(f"[batch] launches {launches}")

    source = f"{PKG}/ops/csrc/"
    kernels = [
        ("all_metrics_halfspaces", "halfspace_kernels.cu",
         f"{TPU_PKG}/ops/pallas_kernels.py:82"),
        ("batched_cholesky", "linalg_kernels.cu",
         f"{TPU_PKG}/ops/pallas_linalg.py:46"),
        ("batched_cho_solve", "linalg_kernels.cu",
         f"{TPU_PKG}/ops/pallas_linalg.py:71"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source + src,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": record[name][0], "ms": record[name][1],
         "plain_ms": record[name][2]}
        for name, src, replaces in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
