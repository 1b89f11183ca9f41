"""The paper's collision-probability study as users call it:
`evaluation/monte_carlo.py::run_monte_carlo_simulation` with n runs, one
whole study after another, each with its own seed derived from the run's
seed and the study's index. The study draws its obstacles itself, one
generator a run. A call's units are its runs; a run fails when one of
its three QPs did not converge (the pipeline then falls back) or its
minimum distances are not finite.

Traffic keys: runs (n a study), chunk_size (runs a pipeline call).
"""

from __future__ import annotations

import time

import inputs
import reference as ref


class State:
    pass


def setup(ctx):
    st = State()
    st.ctx, torch = ctx, ctx.torch
    cfg = ctx.config
    st.runs = ctx.traffic["runs"]
    st.dtype = getattr(torch, cfg["dtype"])
    st.statics = ctx.pt.models.make_statics(ctx.scenario, ctx.params,
                                            st.dtype, ctx.device)
    st.mc = ctx.pt.evaluation.monte_carlo
    return st


def units(st):
    return st.runs


def study_seed(st, i):
    from harness import derive_seed
    return derive_seed(st.ctx.seed, "study", i)


def call(st, i):
    ctx, torch = st.ctx, st.ctx.torch
    seed = study_seed(st, i)
    t0 = time.perf_counter()
    res = st.mc.run_monte_carlo_simulation(
        ctx.scenario, ctx.params, n_runs=st.runs, seed=seed, dtype=st.dtype,
        device=ctx.device, statics=st.statics,
        chunk_size=ctx.traffic["chunk_size"], qp_iters=ctx.config["qp_iters"])
    bad = ~res.qp_converged.all(1) | ~torch.isfinite(res.min_distances).all(1)
    n_bad = int(bad.sum())
    return inputs.Record(st.runs, n_bad, time.perf_counter() - t0,
                         (seed, res.min_distances, ~res.qp_converged))


def _reference_inputs(st, seed):
    """The study's obstacles, drawn again from its seed as the study
    draws them: float64 samples and realizations, start, goal."""
    torch, cfg = st.ctx.torch, st.ctx.config
    device = st.ctx.device
    T = inputs.n_steps(cfg)
    seeds = ref.mc_run_seeds(seed, st.runs)
    noise, lap = ref.mc_redraw(seeds, cfg, T, device)
    obs = cfg["obstacles"]
    nominal = ref.nominal_paths([o["start"] for o in obs],
                                [o["direction"] for o in obs],
                                [o["speed"] for o in obs], T, cfg["dt"],
                                torch.float64, device)
    samples = noise.double() + nominal[:, None]
    real = lap.double() + nominal
    start, goal = inputs.start_goal(torch, cfg, st.runs, device)
    return samples, real, start, goal


def _judge(st, kept, ar_control):
    worst = 0.0
    for seed, md, fallback in kept:
        samples, real, start, goal = _reference_inputs(st, seed)
        want = ref.min_distances(ref.pipeline(
            samples, real, start, goal, st.ctx.config, ref.FLOAT64,
            fallback=None if ar_control is not None else fallback))
        if ar_control is not None:
            md = ref.min_distances(ref.pipeline(samples.float(), real.float(),
                                                start, goal, st.ctx.config,
                                                ar_control))
        gap = (md.double() - want).abs()
        gap = gap.where(gap.isfinite(), gap.new_tensor(float("inf")))
        worst = max(worst, float(gap.max()))
    return {"min_distance_gap": worst}


def check(st, kept):
    """Each kept study's per-run minimum distances against the float64
    reference study on the same draws; a run's plan that the study
    reports as not converged is held to the fallback (the straight
    line's inputs), as the filter specifies, and counted as failed."""
    return _judge(st, kept, None)


def control(st, kept):
    return _judge(st, kept, ref.TF32)
