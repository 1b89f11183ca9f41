"""The halfspace stage alone: `compute_safe_halfspaces_for_trajectory` on
S scenarios a call (every timestep of the horizon and every obstacle, all
three metrics), cycling a pool of obstacle draws made in set-up, against
the scenario's straight-line reference made once in set-up. Each call
ends in a device synchronize. A call's units are its rows, one a
(scenario, timestep, obstacle).

Traffic keys: scenarios (S a call), pool (draws in the pool).
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
    cfg, tr = ctx.config, ctx.traffic
    st.S, st.P = tr["scenarios"], tr["pool"]
    dtype = getattr(torch, cfg["dtype"])
    st.statics = ctx.pt.models.make_statics(ctx.scenario, ctx.params, dtype,
                                            ctx.device)
    from harness import derive_seed
    st.pool = inputs.make_pool(torch, cfg, st.P, st.S,
                               derive_seed(ctx.seed, "pool"), ctx.device)
    start, goal = inputs.start_goal(torch, cfg, st.S, ctx.device)
    st.x_ref64 = ref.straight_line(start, goal, cfg["ego_velocity"], cfg["dt"],
                                   cfg["horizon"], ref.FLOAT64)
    st.x_ref = st.x_ref64.to(dtype)
    st.n_steps = min(cfg["horizon"], inputs.n_steps(cfg) + 1)
    st.rows = st.S * st.n_steps * len(cfg["obstacles"])
    st.env_mod = ctx.pt.simulation.environment
    return st


def units(st):
    return st.rows


def call(st, i):
    from harness import sync
    k = i % st.P
    t0 = time.perf_counter()
    out = st.env_mod.compute_safe_halfspaces_for_trajectory(
        st.statics.env, st.pool.draw(k)[1], st.x_ref)
    sync(st.ctx.torch, st.ctx.device)
    return inputs.Record(st.rows, 0, time.perf_counter() - t0, (k, out))


def _judge(st, kept, make):
    """halfspace_gap over the kept calls, 256 scenarios at a time."""
    cfg, worst = st.ctx.config, 0.0
    n_obs = len(cfg["obstacles"])
    ego = ref.ego_rows(st.x_ref64, st.n_steps, n_obs).reshape(st.S, -1, 2)
    for k, out in kept:
        samples = st.pool.draw(k)[1]
        for b in range(0, st.S, 256):
            blk = slice(b, min(b + 256, st.S))
            rows = ref.sample_rows(samples[blk], st.n_steps).double()
            e = ego[blk].reshape(-1, 2)
            h, g = make(out, blk, rows, e)
            worst = max(worst, ref.halfspace_gap(rows, e, h, g, cfg))
    return {"halfspace_gap": worst}


def check(st, kept):
    def program(out, blk, rows, ego):
        return ({m: out.by_metric(m).h[blk].reshape(-1, 2) for m in ref.METRICS},
                {m: out.by_metric(m).g_tilde[blk].reshape(-1) for m in ref.METRICS})
    return _judge(st, kept, program)


def control(st, kept):
    return _judge(st, kept, lambda out, blk, rows, ego:
                  ref.halfspaces(rows.float(), ego.float(), st.ctx.config,
                                 ref.TF32))
