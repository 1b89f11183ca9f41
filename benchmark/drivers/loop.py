"""One robot replanning as fast as it can: one caller in a closed loop
calls `run_scenario_with_obstacles` on one scenario and waits until its
filtered controls are on the host. Each plan gets the next obstacle
belief of a pool drawn in set-up. A plan's latency runs from the call
until `filtered_u` is on the host.

Traffic keys: pool (single-scenario draws in the pool).
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
    st.P = ctx.traffic["pool"]
    dtype = getattr(torch, cfg["dtype"])
    st.statics = ctx.pt.models.make_statics(ctx.scenario, ctx.params, dtype,
                                            ctx.device)
    from harness import derive_seed
    st.pool = inputs.make_pool(torch, cfg, st.P, 1,
                               derive_seed(ctx.seed, "pool"), ctx.device)
    st.pipe = ctx.pt.models.pipeline
    return st


def units(st):
    return 1


def call(st, i):
    ctx, torch = st.ctx, st.ctx.torch
    k = i % st.P
    t0 = time.perf_counter()
    res = st.pipe.run_scenario_with_obstacles(
        st.statics, ctx.pt.simulation.obstacles.ObstacleData(*st.pool.draw(k)),
        ctx.scenario.ego_start, ctx.scenario.ego_goal, ctx.params.ego_velocity,
        qp_iters=ctx.config["qp_iters"], qp_tol=ctx.config["qp_tol"])
    res.filtered_u.cpu()
    latency = time.perf_counter() - t0
    bad = int(inputs.bad_scenarios(torch, res).sum())
    return inputs.Record(1, bad, latency, (k, inputs.plan_of(res), res.used_fallback))


def _inputs(st, kept):
    torch = st.ctx.torch
    idx = torch.as_tensor([k[0] for k in kept], device=st.pool.samples.device)
    samples = st.pool.samples.index_select(0, idx)
    real = st.pool.realization.index_select(0, idx)
    start, goal = inputs.start_goal(torch, st.ctx.config, len(kept), samples.device)
    return samples, real, start, goal


def check(st, kept):
    """The kept plans, judged together against the float64 reference."""
    samples, real, start, goal = _inputs(st, kept)
    plan = inputs.cat_plans(st.ctx.torch, [k[1] for k in kept])
    fallback = st.ctx.torch.cat([k[2] for k in kept])
    return ref.judge_plan(plan, samples.double(), real.double(), start, goal,
                          st.ctx.config, fallback)


def control(st, kept):
    samples, real, start, goal = _inputs(st, kept)
    plan = ref.pipeline(samples, real, start, goal, st.ctx.config, ref.TF32)
    return ref.judge_plan(plan, samples.double(), real.double(), start, goal,
                          st.ctx.config)
