"""Batched sweeps: `run_scenario_with_obstacles` on S scenarios a call,
back to back (a closed loop), cycling a pool of obstacle draws made in
set-up. Each call ends when its failure flags are on the host.

Traffic keys: scenarios (S a call), pool (draws in the pool).

A scenario fails when one of its QPs fell back (the program reports it)
or an output is not finite; a plan that fell back is judged against the
fallback it reports (reference.judge_plan).
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
    st.pipe = ctx.pt.models.pipeline
    return st


def units(st):
    return st.S


def call(st, i):
    ctx, torch = st.ctx, st.ctx.torch
    k = i % st.P
    t0 = time.perf_counter()
    res = st.pipe.run_scenario_with_obstacles(
        st.statics, ctx.pt.simulation.obstacles.ObstacleData(*st.pool.draw(k)),
        ctx.scenario.ego_start, ctx.scenario.ego_goal, ctx.params.ego_velocity,
        qp_iters=ctx.config["qp_iters"], qp_tol=ctx.config["qp_tol"])
    bad = int(inputs.bad_scenarios(torch, res).sum())
    return inputs.Record(st.S, bad, time.perf_counter() - t0,
                         (k, inputs.plan_of(res), res.used_fallback))


def _judge(st, kept, make_plan):
    torch = st.ctx.torch
    worst = {}
    for k, plan, fallback in kept:
        _, samples, real = st.pool.draw(k)
        start, goal = inputs.start_goal(torch, st.ctx.config, st.S, samples.device)
        plan, fallback = make_plan(plan, fallback, samples, real, start, goal)
        for name, v in ref.judge_plan(plan, samples.double(), real.double(),
                                      start, goal, st.ctx.config,
                                      fallback).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def check(st, kept):
    """The kept calls' outputs against the float64 reference."""
    return _judge(st, kept, lambda plan, fallback, *_: (plan, fallback))


def control(st, kept):
    """The same comparison of the reference computed in TF32 in the
    program's place, on the kept calls' inputs."""
    cfg = st.ctx.config
    return _judge(st, kept, lambda plan, fallback, samples, real, start, goal:
                  (ref.pipeline(samples, real, start, goal, cfg, ref.TF32), None))
