"""PyTorch port: the head_on_n20 Monte Carlo QPs that the float32 IPM
left stalled in a failure scan of 10,000,800 runs on the card
(`experiments/mc_failures.py`, draws of the draw kernel), solved again on
the CPU.

`tests/data/mc_stalled_lanes.npz` holds the 15 QPs (all of the mean
metric) the scan found stopped by the stall rule, ten passes without a
0.5% gain, at merits of 2e-3 to 5e-2, far above the tolerance: the
shared P_uu, G_u and box_theta, and each lane's q_u, h1, A and b, named
"scan seed:study:run:metric".  From a cold start the float64 loop stalls
on them as the float32 one does: primal and dual variables take step
lengths of their own, the primal steps of u and s enter the dual
residual, and the iterates swing.  The float64 re-solve warm from the
float32 iterate converges 14 of them; the rescue's cold start with one
step length (`qp_ipm_structured._Spec.one_step`) converges all 15.
Lane "2147484625:1123:22:mean" needs it: without it its run ends failed,
so the file also holds that run's obstacle draw, which the pipeline runs
again here.

Each lane's optimum comes from the benchmark's plain float64 QP
reference (`benchmark/reference.py::solve_qp`, an interior point on the
lane's full (u, s) problem, written apart from the port), and each answer
is judged in that QP (`plan_objective`: the best slacks for the controls).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    qp_ipm_structured as qps)

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).with_name("data") / "mc_stalled_lanes.npz"
with np.load(DATA) as _z:
    LANES = [str(name) for name in _z["lanes"]]
F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def data():
    with np.load(DATA) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference", ROOT / "benchmark" / "reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_qp(reference, data, name):
    """The lane's QP in the reference's form: z = [u; s], the box rows,
    the soft rows A u - s <= b and -s <= 0; no constant."""
    j = LANES.index(name)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(F64)     # noqa: E731
    P_uu, G_u, A = t(data["P_uu"]), t(data["G_u"]), t(data["A"][j])
    n, m1, m2 = P_uu.shape[0], G_u.shape[0], A.shape[0]
    eye, zeros = torch.eye(m2, dtype=F64), torch.zeros
    P = torch.block_diag(P_uu, float(data["p_ss"]) * eye)
    q = torch.cat([t(data["q_u"][j]),
                   torch.full((m2,), float(data["q_s"]), dtype=F64)])
    G = torch.cat([torch.cat([G_u, zeros(m1, m2, dtype=F64)], 1),
                   torch.cat([A, -eye], 1),
                   torch.cat([zeros(m2, n, dtype=F64), -eye], 1)])
    hb = torch.cat([t(data["h1"][j]), t(data["b"][j]),
                    zeros(m2, dtype=F64)])
    return reference.QP(P, q[None], G[None], hb[None],
                        zeros(1, dtype=F64), n, m1)


def reference_optimum(reference, qp):
    """(u [n], objective) of the reference's float64 solve, which must
    reach a scaled residual below 1e-9 (its own stop is at 1e-10, which
    one lane misses by 5% in its 100 iterations)."""
    z, f, res = reference.solve_qp(qp, reference.FLOAT64,
                                   return_residual=True)
    assert float(res[0]) < 1e-9
    return z[0, :qp.n_u], float(f[0])


def lane_qp(data, name, dtype):
    """(solve_mpc_qp's arguments, box_theta) of one lane."""
    j = LANES.index(name)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)   # noqa: E731
    return ([t(data["P_uu"]), t(data["q_u"][j:j + 1]), t(data["G_u"]),
             t(data["h1"][j:j + 1]), t(data["A"][j:j + 1]),
             t(data["b"][j:j + 1]), t(data["p_ss"]), t(data["q_s"])],
            t(data["box_theta"]))


@pytest.mark.parametrize("name", LANES)
def test_the_stalled_lane_ends_converged(data, reference, name):
    """The call answers the lane (the float32 loop stalls on 14 of the 15
    on this CPU, on all of them on the card): its controls inside the
    boxes and their objective in the reference's QP within 1e-3 of the
    reference optimum's.  Within the solver's tolerance the answer may
    stand without its polish (ROADMAP F6): one lane, 3913000401:3540:285,
    lies 2.4e-4 above on a flat valley of the objective (its controls
    3.9e-2 away), the others within 3e-9 (their controls within 2e-7)."""
    qp, theta = lane_qp(data, name, F32)
    sol = qps.solve_mpc_qp(*qp, max_iters=60, tol=3e-5, box_theta=theta)
    assert bool(sol.converged[0])
    rqp = reference_qp(reference, data, name)
    _, best = reference_optimum(reference, rqp)
    f, viol = reference.plan_objective(rqp, sol.u.double())
    assert float(viol[0]) <= 1e-5
    assert abs(float(f[0]) - best) <= 1e-3 * abs(best)


@pytest.mark.parametrize("name", LANES)
def test_the_cold_one_step_start_reaches_the_reference_optimum(
        data, reference, name):
    """The rescue's cold float64 start with one step length, at tol 1e-9,
    converges the lane to the reference's optimum: controls within 1e-6,
    objective within 1e-8 relative."""
    qp64, theta64 = lane_qp(data, name, F64)
    d64, spec64 = qps._prepare(*qp64, 60, 1e-9, theta64)
    one = qps._ipm_eager(d64, spec64._replace(one_step=True), None)
    assert bool(one.converged[0])
    rqp = reference_qp(reference, data, name)
    u_ref, best = reference_optimum(reference, rqp)
    assert float((one.u[0] - u_ref).abs().max()) <= 1e-6
    f, viol = reference.plan_objective(rqp, one.u)
    assert float(viol[0]) <= 1e-9
    assert abs(float(f[0]) - best) <= 1e-8 * abs(best)
    assert abs(float(one.obj[0]) - best) <= 1e-8 * abs(best)


def test_the_cold_float64_start_stalls_as_the_float32_one(data):
    """The failing lane from a cold start in float64, with two step
    lengths: stalled as in float32; with one: converged."""
    qp64, theta64 = lane_qp(data, "2147484625:1123:22:mean", F64)
    d, spec = qps._prepare(*qp64, 60, 3e-5, theta64)
    two = qps._ipm_eager(d, spec, None)
    one = qps._ipm_eager(d, spec._replace(one_step=True), None)
    assert not bool(two.converged[0]) and int(two.iterations[0]) < 60
    assert bool(one.converged[0])


def test_the_failing_run_ends_converged(data):
    """Study 1123 of scan seed 2147484625, run 22, from its saved draw,
    through the pipeline as the Monte Carlo study runs it: all three QPs
    converge (the mean one from the rescue's cold start) and every
    minimum distance is finite."""
    import sys
    saved = list(sys.path)
    sys.path[:0] = [str(ROOT / "benchmark")]
    try:
        import harness
        cell = harness.find_cell(ROOT, "head_on_n20.mc300")
        ctx = harness.make_ctx(cell, 0, "cpu", torch)
    finally:
        sys.path[:] = saved
    pt = ctx.pt
    statics = pt.models.make_statics(ctx.scenario, ctx.params, F32, "cpu")
    obstacles = pt.simulation.ObstacleData(*(
        torch.from_numpy(data["run_" + k])
        for k in ("nominal", "samples", "realization")))
    res = pt.models.pipeline.run_scenario_with_obstacles(
        statics, obstacles, ctx.scenario.ego_start, ctx.scenario.ego_goal,
        ctx.params.ego_velocity, qp_iters=ctx.config["qp_iters"])
    min_d, converged = pt.evaluation.monte_carlo.reduce_runs(res)
    assert bool(converged.all())
    assert bool(torch.isfinite(min_d).all())
    # The mean QP: 18 float32 passes, 10 of the warm float64 start, then
    # the cold one's.
    assert int(res.qp_iterations[0, 0]) > 18 + 10
