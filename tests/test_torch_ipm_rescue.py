"""PyTorch port: the structured IPM's float64 rescue of float32 lanes that
stop unconverged below the iteration cap, the key of its CUDA graphs, and
the Monte Carlo scan of failing runs (`experiments/mc_failures.py`), on
the CPU.

The rescue re-solves such a lane in float64, warm from its float32
iterate, with the float32 call's cap and tolerance, and from the cold
start where the warm one does not converge: the lane comes back converged
and within 1e-4 of the float64 solve of the same QP, also at the cap; a
lane neither start converges keeps its fallback.  Two `head_on_n20`
studies (300 runs, float32, qp_iters 60) whose float32 loop stalls one QP
each above the convergence line end with every run converged.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
    qpbench)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    qp_ipm_structured as qps)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

ROOT = Path(__file__).resolve().parents[1]
F32, F64 = torch.float32, torch.float64


def bench_qps(batch, dtype=F32, seed=0):
    """qpbench's QPs (H = 30, 3 obstacles, box rows), with box_theta."""
    prob, data = qpbench.make_data(batch, seed, "cpu")
    qp = [t.to(dtype) if torch.is_tensor(t) else t
          for t in qpbench.assemble(prob, *data)]
    return qp, prob.Theta.reshape(-1, qp[0].shape[0]).to(dtype)


def test_a_lane_stopped_below_the_cap_is_rescued():
    qp, theta = bench_qps(8)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    sol = qps._ipm_eager(d, spec, None)
    assert bool(sol.converged.all())
    # Lane 5 reported as stopped unconverged after 7 float32 iterations.
    fake = sol._replace(converged=sol.converged.clone(),
                        iterations=sol.iterations.clone())
    fake.converged[5] = False
    fake.iterations[5] = 7
    was, before = timing.record(True), timing.totals()
    try:
        out = qps._rescue(d, spec, fake)
        added = timing.since(before)
    finally:
        timing.record(was)
    assert added["counts"]["ipm.rescued"] == 1
    assert added["counts"]["ipm.rescued_converged"] == 1
    assert "ipm.passes" not in added["counts"]      # the re-solve uncounted
    assert bool(out.converged.all())
    assert out.u.dtype == F32 and 7 < int(out.iterations[5]) <= 7 + 60
    ref = qps.solve_mpc_qp(*[t.to(F64) if torch.is_tensor(t) else t
                             for t in qp], max_iters=60,
                           box_theta=theta.to(F64))
    assert float((out.u[5].double() - ref.u[5]).abs().max()) < 1e-4
    others = torch.arange(8) != 5
    for a, b in zip((out.u, out.s, out.iterations, *out.mults),
                    (sol.u, sol.s, sol.iterations, *sol.mults)):
        assert torch.equal(a[others], b[others])


def breaking_factor(lanes=(3, 11), after=2):
    """`_factor` with NaN factors for `lanes` of every float32 system from
    the loop's third pass on (and so in their polish): those lanes break
    down well before the cap.  Float64 systems (the re-solve's) are
    factored as they are."""
    real, calls = qps._factor, [0]

    def factor(S):
        L = real(S)
        if S.dtype == F32:
            calls[0] += 1
            if calls[0] > after:
                L = L.clone()
                L[list(lanes)] = float("nan")
        return L
    return factor


def test_lanes_that_break_down_are_rescued(monkeypatch):
    """Two of qpbench's 16 QPs break down in float32 well before the cap:
    the call answers them from the float64 re-solve."""
    qp, _ = bench_qps(16)
    d, spec = qps._prepare(*qp, 35, 3e-5, None)
    monkeypatch.setattr(qps, "_factor", breaking_factor())
    plain = qps._ipm_eager(d, spec, None)
    lost = ~plain.converged
    assert bool(lost.any()) and bool((plain.iterations[lost] < 35).all())
    monkeypatch.setattr(qps, "_factor", breaking_factor())
    sol = qps.solve_mpc_qp(*qp, max_iters=35, tol=3e-5)
    monkeypatch.undo()
    assert bool(sol.converged.all())
    assert bool((sol.iterations[lost] > plain.iterations[lost]).all())
    assert torch.equal(sol.u[~lost], plain.u[~lost])
    ref = qps.solve_mpc_qp(*[t.to(F64) if torch.is_tensor(t) else t
                             for t in qp], max_iters=35)
    assert float((sol.u[lost].double() - ref.u[lost]).abs().max()) < 1e-4


def test_a_lane_at_the_cap_keeps_its_answer():
    """At a cap of one iteration neither float64 start converges a lane
    either: every lane keeps its float32 answer, and with it the
    fallback."""
    qp, theta = bench_qps(4)
    d1, spec1 = qps._prepare(*qp, 1, 3e-5, theta)
    eager = qps._ipm_eager(d1, spec1, None)
    assert not bool(eager.converged.any())
    assert bool((eager.iterations == 1).all())
    assert qps._rescue(d1, spec1, eager) is eager
    capped = qps.solve_mpc_qp(*qp, max_iters=1, tol=3e-5, box_theta=theta)
    assert not bool(capped.converged.any())
    for a, b in zip(capped[:-1], eager[:-1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cap", [3, 4, 5])
def test_each_attempt_stops_at_the_cap(cap):
    """qpbench's QPs at a low cap, where every float32 lane stops at it:
    a lane no re-solve converges reports exactly the cap; one a re-solve
    converges reports the cap plus at most the cap for each re-solve that
    ran (warm, then cold), and those lanes are the rescue's converged
    ones (at cap 3 some lanes take the cold start, at 4 one lane neither
    converges, at 5 the warm start converges all)."""
    for batch in (8, 16):
        qp, theta = bench_qps(batch)
        d, spec = qps._prepare(*qp, cap, 3e-5, theta)
        f32 = qps._ipm_eager(d, spec, None)
        assert bool((f32.iterations == cap).all())
        assert not bool(f32.converged.any())
        was, before = timing.record(True), timing.totals()
        try:
            sol = qps.solve_mpc_qp(*qp, max_iters=cap, tol=3e-5,
                                   box_theta=theta)
            counts = timing.since(before)["counts"]
        finally:
            timing.record(was)
        assert counts["ipm.rescued"] == counts["ipm.rescued_capped"] == batch
        kept, answered = ~sol.converged, sol.converged
        assert bool((sol.iterations[kept] == cap).all())
        top = (3 if counts.get("ipm.rescued_cold", 0) else 2) * cap
        assert bool((sol.iterations[answered] > cap).all())
        assert bool((sol.iterations[answered] <= top).all())
        assert int(answered.sum()) == counts.get("ipm.rescued_converged", 0)
        for a, b in zip(sol[:-1], f32[:-1]):
            assert torch.equal(a[kept], b[kept])


def _rescued(d, spec, fake):
    """`_rescue` of `fake` with the recorder on: (solution, counters)."""
    was, before = timing.record(True), timing.totals()
    try:
        out = qps._rescue(d, spec, fake)
        return out, timing.since(before)["counts"]
    finally:
        timing.record(was)


def _float64_u(qp, theta):
    return qps.solve_mpc_qp(*[t.to(F64) if torch.is_tensor(t) else t
                              for t in qp], max_iters=60,
                            box_theta=theta.to(F64)).u


def test_a_lane_at_the_cap_that_float64_converges_is_answered():
    """Lane 5 reported at the cap: the warm float64 re-solve converges it,
    and the call answers it within 1e-4 of the float64 solve, with the
    float32 count plus the re-solve's as its iterations."""
    qp, theta = bench_qps(8)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    sol = qps._ipm_eager(d, spec, None)
    fake = sol._replace(converged=sol.converged.clone(),
                        iterations=sol.iterations.clone())
    fake.converged[5] = False
    fake.iterations[5] = 60
    out, counts = _rescued(d, spec, fake)
    assert counts["ipm.rescued"] == counts["ipm.rescued_capped"] == 1
    assert counts["ipm.rescued_converged"] == 1
    assert counts.get("ipm.rescued_cold", 0) == 0
    assert bool(out.converged.all()) and 60 < int(out.iterations[5]) <= 120
    assert float((out.u[5].double() - _float64_u(qp, theta)[5]).abs().max()
                 ) < 1e-4
    others = torch.arange(8) != 5
    for a, b in zip((out.u, out.s, out.iterations, *out.mults),
                    (sol.u, sol.s, sol.iterations, *sol.mults)):
        assert torch.equal(a[others], b[others])


def test_a_lane_the_warm_start_leaves_stalled_is_solved_cold():
    """Lane 2 stopped at 9 float32 iterations on an iterate of NaN: the
    warm float64 start breaks down on it, the cold one (one step length
    for primal and dual variables) converges, and the call answers the
    lane from it: the float64 solve with the float32 call's cap and
    tolerance, its objective within 1e-4 of the float64 optimum's."""
    qp, theta = bench_qps(6)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    sol = qps._ipm_eager(d, spec, None)
    fake = sol._replace(converged=sol.converged.clone(),
                        iterations=sol.iterations.clone(), u=sol.u.clone())
    fake.converged[2] = False
    fake.iterations[2] = 9
    fake.u[2] = float("nan")
    out, counts = _rescued(d, spec, fake)
    assert counts["ipm.rescued"] == counts["ipm.rescued_cold"] == 1
    assert counts["ipm.rescued_converged"] == 1
    assert counts.get("ipm.rescued_capped", 0) == 0
    assert bool(out.converged.all()) and int(out.iterations[2]) > 9
    d2, spec2 = qps._lanes64(d, spec, torch.tensor([2]))
    cold = qps._ipm_eager(d2, spec2._replace(one_step=True), None)
    assert float((out.u[2].double() - cold.u[0]).abs().max()) < 1e-6
    best = qps.solve_mpc_qp(*[t.to(F64) if torch.is_tensor(t) else t
                              for t in qp], max_iters=60,
                            box_theta=theta.to(F64)).obj[2]
    assert abs(float(out.obj[2]) - float(best)) < 1e-4 * abs(float(best))


def test_a_lane_neither_start_converges_keeps_the_fallback():
    """At a cap of one iteration, a lane on an iterate of NaN: neither
    float64 start converges it, so the call keeps its float32 answer."""
    qp, theta = bench_qps(3)
    d1, spec1 = qps._prepare(*qp, 1, 3e-5, theta)
    sol = qps._ipm_eager(d1, spec1, None)
    fake = sol._replace(u=sol.u.clone())
    fake.u[1] = float("nan")
    out, counts = _rescued(d1, spec1, fake)
    assert out is fake and not bool(out.converged.any())
    assert counts["ipm.rescued"] == counts["ipm.rescued_capped"] == 3
    assert counts["ipm.rescued_cold"] == 3
    assert counts.get("ipm.rescued_converged", 0) == 0


def test_float64_is_never_rescued(monkeypatch):
    calls = []
    monkeypatch.setattr(qps, "_rescue", lambda *a: calls.append(a))
    qp, theta = bench_qps(4, F64)
    sol = qps.solve_mpc_qp(*qp, max_iters=3, box_theta=theta)
    assert not calls and not bool(sol.converged.all())


def _with_tf32(key):
    """`key()` with TF32 turned on for the whole process, then off."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        return key()
    finally:
        torch.set_float32_matmul_precision(saved)


# Each thing the key tells apart, as a change to the base call: other data
# (the same key), then the spec's numbers, dense G_u, per-lane P_uu, the
# batch size, float64, the pass the solve runs and the process's TF32.
KEY_CASES = {
    "other_data": (dict(seed=1), True),
    "max_iters": (dict(iters=35), False),
    "tol": (dict(tol=1e-5), False),
    "dense": (dict(box=False), False),
    "per_lane_P_uu": (dict(per_lane=True), False),
    "batch": (dict(batch=5), False),
    "float64": (dict(dtype=F64), False),
    "pass": (dict(fused=True), False),
    "tf32": (dict(tf32=True), False),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_graph_key_holds_what_changes_the_captured_work(monkeypatch, case):
    """The key of the CUDA graphs (computed from metadata alone, so on the
    CPU too): equal for the same shapes and settings with other data,
    different for each setting the captured work depends on."""
    def key(seed=0, iters=60, tol=3e-5, box=True, per_lane=False, batch=4,
            dtype=F32, fused=False, tf32=False):
        qp, theta = bench_qps(batch, dtype, seed)
        if per_lane:
            qp = [qp[0].expand(batch, -1, -1).contiguous(), *qp[1:]]
        d, spec = qps._prepare(*qp, iters, tol, theta if box else None)
        with monkeypatch.context() as m:
            m.setattr(qps, "use_fused_pass", lambda *a: fused)
            step = qps._pass_of(d)
        if tf32:
            return _with_tf32(lambda: qps._graph_key(d, spec, step))
        return qps._graph_key(d, spec, step)

    change, equal = KEY_CASES[case]
    assert (key(**change) == key()) is equal
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.fixture(scope="module")
def mc_failures():
    """The scan script and the benchmark's harness it runs studies with;
    the module search path as it was afterwards."""
    saved = list(sys.path)
    sys.path[:0] = [str(ROOT / "experiments"), str(ROOT / "benchmark")]
    try:
        import harness
        import mc_failures
        yield harness, mc_failures
    finally:
        sys.path[:] = saved


@pytest.mark.parametrize("study,seed", [(184, 4022430766085515886),
                                        (606, 4595962382389267950)])
def test_the_stalled_monte_carlo_studies_end_converged(mc_failures, study,
                                                       seed, capsys):
    """head_on_n20's studies 184 and 606 from seed 3913000401, as the
    benchmark's Monte Carlo driver runs them: each stalls one float32 QP
    just above the convergence line (where this CPU's float32 reproduces
    it), and every run ends converged."""
    harness, scan = mc_failures
    assert harness.derive_seed(3913000401, "study", study) == seed
    summary = scan.main(["--device", "cpu", "--studies", "1",
                         "--first", str(study)])
    assert summary["runs"] == 300 and summary["failing_runs_in_the_end"] == 0
    assert summary["lanes_by_stop"]["cap"] == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + summary["failing_runs_f32"]
    for line in lines[:-1]:
        assert '"converged_in_the_end": true' in line


def test_the_scan_lists_capped_lanes_with_their_float64_outcomes(
        mc_failures, capsys):
    """At a cap of 4 iterations most QPs stop at the cap: each is listed
    with its float64 re-solves under the same cap, and ends converged
    exactly where the rescue's warm start or its cold start with one
    step length converges it, with the float32 count plus the re-solves
    that ran as its iterations; the others keep the fallback and their
    float32 count, and their runs alone fail in the end."""
    _, scan = mc_failures
    summary = scan.main(["--device", "cpu", "--studies", "1", "--runs", "2",
                         "--qp_iters", "4"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if '"stop"' in line]
    assert summary["qps"] == 6 and summary["rescue"]
    assert summary["lanes_by_stop"]["cap"] == len(lines) > 0
    counts = summary["rescue_counts"]
    assert counts["ipm.rescued"] == counts["ipm.rescued_capped"] == len(lines)
    assert counts.get("ipm.rescued_converged", 0) == sum(
        line["converged_in_the_end"] for line in lines)
    assert counts.get("ipm.rescued_cold", 0) == sum(
        not line["f64_warm"]["converged"] for line in lines)
    assert summary["failing_runs_in_the_end"] == len(
        {line["run"] for line in lines if not line["converged_in_the_end"]})
    for line in lines:
        assert line["stop"] == "cap" and line["iterations_f32"] == 4
        for start in ("f64_cold", "f64_warm", "f64_cold_one_step"):
            assert 1 <= line[start]["iterations"] <= 4
        warm, cold = line["f64_warm"], line["f64_cold_one_step"]
        rescued = warm["converged"] or cold["converged"]
        assert line["converged_in_the_end"] is rescued
        if warm["converged"]:
            want = 4 + warm["iterations"]
        elif cold["converged"]:
            want = 4 + warm["iterations"] + cold["iterations"]
        else:
            want = 4
        assert line["iterations_in_the_end"] == want
