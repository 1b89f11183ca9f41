"""PyTorch port: the structured IPM's fused pass (`_fused_pass`, the
kernels of `ops/cuda_ipm.py`) against its plain version `_one_pass`.

On the CPU: which solves take the fused pass (`use_fused_pass`, a pure
function of dtype, device type and shapes), its place in the CUDA
graphs' key, the contract both passes share (the state's buffers updated
in place), and the checks of the kernels' pointer table.

Marked `cuda` (skipped where torch sees no CUDA device: the kernels have
no CPU mode), on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_ipm_fused.py

one pass from the same state (cold, warm, and mid-solve where lanes have
stopped at different passes) at the benchmark's QP shapes against the
plain pass, whole solves against the plain pass's (iterations, converged,
controls), the seed-42 scenarios against the scipy oracle, the solves
that must stay off the fused pass, and the launch counters.
"""

import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_ipm, cuda_linalg as cl, qp_ipm_structured as qps)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

F32, F64 = torch.float32, torch.float64
FUSED_KERNELS = (cuda_ipm.ipm_residuals, cuda_ipm.ipm_predictor,
                 cuda_ipm.ipm_step)

# ---------------------------------------------------------------------------
# CPU: the choice and its checks
# ---------------------------------------------------------------------------

BASE = dict(device_type="cuda", dtype=F32, n=60, m2=90, hp=60, shared=True)
# (change to BASE, taken): every condition of `use_fused_pass` on its own.
DISPATCH = {
    "batch256": ({}, True),
    "hloop_mc300": ({"m2": 30}, True),
    "n64": ({"n": 64, "hp": 64}, True),
    "m2_cap": ({"m2": cuda_ipm.M2_MAX}, True),
    "cpu": ({"device_type": "cpu"}, False),
    "float64": ({"dtype": F64}, False),
    "dense_G_u": ({"hp": None}, False),
    "per_lane_P": ({"shared": False}, False),
    "H40": ({"n": 80, "hp": 80}, False),
    "hp_above_cap": ({"hp": cuda_ipm.HP_MAX + 2}, False),
    "m2_above_cap": ({"m2": cuda_ipm.M2_MAX + 1}, False),
    "no_soft_rows": ({"m2": 0}, False),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_the_fused_pass_is_chosen_from_the_inputs_alone(case):
    change, taken = DISPATCH[case]
    assert qps.use_fused_pass(**{**BASE, **change}) is taken


def cpu_qps(batch, seed=0):
    """(args, box_theta) of qpbench's QPs on the CPU (H = 30, 3 obstacles,
    box rows): n = 60, hp = 60, m2 = 90."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
        qpbench)
    prob, data = qpbench.make_data(batch, seed, "cpu")
    qp = list(qpbench.assemble(prob, *data))
    return qp, prob.Theta.reshape(-1, qp[0].shape[0])


def test_the_graph_key_holds_the_choice(monkeypatch):
    """The CPU takes the plain pass; where the choice says otherwise, the
    same data and settings make another key, so a key's graphs never
    replay the other pass."""
    qp, theta = cpu_qps(4)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    assert qps._pass_of(d) is qps._one_pass
    plain = qps._graph_key(d, spec, qps._pass_of(d))
    monkeypatch.setattr(qps, "use_fused_pass", lambda *a: True)
    assert qps._pass_of(d) is qps._fused_pass
    assert qps._graph_key(d, spec, qps._pass_of(d)) != plain


def cpu_start(d, spec, start):
    """A state on distinct buffers: the cold start, a warm start from a
    nearby solve (q_u moved by 1e-3), or the state after three passes."""
    if start == "warm":
        sol = qps._ipm_eager(d._replace(q_u=d.q_u * (1 + 1e-3)), spec, None)
        return qps._start(d, spec, (sol.u, sol.s, *sol.mults)).dense()
    st = qps._start(d, spec, None).dense()
    for _ in range(3 if start == "mid" else 0):
        qps._one_pass(d, spec, st)
    return st


@pytest.mark.parametrize("start", ["cold", "warm", "mid"])
def test_one_pass_updates_the_state_in_place(start):
    """The plain pass keeps the fused pass's contract: it writes the next
    state (`_next_state`'s, bit for bit) into the state's own buffers,
    returns that state and leaves the data as it was."""
    qp, theta = cpu_qps(6, seed=2)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    st = cpu_start(d, spec, start)
    assert bool(st.active.any())
    want = qps._next_state(d, spec, st)
    data = [None if t is None else t.clone() for t in d]
    ptrs = [t.data_ptr() for t in st.flat()]
    assert qps._one_pass(d, spec, st) is st
    assert [t.data_ptr() for t in st.flat()] == ptrs
    for a, b in zip(st.flat(), want.flat()):
        assert torch.equal(a, b)
    for a, b in zip(d, data):
        assert a is None and b is None or torch.equal(a, b)


def test_the_cpu_solve_runs_no_fused_pass():
    qp, theta = cpu_qps(3)
    before = [k.launches for k in FUSED_KERNELS]
    was, totals = timing.record(True), timing.totals()
    try:
        sol = qps.solve_mpc_qp(*qp, box_theta=theta)
        added = timing.since(totals)["counts"]
    finally:
        timing.record(was)
    assert bool(sol.converged.all()) and added["ipm.passes"] > 1
    assert "ipm.fused_passes" not in added
    assert [k.launches for k in FUSED_KERNELS] == before


def descs(B=5, n=60, hp=60, m2=90, device_type="cuda", **override):
    """Descriptions (device type, dtype, shape, strides) of a table the
    kernels take, with `override` {name: (dtype, shape)} swapped in."""
    m1 = 2 * n + 2 * hp
    out = []
    for name, (shape, dtype) in zip(cuda_ipm.TABLE,
                                    cuda_ipm._expected(B, n, hp, m2)):
        dtype, shape = override.get(name, (dtype, shape))
        strides, size = [], 1
        for s in reversed(shape):
            strides.insert(0, size)
            size *= s
        out.append((device_type, dtype, shape, tuple(strides)))
    assert len(out) == 30 and m1 == out[3][2][1]
    return out


def test_the_table_the_kernels_take():
    assert cuda_ipm.check_pass(descs()) == (5, 60, 60, 90)
    assert cuda_ipm.check_pass(descs(B=1, m2=30)) == (1, 60, 60, 30)
    assert cuda_ipm.check_pass(descs(n=64, hp=64, m2=256)) == (5, 64, 64, 256)


@pytest.mark.parametrize("bad,match", [
    (dict(device_type="cpu"), "CUDA"),
    (dict(n=65, hp=60), "n <= 64"),
    (dict(m2=257), "m2 <= 256"),
    (dict(A=(F32, (5, 60, 90))), "A: expected"),
    (dict(stall=(F32, (5,))), "stall: expected"),
    (dict(done=(torch.uint8, (5,))), "done: expected"),
    (dict(p_ss=(F32, (1, 90))), "p_ss: expected"),
])
def test_the_table_checks_refuse(bad, match):
    with pytest.raises(ValueError, match=match):
        cuda_ipm.check_pass(descs(**bad))


def test_a_strided_tensor_is_refused():
    table = descs()
    i = cuda_ipm.TABLE.index("q_s")
    dev, dtype, shape, _ = table[i]
    table[i] = (dev, dtype, shape, (0, 1))        # an expanded [B, m2]
    with pytest.raises(ValueError, match="q_s: expected a contiguous"):
        cuda_ipm.check_pass(table)
    with pytest.raises(ValueError, match="expected 30 tensors"):
        cuda_ipm.check_pass(table[:-1])


def test_the_wrappers_refuse_cpu_tensors():
    qp, theta = cpu_qps(2)
    d, spec = qps._prepare(*qp, 60, 3e-5, theta)
    st = qps._start(d, spec, None)
    with pytest.raises(ValueError, match="CUDA"):
        qps._fused_pass(qps._Data(*qps._dense(d)), spec, st.dense())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused pass has no CPU mode")
    return torch.device("cuda")


def mpc_qps(device, batch, n_obs, horizon=30, dtype=F32, seed=0):
    from test_torch_ipm_graph import mpc_qps as make
    return make(device, batch, n_obs, horizon, dtype, seed)


def prepared(args, kwargs, **extra):
    from test_torch_ipm_graph import prepared as prep
    return prep(args, kwargs, **extra)


def rel(a, b) -> float:
    """max |a - b| over max(1, max |b|), lanes NaN in both left out; NaN
    where only one of the two is NaN."""
    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    a, b = a.masked_fill(both, 0.0), b.masked_fill(both, 0.0)
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


# (batch, obstacles, horizon): the benchmark's QP shapes: batch256 and
# paper1500 (768 lanes, n = 60, m2 = 90), mc300 (900, m2 = 30), loop (3,
# 90), hloop (3, 30); one lane; and a horizon of 31 (n = 62, rows staged
# at a padded stride).
SHAPES = {"b768_m90": (768, 3, 30), "b900_m30": (900, 1, 30),
          "b3_m90": (3, 3, 30), "b3_m30": (3, 1, 30), "b1_m90": (1, 3, 30),
          "b64_m93_H31": (64, 3, 31)}
# One pass from a state both passes share, to float32 rounding: the
# iterate's change against the plain pass's, relative to its size.  The
# sums are taken in another order (and the plain pass's Schur matrix is
# cuBLAS's), and a Newton step's rounding grows with S's condition
# number: ~1e-5 measured at the start (H100, 700 W), 1e-4 to 3e-4 after
# four passes, up to ~1e-1 on the few lanes that break down late in a
# solve (the lockstep runs of PERF.md, PR 17), where the plain pass
# itself moves as much under a one-ulp change of q_u.
PASS_RTOL = {"cold": 1e-4, "warm": 1e-4, "mid": 1e-3, "stopped": 1e-3}


def one_pass_both(d, spec, st):
    """(the plain pass's state, the fused pass's) from copies of `st`."""
    plain = qps._one_pass(d, spec, st.dense())
    fused = qps._fused_pass(qps._Data(*qps._dense(d)), spec, st.dense())
    return plain, fused


def start_state(d, spec, start):
    """The state a pass starts from: the cold start, a warm start from a
    nearby solve (q_u moved by 1e-3), the state after four plain passes,
    or that state with every third lane stopped (done, inactive)."""
    if start == "cold":
        return qps._start(d, spec, None)
    if start == "warm":
        moved = d._replace(q_u=d.q_u * (1 + 1e-3))
        sol = qps._ipm_eager(moved, spec, None)
        return qps._start(d, spec, (sol.u, sol.s, *sol.mults))
    st = qps._start(d, spec, None).dense()
    for _ in range(4):
        qps._one_pass(d, spec, st)
    if start == "stopped":
        stop = torch.zeros_like(st.done)
        stop[::3] = True
        st = st._replace(done=st.done | stop, active=st.active & ~stop)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("start", list(PASS_RTOL))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_pass_matches_the_plain_pass(cuda, shape, start):
    """Flags equal, best merit to 1e-5, the iterate and the best iterate
    to PASS_RTOL; a lane stopped before the pass keeps its whole state
    bit for bit."""
    batch, n_obs, horizon = SHAPES[shape]
    args, kwargs = mpc_qps(cuda, batch, n_obs, horizon, seed=11)
    d, spec = prepared(args, kwargs)
    st = start_state(d, spec, start)
    plain, fused = one_pass_both(d, spec, st)
    torch.cuda.synchronize()
    for name in ("done", "stall", "iters", "active"):
        assert torch.equal(getattr(fused, name), getattr(plain, name)), name
    assert rel(fused.best_merit, plain.best_merit) < 1e-5
    names = ("u", "s", "w1", "w2", "w3", "l1", "l2", "l3")
    worst = {k: rel(a, b) for k, a, b in zip(names, fused.x, plain.x)}
    worst.update({"best_" + k: rel(a, b)
                  for k, a, b in zip(names, fused.best, plain.best)})
    print(f"[{shape} {start}] stepping {int(st.active.sum())} of {batch}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    assert max(worst.values()) < PASS_RTOL[start], worst
    idle = ~st.active
    for a, b in zip(fused.flat(), st.flat()):
        a, b = a[idle], b[idle]
        assert torch.equal(a, b) or bool(
            ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def solve_both(monkeypatch, args, kwargs):
    """The fused solve, the plain solve, the plain solve with q_u moved by
    one ulp (the plain pass's own sensitivity to rounding) -- each one
    call of `solve_mpc_qp` (graphs, rescue) -- and the fused solve's
    counters."""
    was, totals = timing.record(True), timing.totals()
    try:
        fused = qps.solve_mpc_qp(*args, **kwargs)
        counts = timing.since(totals)["counts"]
    finally:
        timing.record(was)
    q_ulp = torch.nextafter(args[1], torch.full_like(args[1], float("inf")))
    with monkeypatch.context() as m:
        m.setattr(qps, "use_fused_pass", lambda *a: False)
        plain = qps.solve_mpc_qp(*args, **kwargs)
        ulp = qps.solve_mpc_qp(args[0], q_ulp, *args[2:], **kwargs)
    return fused, plain, ulp, counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["b768_m90", "b900_m30", "b3_m90",
                                   "b3_m30"])
def test_a_solve_matches_the_plain_solve(cuda, monkeypatch, shape):
    """Whole solves: the fused pass changes lanes' iteration counts no
    more than a one-ulp change of q_u changes the plain pass's (float32
    lanes near the stopping line are that sensitive: ~10% of batch256's
    lanes move by a pass either way, PERF.md, PR 17), to 2 points of the
    lanes; the mean iterations within 1% and no fewer lanes converged
    (ipm_passes, ipm_lane_util); objectives to 2e-2 relative, the float32
    solver's floor on lanes whose polish is rejected (ROADMAP F6)."""
    batch, n_obs, horizon = SHAPES[shape]
    args, kwargs = mpc_qps(cuda, batch, n_obs, horizon, seed=12)
    fused, plain, ulp, counts = solve_both(monkeypatch, args, kwargs)

    def share(a, b):
        return float((a.iterations == b.iterations).double().mean())

    mean = [float(s.iterations.double().mean()) for s in (fused, plain)]
    obj = float(((fused.obj - plain.obj).abs()
                 / plain.obj.abs().clamp(min=1.0)).max())
    print(f"[{shape}] iterations equal on {share(fused, plain):.4f} of lanes "
          f"(plain against plain + 1 ulp: {share(ulp, plain):.4f}); mean "
          f"{mean[0]:.4f} / {mean[1]:.4f}; converged "
          f"{int(fused.converged.sum())} / {int(plain.converged.sum())}; "
          f"objective {obj:.2e}")
    assert counts["ipm.fused_passes"] == counts["ipm.passes"] > 1
    assert share(fused, plain) >= share(ulp, plain) - 0.02
    assert abs(mean[0] - mean[1]) <= 0.01 * mean[1]
    assert int(fused.converged.sum()) >= int(plain.converged.sum())
    assert obj < 2e-2


@pytest.mark.cuda
def test_the_seed42_scenarios_agree_with_the_oracle_and_the_plain_pass(
        cuda, monkeypatch):
    """The custom head_on and multi_obstacle scenarios on the reference's
    seed-42 streams through the float32 pipeline on the card: controls
    within 1e-4 of the scipy oracle (the float32 path's gate; F3: the
    oracle first), and the plain pass's iterations on >= 99% of lanes."""
    import numpy as np

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
    from torch_port_streams import oracle_controls, reference_rng_obstacles

    for name in ("head_on", "multi_obstacle"):
        params = pt.config.get_parameters("custom")
        scenario = pt.config.get_scenario_config(name, "custom")
        obs = reference_rng_obstacles(scenario, params.sim_time, params.dt,
                                      params.num_samples)

        def run(dtype, device):
            statics = pt.models.make_statics(scenario, params, dtype, device)
            return pt.models.run_scenario_with_obstacles(
                statics, pt.convert.obstacle_data(obs, dtype, device, True),
                scenario.ego_start, scenario.ego_goal, params.ego_velocity)

        was, totals = timing.record(True), timing.totals()
        try:
            gpu = run(F32, cuda)
            counts = timing.since(totals)["counts"]
        finally:
            timing.record(was)
        with monkeypatch.context() as m:
            m.setattr(qps, "use_fused_pass", lambda *a: False)
            plain = run(F32, cuda)
        cpu = run(F64, "cpu")
        halfspaces = {m: (cpu.halfspaces.by_metric(m).h[0].numpy(),
                          cpu.halfspaces.by_metric(m).g_tilde[0].numpy())
                      for m in pt.models.METRICS}
        oracle = oracle_controls(params, scenario, cpu.x_ref[0].numpy(),
                                 halfspaces)
        u = gpu.filtered_u[0].cpu().double().numpy()
        worst = max(float(np.abs(u[i] - oracle[m]).max())
                    for i, m in enumerate(pt.models.METRICS))
        same = float((gpu.qp_iterations == plain.qp_iterations)
                     .double().mean())
        print(f"[seed42 {name}] |u - u_oracle| {worst:.3e}; iterations "
              f"equal on {same:.4f}")
        assert counts["ipm.fused_passes"] == counts["ipm.passes"] > 0
        assert worst < 1e-4
        assert bool(gpu.qp_converged.all())
        assert torch.equal(gpu.qp_converged, plain.qp_converged)
        assert same >= 0.99


# Solves that keep the plain pass on the card: (batch, obstacles,
# horizon, dtype, settings, box layout).
OFF = {
    "float64": (64, 3, 30, F64, {}, True),
    "dense_G_u": (64, 3, 30, F32, {}, False),
    "H40": (64, 3, 40, F32, {}, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OFF))
def test_these_solves_stay_off_the_fused_pass(cuda, case):
    batch, n_obs, horizon, dtype, extra, box = OFF[case]
    args, kwargs = mpc_qps(cuda, batch, n_obs, horizon, dtype, seed=13)
    kwargs = {**kwargs, **extra}
    if not box:
        kwargs["box_theta"] = None
    d, _ = prepared(args, kwargs)
    assert qps._pass_of(d) is qps._one_pass
    before = [k.launches for k in FUSED_KERNELS]
    was, totals = timing.record(True), timing.totals()
    try:
        qps.solve_mpc_qp(*args, **kwargs)
        counts = timing.since(totals)["counts"]
    finally:
        timing.record(was)
    torch.cuda.synchronize()
    assert counts["ipm.passes"] > 1 and "ipm.fused_passes" not in counts
    assert [k.launches for k in FUSED_KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["graphs", "eager"])
def test_launches_and_fused_passes_equal_the_passes(cuda, path):
    """Each pass launches each fused kernel once, kernel 2 once and kernel
    3 twice (the polish adds 2 and 6 a solve), and counts one fused pass."""
    args, kwargs = mpc_qps(cuda, 48, 3, seed=14)
    d, spec = prepared(args, kwargs)
    assert qps._pass_of(d) is qps._fused_pass
    qps._ipm_graphs(d, spec, None)                     # captures the key
    kernels = FUSED_KERNELS + (cl.batched_cholesky, cl.batched_cho_solve)
    before = [k.launches for k in kernels]
    was, totals = timing.record(True), timing.totals()
    try:
        if path == "graphs":
            qps._ipm_graphs(d, spec, None)
        else:
            qps._ipm_eager(d, spec, None)
        counts = timing.since(totals)["counts"]
    finally:
        timing.record(was)
    torch.cuda.synchronize()
    passes = counts["ipm.passes"]
    assert counts["ipm.fused_passes"] == passes > 1
    assert counts.get("ipm.graph_passes", 0) == (passes if path == "graphs"
                                                 else 0)
    added = [k.launches - b for k, b in zip(kernels, before)]
    assert added == [passes] * 3 + [passes + 2, 2 * passes + 6]


@pytest.mark.cuda
def test_the_caps_are_the_sources(cuda):
    lib = qps.cuda_ipm._build.load().lib
    assert [lib.drcvar_ipm_caps(i) for i in range(4)] == [
        cl.N_MAX, cuda_ipm.HP_MAX, cuda_ipm.M2_MAX, len(cuda_ipm.TABLE)]
    assert cuda_ipm.work_floats(60, 60, 90) == 4 + 3 * 240 + 9 * 90 + 60
