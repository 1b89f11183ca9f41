"""PyTorch port: the structured IPM's CUDA graphs against its op-by-op path,
on the card.

Marked `cuda`; each test skips where torch sees no CUDA device (a CUDA
graph has no CPU mode).  Run on a machine with an H100:

    python -m pytest --noconftest -m cuda tests/test_torch_ipm_graph.py

The QPs are those `_filter_core` assembles from random plans and
halfspaces at the benchmark's shapes; the graph path (`_ipm_graphs`) and
the op-by-op path (`_ipm_eager`) solve the same prepared data, and their
controls, slacks, multipliers, iterations and flags must be bit-equal.
"""

import pytest
import torch

import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments import (
    qpbench)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    cuda_linalg as cl, qp_ipm_structured as qps)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (
    timing)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def mpc_qps(device, batch, n_obs, horizon=30, dtype=torch.float32, seed=0):
    """(args, kwargs) of the `solve_mpc_qp` call that `_filter_core` makes
    for `batch` random plans with `n_obs` obstacles."""
    A, B, C = pt.core.dynamics.create_double_integrator_matrices(
        0.2, dtype=dtype, device=device)
    prob = pt.models.build_mpc_problem(A, B, C, 2.0, 1.0, horizon, n_obs)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device, generator=gen)
    x0 = 0.1 * torch.randn(batch, 4, **kw)
    x_ref = torch.cumsum(0.2 * torch.randn(batch, horizon + 1, 4, **kw), 1)
    hs_h = torch.randn(batch, horizon, n_obs, 2, **kw)
    hs_h = hs_h / hs_h.norm(dim=-1, keepdim=True)
    hs_g = -1.5 + 1.7 * torch.rand(batch, horizon, n_obs, **kw)
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    mod, real = pt.models.mpc_filter, pt.models.mpc_filter.solve_mpc_qp
    mod.solve_mpc_qp = spy
    try:
        box = torch.tensor([5.0, 5.0], dtype=dtype, device=device)
        pos = torch.tensor([10.0, 10.0], dtype=dtype, device=device)
        pt.models.mpc_filter._filter_core(prob, x0, x_ref, hs_h, hs_g, -box,
                                          box, -pos, pos, 60, 3e-5)
    finally:
        mod.solve_mpc_qp = real
    return seen[0]


def prepared(args, kwargs, **extra):
    kwargs = {**kwargs, **extra}
    return qps._prepare(*args, kwargs.get("max_iters", 60),
                        kwargs.get("tol"), kwargs.get("box_theta"))


def assert_bit_equal(a, b):
    for name in ("u", "s", "iterations", "converged", "merit", "obj"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.mults, b.mults):
        assert torch.equal(x, y), "mults"


# (batch, obstacles, horizon, dtype): batch256's, mc300's and loop's
# shapes (the fused pass), float64 and H = 40 (the plain pass).
CASES = {
    "batch256": (768, 3, 30, torch.float32),
    "mc300": (900, 1, 30, torch.float32),
    "loop": (3, 3, 30, torch.float32),
    "float64": (768, 3, 30, torch.float64),
    "H40": (768, 3, 40, torch.float32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graph_path_is_bit_equal_to_the_eager_path(cuda, case):
    """Bit-equal on either pass, the capture's call and a replay."""
    batch, n_obs, horizon, dtype = CASES[case]
    args, kwargs = mpc_qps(cuda, batch, n_obs, horizon, dtype)
    d, spec = prepared(args, kwargs)
    graphs = [qps._ipm_graphs(d, spec, None) for _ in range(2)]
    eager = qps._ipm_eager(d, spec, None)
    for sol in graphs:
        assert_bit_equal(sol, eager)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_a_result_survives_the_next_call(cuda):
    """Results are cloned out of the graphs' buffers: a second call of the
    same key with other data leaves the first call's result as it was."""
    first = mpc_qps(cuda, 96, 3, seed=1)
    second = mpc_qps(cuda, 96, 3, seed=2)
    d1, spec = prepared(*first)
    want = qps._ipm_eager(d1, spec, None)
    got = qps._ipm_graphs(d1, spec, None)
    d2, spec2 = prepared(*second)
    assert qps._graph_key(d1, spec, qps._pass_of(d1)) == \
        qps._graph_key(d2, spec2, qps._pass_of(d2))
    other = qps._ipm_graphs(d2, spec2, None)
    assert not torch.equal(other.u, got.u)
    assert_bit_equal(got, want)


def test_warm_start_replays_like_the_eager_path(cuda):
    args, kwargs = mpc_qps(cuda, 96, 3, seed=3)
    d, spec = prepared(args, kwargs)
    cold = qps._ipm_eager(d, spec, None)
    warm = (cold.u, cold.s, *cold.mults)
    assert_bit_equal(qps._ipm_graphs(d, spec, warm),
                     qps._ipm_eager(d, spec, warm))


@pytest.mark.parametrize("name", ["pnone", "pref0", "pnotopk", "diag"])
def test_a_qpbench_rebinding_is_replayed_as_itself(cuda, name):
    """A variant drops the cached graphs on its way in and out: its graphs
    run the variant, and the plain solver's graphs after it are the
    plain solver's again."""
    args, kwargs = mpc_qps(cuda, 96, 3, seed=4)
    d, spec = prepared(args, kwargs)
    plain = qps._ipm_graphs(d, spec, None)
    with qpbench.variant(name):
        eager = qps._ipm_eager(d, spec, None)
        assert_bit_equal(qps._ipm_graphs(d, spec, None), eager)
    if name == "pnone":
        assert not torch.equal(eager.u, plain.u)
    assert_bit_equal(qps._ipm_graphs(d, spec, None), plain)


def test_replays_count_the_kernels_and_the_graph_passes(cuda):
    """Each replay adds its captured launches of kernels 2 and 3, and with
    the recorder on every pass of a solve is a graph pass."""
    args, kwargs = mpc_qps(cuda, 48, 3, seed=5)
    sol = qps.solve_mpc_qp(*args, **kwargs)           # captures the key
    before = (cl.batched_cholesky.launches, cl.batched_cho_solve.launches)
    was, totals = timing.record(True), timing.totals()
    try:
        again = qps.solve_mpc_qp(*args, **kwargs)
        added = timing.since(totals)["counts"]
    finally:
        timing.record(was)
    torch.cuda.synchronize()
    passes = added["ipm.passes"]
    assert torch.equal(again.u, sol.u)
    assert added["ipm.graph_passes"] == passes > 1
    assert (cl.batched_cholesky.launches - before[0],
            cl.batched_cho_solve.launches - before[1]) == \
        (passes + 2, 2 * passes + 6)


def test_the_cache_keeps_the_most_recent_keys(cuda):
    keys = []
    for batch in range(1, qps.GRAPH_CACHE_SIZE + 3):
        args, kwargs = mpc_qps(cuda, batch, 1, seed=batch)
        d, spec = prepared(args, kwargs)
        keys.append(qps._graph_key(d, spec, qps._pass_of(d)))
    assert len(qps._GRAPHS) == qps.GRAPH_CACHE_SIZE
    assert list(qps._GRAPHS)[-qps.GRAPH_CACHE_SIZE:] == \
        keys[-qps.GRAPH_CACHE_SIZE:]
