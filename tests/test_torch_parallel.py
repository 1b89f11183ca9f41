"""PyTorch port: `parallel/` on Gloo CPU ranks, against the JAX package's
`parallel/` on the conftest's virtual mesh of the same shape.

Mirrors tests/test_parallel.py.  Two clusters run once each (a module
fixture), 2 and 4 spawned ranks (tests/torch_parallel_worker.py):

  * sample-parallel DR-CVaR at mesh shapes (1, 2), (2, 2) and (1, 4),
    with B replicated and with B over data: against JAX
    `dr_cvar_g_sample_parallel` and `dr_cvar_g_star`, rtol 1e-6 / atol
    1e-6 on float64 inputs (keys and the tail in float32, as in JAX); the
    k-th value bit-equal to `torch.kthvalue`; rounds printed beside
    JAX's (not required equal: the moment sums add in another order);
  * `sharded_halfspace_throughput` at data = 4 against JAX;
  * `make_sharded_timing_solvers` at data = 4, B = 11 and B = 1 (the pad
    exceeds B), against the port's plain solvers: rtol 1e-6, atol 1e-8;
  * `run_batch_sharded` at data = 2 and Monte Carlo at data = 4 (10 runs,
    pad 2): `equal` to the meshless runs of the same seeds, both dtypes
    (on the CPU a batch's split changes no bit);
  * the collective census: one collective a data-split batch, rounds + 4
    a sample-parallel solve.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
    dr_cvar_g_star as j_g_star)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel import (
    dr_cvar_g_sample_parallel as j_sample_parallel, make_mesh as j_make_mesh,
    sharded_halfspace_throughput as j_throughput)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel.sample_parallel import (
    _distributed_kth_largest as j_kth, shard_map as j_shard_map)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation.monte_carlo import (
    run_seeds)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation.timing_analysis import (
    _make_batched_solvers)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.parallel.mesh import (
    block_rows)

import torch_parallel_worker as tw

ARGS = tw.ARGS
SHAPES = [(1, 2), (2, 2), (1, 4)]
SP_INPUTS = {shape: tw.sample_inputs(10 + i, 6, 64)
             for i, shape in enumerate(SHAPES)}
TP_INPUTS = tw.sample_inputs(2, 16, 32)
TIMING = {B: np.array([0.5, 0.0]) + 0.1 * np.random.default_rng(7 + B)
          .normal(size=(B, 40, 2)) for B in (11, 1)}
SEEDS = run_seeds(0, 6)
DTYPES = [torch.float64, torch.float32]


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    out = tw.run_cluster(2, tw.world2_checks,
                         (*SP_INPUTS[(1, 2)], SEEDS),
                         str(tmp_path_factory.mktemp("gloo2")))
    return {(1, 2): out}


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    out = tw.run_cluster(
        4, tw.world4_checks,
        ({s: SP_INPUTS[s] for s in SHAPES[1:]}, TP_INPUTS, TIMING),
        str(tmp_path_factory.mktemp("gloo4")))
    return out


@pytest.fixture
def sp_results(request, cluster2, cluster4):
    shape = request.param
    ranks = cluster2[shape] if shape == (1, 2) else cluster4
    return shape, [r["sp"] if shape == (1, 2) else r[shape] for r in ranks]


def _j_sample_parallel(shape, samples, h, over_data):
    from jax.sharding import PartitionSpec as P
    mesh = j_make_mesh(n_data=shape[0], n_samples=shape[1])
    spec = P("data" if over_data else None, "samples", None)
    solve = jax.jit(lambda x, y: j_sample_parallel(
        mesh, x, y, *ARGS, batch_axis_spec=spec))
    return np.asarray(solve(jnp.asarray(samples), jnp.asarray(h)))


@pytest.mark.parametrize("over_data", [False, True],
                         ids=["B_replicated", "B_over_data"])
@pytest.mark.parametrize("sp_results", SHAPES, indirect=True,
                         ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_sample_parallel_matches_jax(sp_results, over_data):
    shape, ranks = sp_results
    samples, h = SP_INPUTS[shape]
    g_jax = _j_sample_parallel(shape, samples, h, over_data)
    g_ref, _ = j_g_star(jnp.asarray(samples), jnp.asarray(h), *ARGS)
    for out in ranks:
        g, rounds, collectives = out[over_data]
        assert g.dtype == np.float64 and g.shape == (6,)
        np.testing.assert_allclose(g, g_jax, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-6,
                                   atol=1e-6)
        assert 1 <= rounds <= 22
        # Rounds + 4; the split batch adds its one gather.
        assert collectives == rounds + 4 + over_data
    np.testing.assert_array_equal(ranks[0][over_data][0],
                                  ranks[-1][over_data][0])


@pytest.mark.parametrize("sp_results", SHAPES, indirect=True,
                         ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_sample_parallel_kth_value_bit_equal_to_kthvalue(sp_results):
    shape, ranks = sp_results
    samples, h = SP_INPUTS[shape]
    s = pt.ops.halfspace._project(torch.as_tensor(samples),
                                  torch.as_tensor(h))
    x = (-s).to(torch.float32)
    for out in ranks:
        v, k, _ = out["kth"]
        ref = torch.kthvalue(x, x.shape[-1] - k + 1, dim=-1).values
        assert torch.equal(torch.as_tensor(v), ref)


@pytest.mark.parametrize("sp_results", SHAPES, indirect=True,
                         ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_sample_parallel_rounds_beside_jax(sp_results):
    """The port's bisection rounds beside JAX's `return_rounds=True` on
    the same rows (printed; equal rounds are not required)."""
    from jax.sharding import Mesh, PartitionSpec as P
    shape, ranks = sp_results
    samples, h = SP_INPUTS[shape]
    n = samples.shape[1]
    k = ranks[0]["kth"][1]
    x = -jnp.einsum("bnd,bd->bn", jnp.asarray(samples), jnp.asarray(h))
    mesh = Mesh(np.asarray(jax.devices()[:shape[1]]).reshape(1, -1),
                axis_names=("data", "samples"))
    probe = j_shard_map(
        functools.partial(j_kth, k=k, n_global=n, axis_name="samples",
                          return_rounds=True),
        mesh=mesh, in_specs=P(None, "samples"),
        out_specs=(P(None), P(None), P()), check_vma=False)
    v_jax, _, rounds_jax = jax.jit(probe)(x)
    v, _, rounds = ranks[0]["kth"]
    print(f"mesh {shape}: rounds {rounds} (port) / {int(rounds_jax)} (JAX)")
    np.testing.assert_array_equal(v, np.asarray(v_jax, np.float32))
    assert 1 <= rounds <= 22 and 1 <= int(rounds_jax) <= 22


def test_sharded_halfspace_throughput_matches_jax(cluster4):
    samples, h = TP_INPUTS
    g_jax = j_throughput(j_make_mesh(n_data=4), jnp.asarray(samples),
                         jnp.asarray(h), *ARGS)
    g_ref, _ = pt.ops.dr_cvar_g_star(torch.as_tensor(samples),
                                     torch.as_tensor(h), *ARGS)
    for out in cluster4:
        np.testing.assert_allclose(out["throughput"], np.asarray(g_jax),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(torch.as_tensor(out["throughput"]), g_ref)


@pytest.mark.parametrize("B", [11, 1])
def test_sharded_timing_solvers_match_plain(cluster4, B):
    dr_p, cv_p = _make_batched_solvers(pt.config.Parameters())
    x = torch.as_tensor(TIMING[B])
    h = torch.as_tensor(np.array([1.0, 1.0]) / np.sqrt(2.0))
    for out in cluster4:
        dr, cv = out["timing"][B]
        assert dr.shape == cv.shape == (B,)
        np.testing.assert_allclose(dr, dr_p(x, h).numpy(), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(cv, cv_p(x, h).numpy(), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_run_batch_sharded_equals_meshless(cluster2, dtype):
    ref = tw.meshless_pipeline_batch(pt, dtype, SEEDS)
    for out in cluster2[(1, 2)]:
        (min_d, ref_min, conv), collectives = out[str(dtype)]
        assert min_d.shape == (6, 3) and ref_min.shape == (6,)
        assert conv.dtype == np.bool_
        for ours, theirs in zip((min_d, ref_min, conv), ref):
            assert torch.equal(torch.as_tensor(ours), torch.as_tensor(theirs))
        assert collectives == 1


def test_replicated_is_rank_0s_value(cluster2):
    for out in cluster2[(1, 2)]:
        assert out["replicated"] == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_monte_carlo_mesh_equals_meshless(cluster4, dtype):
    min_d, conv = tw.monte_carlo(pt, dtype)
    for out in cluster4:
        m_min_d, m_conv = out["mc"][str(dtype)]
        assert m_min_d.shape == (10, 4)
        assert torch.equal(torch.as_tensor(m_min_d), torch.as_tensor(min_d))
        assert torch.equal(torch.as_tensor(m_conv), torch.as_tensor(conv))


@pytest.mark.parametrize("program", ["pipeline_data_split",
                                     "halfspace_data_split",
                                     "halfspace_sample_split"])
def test_collective_census(cluster4, program):
    """One collective a data-split batch, whatever the IPM's iterations;
    rounds + 4 a sample-parallel solve (parallel/scaling.py)."""
    for out in cluster4:
        entry = out["census"][program]
        assert entry["total"] == entry["expected"], entry
        if program != "halfspace_sample_split":
            assert entry["census"] == {"all_reduce_sum@world": 1}


@pytest.mark.parametrize("n_pad", [1, 9, 10, 11, 300, 1025])
def test_run_seeds_are_prefix_stable(n_pad):
    """A mesh's padded draw starts with the plain draw's seeds."""
    for seed in (0, 42):
        longer = run_seeds(seed, n_pad + 7)
        assert run_seeds(seed, n_pad) == longer[:n_pad]


@pytest.mark.parametrize("n,d", [(3, 8), (10, 4), (16, 8), (1, 4)])
def test_blocks_cover_the_batch_by_wrapping(n, d):
    """Every data index gets ceil(n/d) rows; the blocks in order are the
    batch padded by wrapping, so the pad may exceed n."""
    rows = [block_rows(n, types.SimpleNamespace(
        shape={"data": d, "samples": 1}, coordinate=(i, 0))) for i in range(d)]
    b = -(-n // d)
    assert all(len(r) == b for r in rows)
    assert torch.cat(rows).tolist() == [j % n for j in range(d * b)]
