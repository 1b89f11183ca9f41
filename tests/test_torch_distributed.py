"""PyTorch port: the multi-host layer (parallel/distributed.py), mirroring
tests/test_distributed.py and tests/distributed_worker.py.

  * in-process: `initialize_distributed` at one process, the host-aware
    layout (`multihost_grid`) for emulated hosts and its errors, and the
    placing of ranks on devices;
  * a real 2-host x 2-rank Gloo cluster, each rank with the environment
    torchrun sets on two nodes (GROUP_RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE), running the JAX worker's three checks against
    JAX `dr_cvar_g_star` computed here: the sample-parallel solve over
    the host mesh (B over hosts), a data-parallel batch over all four
    ranks, and the pipeline batch over the hosts against the meshless
    run.  Tolerances are the JAX worker's (2e-5), the pipeline `equal`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
    dr_cvar_g_star as j_g_star)
import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as pt
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.evaluation.monte_carlo import (
    run_seeds)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.parallel import (
    initialize_distributed, multihost_grid)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.parallel.mesh import (
    rank_device)

import torch_parallel_worker as tw


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(num_processes=1) is False
    assert initialize_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("hosts,n_hosts,grid", [
    ([0, 0, 1, 1], None, [[0, 1], [2, 3]]),
    ([0, 0, 0, 0], None, [[0, 1, 2, 3]]),
    ([1, 1, 0, 0], 2, [[2, 3], [0, 1]]),
    ([0, 1, 0, 1], None, [[0, 2], [1, 3]]),
    ([0], None, [[0]]),
])
def test_multihost_grid_emulated_layouts(hosts, n_hosts, grid):
    """A mesh row per host, the host's ranks in order (the port's
    counterpart of the JAX emulated layout on one process's devices)."""
    assert multihost_grid(hosts, n_hosts) == grid


@pytest.mark.parametrize("hosts,kwargs,match", [
    ([0, 0, 1, 1], dict(n_hosts=4), "n_hosts=4 but the run has 2 hosts"),
    ([0, 0, 0, 1, 1], {}, "do not divide evenly"),
    ([0, 0, 1, 1], dict(devices_per_host=3), "needs 6 ranks but only 4"),
    ([0, 0, 0, 1], {}, "row spans hosts"),
])
def test_multihost_grid_errors(hosts, kwargs, match):
    with pytest.raises(ValueError, match=match):
        multihost_grid(hosts, **kwargs)


def test_a_rank_without_a_card_raises(monkeypatch):
    """The default device is the card: with none (or a local rank past the
    cards) placing the rank raises; it never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no CUDA device of its own"):
        rank_device()
    assert rank_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert rank_device() == torch.device("cuda", 0)
    assert rank_device("cpu") == torch.device("cpu")


def test_make_mesh_on_the_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.parallel.make_mesh(1)
    assert not dist.is_initialized()


def test_two_host_cluster(tmp_path):
    rng = np.random.default_rng(7)
    samples = np.asarray(rng.normal(size=(6, 64, 2)), np.float32)
    h = np.asarray(rng.normal(size=(6, 2)), np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    big = np.asarray(rng.normal(size=(16, 64, 2)), np.float32)
    hb = np.asarray(rng.normal(size=(16, 2)), np.float32)
    hb /= np.linalg.norm(hb, axis=-1, keepdims=True)
    seeds = run_seeds(0, 8)
    envs = [{"GROUP_RANK": str(r // 2), "LOCAL_RANK": str(r % 2),
             "LOCAL_WORLD_SIZE": "2"} for r in range(4)]
    outs = tw.run_cluster(4, tw.multihost_checks,
                          (samples, h, big, hb, seeds), str(tmp_path),
                          envs=envs)

    g_ref, _ = j_g_star(jnp.asarray(samples), jnp.asarray(h), *tw.ARGS)
    g_dp_ref, _ = j_g_star(jnp.asarray(big), jnp.asarray(hb), *tw.ARGS)
    pipe_ref = tw.meshless_pipeline_batch(pt, torch.float32, seeds)
    for rank, out in enumerate(outs):
        # Each mesh row is one host's ranks.
        assert out["row"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        np.testing.assert_allclose(out["sp"], np.asarray(g_ref), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(out["dp"], np.asarray(g_dp_ref),
                                   rtol=2e-5, atol=2e-5)
        for ours, theirs in zip(out["pipe"], pipe_ref):
            assert torch.equal(torch.as_tensor(ours), torch.as_tensor(theirs))
