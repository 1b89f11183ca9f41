"""Multi-host execution: process-group set-up and the host-aware mesh.

Port of the JAX package's parallel/distributed.py.  The layout rule is
the same:

  * `data` (independent instances) lies over HOSTS: the only traffic
    between hosts is the final gather of results;
  * `samples` (the N samples of one DR-CVaR solve) lies over one host's
    local ranks, whose per-round reductions must never cross hosts.

Under `torchrun` a rank's host is its `GROUP_RANK` and a host runs
`LOCAL_WORLD_SIZE` ranks.  `to_global_array` has no counterpart: every
rank holds the host value and takes its block itself
(`mesh.shard_batch`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..config.parameters import DEFAULT_DEVICE
from .mesh import (CENSUS, Mesh, backend_for, mesh_from_grid, rank_device,
                   _ensure_process_group)


def _launched() -> bool:
    """Whether torchrun (or another launcher) set the env:// variables."""
    return all(v in os.environ for v in ("MASTER_ADDR", "MASTER_PORT",
                                         "RANK", "WORLD_SIZE"))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None,
                           device=DEFAULT_DEVICE) -> bool:
    """Set up the default process group for a multi-process run.

    Idempotent.  With `coordinator_address` ("host:port") the group
    meets there (`num_processes`, `process_id` required); without it,
    from torchrun's environment where that is set.  At one process with
    no coordinator (`num_processes <= 1`, or neither a coordinator nor a
    launcher) it returns False and touches nothing.  The backend follows
    this rank's device: `cuda:local_device_ids[0]` where given, else
    `device` (see `mesh.rank_device`).  Returns True when a group of
    more than one process is (now) active.
    """
    if (num_processes is not None and num_processes <= 1
            and coordinator_address is None):
        return False
    if not dist.is_initialized():
        if coordinator_address is None and not _launched():
            return False
        if local_device_ids is not None:
            device = f"cuda:{list(local_device_ids)[0]}"
        backend = backend_for(rank_device(device))
        if coordinator_address is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def multihost_grid(hosts, n_hosts: int | None = None,
                   devices_per_host: int | None = None):
    """The [n_hosts][devices_per_host] grid of ranks for the host of each
    rank (`hosts[r]`): ranks in order of (host, rank), a mesh row per
    host.  Raises the JAX package's ValueErrors: `n_hosts` that is not
    the number of hosts, ranks that do not divide evenly over the hosts,
    a mesh larger than the world, a row that spans hosts."""
    ranks = sorted(range(len(hosts)), key=lambda r: (hosts[r], r))
    n_real = len(set(hosts))
    if n_hosts is None:
        n_hosts = n_real
    elif n_hosts != n_real:
        raise ValueError(
            f"n_hosts={n_hosts} but the run has {n_real} hosts; the data "
            "axis must match host boundaries so sample-axis collectives "
            "never cross hosts.")
    if devices_per_host is None:
        if len(ranks) % n_hosts != 0:
            raise ValueError(
                f"{len(ranks)} ranks do not divide evenly over {n_hosts} "
                "hosts; pass devices_per_host explicitly -- silently "
                "dropping ranks would hide capacity.")
        devices_per_host = len(ranks) // n_hosts
    used = n_hosts * devices_per_host
    if used > len(ranks):
        raise ValueError(f"mesh needs {used} ranks but only {len(ranks)} "
                         "exist")
    grid = [ranks[i * devices_per_host:(i + 1) * devices_per_host]
            for i in range(n_hosts)]
    for row in grid:
        row_hosts = {hosts[r] for r in row}
        if len(row_hosts) != 1:
            raise ValueError(
                f"mesh row spans hosts {sorted(row_hosts)}: per-host rank "
                "counts must be uniform so the samples axis stays "
                "intra-host")
    return grid


def make_multihost_mesh(n_hosts: int | None = None,
                        devices_per_host: int | None = None,
                        device=DEFAULT_DEVICE) -> Mesh:
    """The host-aware mesh: data over hosts, samples over each host's
    local ranks.

    Every rank's host (`GROUP_RANK`, 0 without a launcher) is gathered
    once; `multihost_grid` lays the mesh out and raises where the layout
    does not hold.  The mesh must use every rank.
    """
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    owns = _ensure_process_group(device)
    hosts = [None] * dist.get_world_size()
    CENSUS[("all_gather_object", "world")] += 1
    dist.all_gather_object(hosts, int(os.environ.get("GROUP_RANK", "0")))
    try:
        grid = multihost_grid(hosts, n_hosts, devices_per_host)
        return mesh_from_grid(grid, device, owns)
    except ValueError:
        if owns:
            dist.destroy_process_group()
        raise
