"""The (data, samples) mesh over processes, and its collectives.

Port of the JAX package's parallel/mesh.py.  The JAX mesh is one process
driving a grid of devices through `shard_map`; PyTorch's idiom is one
process (a rank) per device.  So the port's mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks with the dimension
names ("data", "samples"), rank r at (r // samples, r % samples):

  * `data`: independent problem instances (Monte Carlo runs, timing
    cells, halfspace batches) split into one contiguous block a data
    index;
  * `samples`: the N samples of one DR-CVaR solve split over the ranks of
    a data row, whose reductions become `all_reduce`s
    (parallel/sample_parallel.py).

Each rank owns one device: `cuda:LOCAL_RANK`, or the device the caller
names (two ranks share a card only when it is named), or the CPU when
asked.  The backend is NCCL for CUDA and Gloo for the CPU.  Under
`torchrun` the process group comes from its environment; in one process
without it, `make_mesh` sets up a world of one itself, so a data=1 mesh
needs no launcher and still goes through the real collectives.

Every collective of `parallel/` goes through `all_reduce` / `broadcast`
/ `barrier` below, which count their calls by op and mesh axis in
`CENSUS`, as the kernel wrappers count their launches.  The census takes
the place of the JAX package's count of collectives in compiled HLO
(parallel/scaling.py).

`data_sharding` has no counterpart: a rank holds its block as an
ordinary tensor (`shard_batch`), and `gather_batch` brings the blocks
back to every rank.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch
import torch.distributed as dist

from ..config.parameters import DEFAULT_DEVICE
from ..ops import _build

AXES = ("data", "samples")

# Collective calls of parallel/, by (op, axis) with axis one of "world",
# "data", "samples".  Reset it (`CENSUS.clear()`) before the run it
# should count.
CENSUS: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """This rank's device.  A CUDA device without an index is
    `cuda:LOCAL_RANK`, which must exist: a rank with no card of its own
    raises.  A named device is taken as it is, so ranks share a card only
    where the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"local rank {local} has no CUDA device of its own ({count} "
                "visible); name a device (e.g. cuda:0) to share one, or "
                "pass cpu")
        dev = torch.device("cuda", local)
    return dev


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, samples) DeviceMesh and this rank's device.

    `owns_process_group`: the mesh set up the default process group, and
    `close()` destroys it."""

    device_mesh: object          # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    owns_process_group: bool = False

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.device_mesh.shape))

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def coordinate(self) -> tuple[int, int]:
        """(data index, sample index) of this rank."""
        return tuple(self.device_mesh.get_coordinate())

    def group(self, axis: str):
        """The process group of `axis` ("world", "data" or "samples")
        that holds this rank."""
        return None if axis == "world" else self.device_mesh.get_group(axis)

    def close(self) -> None:
        if self.owns_process_group and dist.is_initialized():
            dist.destroy_process_group()


def all_reduce(t: torch.Tensor, op: str, mesh: Mesh, axis: str):
    """In-place `all_reduce` of `t` over `axis` with op "sum", "max" or
    "min"; counted in CENSUS.  Returns t."""
    CENSUS[(f"all_reduce_{op}", axis)] += 1
    dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0):
    """In-place broadcast of `t` from rank `src`; counted in CENSUS."""
    CENSUS[("broadcast", "world")] += 1
    dist.broadcast(t, src=src)
    return t


def barrier() -> None:
    CENSUS[("barrier", "world")] += 1
    dist.barrier()


def _ensure_process_group(device: torch.device) -> bool:
    """Set up the default process group if there is none: from torchrun's
    environment where it is set, else a world of one.  Returns whether it
    was set up here."""
    if dist.is_initialized():
        return False
    from .distributed import initialize_distributed
    if not initialize_distributed(device=device) and not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    return True


def _load_kernels_once(device: torch.device) -> None:
    """Build the kernels on local rank 0 first: the other local ranks wait
    at a barrier and then load its build instead of running nvcc too."""
    if device.type != "cuda" or int(os.environ.get("LOCAL_WORLD_SIZE",
                                                   "1")) <= 1:
        return
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        _build.load()
    barrier()


def mesh_from_grid(grid, device: torch.device, owns: bool = False) -> Mesh:
    """A Mesh over the ranks of `grid` ([data][samples] rank numbers),
    which must hold every rank of the world once."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.as_tensor(grid, dtype=torch.int64)
    world = dist.get_world_size()
    if sorted(ranks.flatten().tolist()) != list(range(world)):
        raise ValueError(f"a mesh of shape {tuple(ranks.shape)} must hold "
                         f"each of the {world} ranks once, got "
                         f"{ranks.tolist()}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _load_kernels_once(device)
    return Mesh(DeviceMesh(device.type, ranks, mesh_dim_names=AXES), device,
                owns)


def make_mesh(n_data: int | None = None, n_samples: int = 1,
              device=DEFAULT_DEVICE) -> Mesh:
    """The (data, samples) mesh over all ranks, this rank on `device`
    (see `rank_device`).  `n_data` defaults to world size / n_samples;
    n_data * n_samples must equal the world size."""
    device = rank_device(device)
    owns = _ensure_process_group(device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_samples
    if n_data * n_samples != world:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"a (data={n_data}, samples={n_samples}) mesh needs "
                         f"{n_data * n_samples} processes, {world} running")
    grid = torch.arange(world).reshape(n_data, n_samples)
    return mesh_from_grid(grid, device, owns)


def block_rows(n: int, mesh: Mesh) -> torch.Tensor:
    """Row indices of this rank's block of a batch of n: the data index
    i takes rows [i b, (i + 1) b) of the batch padded by wrapping to
    n_data * b rows, b = ceil(n / n_data).  The fill may exceed n (n = 3
    over data = 8 needs 5 fill rows)."""
    d = mesh.shape["data"]
    b = -(-n // d)
    i = mesh.coordinate[0]
    return torch.arange(i * b, (i + 1) * b) % n


def shard_batch(x: torch.Tensor, mesh: Mesh, batch_axis: int = 0):
    """This rank's block of `x` (the same on every rank) along
    `batch_axis`; every block has the same size (see `block_rows`)."""
    rows = block_rows(x.shape[batch_axis], mesh).to(x.device)
    return x.index_select(batch_axis, rows)


def gather_batch(x_local: torch.Tensor, mesh: Mesh, n: int,
                 batch_axis: int = 0):
    """The whole batch of n rows on every rank, from each data index's
    block, with ONE collective: an all_reduce(SUM) of a zero-filled
    buffer into which the first rank of each data row writes its block
    (the ranks of a row hold the same block).  Adding zeros is exact, so
    every value arrives as it was computed."""
    d, b = mesh.shape["data"], x_local.shape[batch_axis]
    i, s = mesh.coordinate
    shape = list(x_local.shape)
    shape[batch_axis] = d * b
    full = x_local.new_zeros(shape)
    if s == 0:
        full.narrow(batch_axis, i * b, b).copy_(x_local)
    all_reduce(full, "sum", mesh, "world")
    return full.narrow(batch_axis, 0, n)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` as rank 0 holds it, on every rank (in place)."""
    return broadcast(x, mesh)
