"""The ranks' (data x model) grid over torch.distributed (port of
``tpuasr/parallel/mesh.py``).

The JAX package puts every chip in one `jax.sharding.Mesh` and lets XLA
insert the collectives. Here each rank is a process: `init_distributed`
joins the process group (NCCL for CUDA tensors, gloo for CPU ones), and
`make_mesh` lays the ranks out as the JAX mesh lays its devices out,
``reshape(n // mp, mp)``: rank r is data rank r // mp and model rank r % mp.
The ranks of one data group (one model rank, every data rank) hold
different batch rows and reduce gradients; the ranks of one model group
(one data rank) hold the same rows and split the joint's vocabulary.

With no distributed environment `init_distributed` creates no group and
everything runs as one rank: a world of one changes no number.

Every collective the port's steps issue goes through `all_reduce` or
`all_gather_flat`, so `scaling.record_collectives()` sees them all.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from tpuasr_torch.parallel import scaling

# the default bound of every wait on another rank: a rank that stops
# answering makes the others raise after this long instead of waiting forever
TIMEOUT_S = 600.0


def init_distributed(device=None, store_path: str | None = None, rank: int | None = None,
                     world_size: int | None = None, backend: str | None = None,
                     timeout_s: float = TIMEOUT_S) -> tuple[int, int, torch.device]:
    """Join the process group -> (world size, rank, this rank's device).

    The group comes from torchrun's variables (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or, with `store_path`, from a
    FileStore there with the given `rank` and `world_size`. `device` is the
    type ("cuda" by default, or "cpu"): CUDA ranks take cuda:LOCAL_RANK and
    NCCL, CPU ranks gloo; `backend` overrides the choice (gloo serves CUDA
    tensors too, e.g. two ranks on one card, which NCCL refuses). Every
    collective waits at most `timeout_s`. With neither the variables nor a
    store: world size 1, no group, `device` as `resolve_device` gives it."""
    import torch.distributed as dist

    from tpuasr_torch.device import resolve_device

    dev = resolve_device(device)
    if store_path is None and "WORLD_SIZE" not in os.environ:
        return 1, 0, dev
    if store_path is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore needs the rank and the world size")
        local = rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"rank": rank, "world_size": world_size,
          "timeout": datetime.timedelta(seconds=timeout_s)}
    if backend == "nccl":
        kw["device_id"] = dev  # binds the group to this rank's card
    if not dist.is_initialized():
        if store_path is not None:
            kw["store"] = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, **kw)
    return dist.get_world_size(), dist.get_rank(), dev


def rank_grid(world_size: int, model_parallel_size: int = 1) -> np.ndarray:
    """[world // mp, mp] ranks: row = data rank, column = model rank, as
    `tpuasr.parallel.make_mesh` reshapes its devices."""
    if world_size % model_parallel_size:
        raise ValueError(f"mesh.model_parallel_size {model_parallel_size} does not divide the "
                         f"world size {world_size}")
    return np.arange(world_size).reshape(world_size // model_parallel_size,
                                         model_parallel_size)


def vocab_range(vocab: int, parts: int, index: int) -> tuple[int, int]:
    """Model rank `index`'s contiguous columns [v0, v1) of a vocabulary split
    into `parts` slices of ceil(vocab / parts) (the last one shorter), as
    `P(..., "model")` splits the joint's last axis (joint_logits_spec)."""
    chunk = -(-vocab // parts)
    if chunk * (parts - 1) >= vocab:
        raise ValueError(f"a vocabulary of {vocab} leaves a model rank of {parts} no column")
    return index * chunk, min(vocab, (index + 1) * chunk)


@dataclass(frozen=True)
class VocabShard:
    """A model group's split of the joint's vocabulary: the group, this
    rank's index in it, its size."""

    group: Any
    rank: int
    size: int

    def range(self, vocab: int) -> tuple[int, int]:
        return vocab_range(vocab, self.size, self.rank)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x model) grid, its device and the two
    subgroups it belongs to. A mesh built directly (groups None) describes
    a layout and runs no collective; `make_mesh` builds a working one."""

    world_size: int
    rank: int
    model_parallel_size: int = 1
    device: torch.device = torch.device("cpu")
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        rank_grid(self.world_size, self.model_parallel_size)  # checks the divisibility
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of {self.world_size}")

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_parallel_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel_size

    def vocab_shard(self) -> Optional[VocabShard]:
        """The model axis as the joint splits it; None with one model rank."""
        if self.model_parallel_size == 1:
            return None
        return VocabShard(self.model_group, self.model_rank, self.model_parallel_size)

    def _group(self, axis: str):
        group, size = ((self.data_group, self.data_size) if axis == "data"
                       else (self.model_group, self.model_parallel_size))
        if size > 1 and group is None:
            raise RuntimeError(f"this mesh describes a layout only: its {axis} axis of {size} "
                               f"ranks has no process group (make_mesh builds one)")
        return group if size > 1 else None

    def reduce(self, t: torch.Tensor, axis: str = "data", op: str = "sum") -> torch.Tensor:
        """In place: `t` all-reduced over the `axis` group; the identity with
        one rank on the axis."""
        return all_reduce(t, self._group(axis), op)

    def gather(self, x: torch.Tensor, axis: str = "data",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every `axis` rank's equal-length 1-D `x`, concatenated in rank
        order (into `out` when given)."""
        size = self.data_size if axis == "data" else self.model_parallel_size
        return all_gather_flat(x, self._group(axis), size, out)


def make_mesh(model_parallel_size: int = 1, device=None) -> Mesh:
    """The mesh over the initialized process group (or a world of one):
    every rank creates every data and model subgroup in the same order, as
    `torch.distributed.new_group` requires, and keeps its own two. (The
    axes' names, `mesh.data_axis` and `mesh.model_axis`, name the JAX
    mesh's axes; here the axes are the two groups.)"""
    import torch.distributed as dist

    dev = torch.device("cpu") if device is None else torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(1, 0, model_parallel_size, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = rank_grid(world, model_parallel_size)
    data_group = model_group = None
    for col in grid.T:  # a data group: one model rank, every data rank
        g = dist.new_group(col.tolist())
        if rank in col:
            data_group = g
    for row in grid:  # a model group: one data rank, every model rank
        g = dist.new_group(row.tolist())
        if rank in row:
            model_group = g
    return Mesh(world, rank, model_parallel_size, dev, data_group, model_group)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's contiguous block of rows of every array in `batch`
    (tensors, numpy arrays and lists of one entry a row; scalars and 0-d
    arrays as they are), as `NamedSharding(mesh, P("data"))` places rows on
    the devices. Every array's rows must divide by the data size."""
    n, i = mesh.data_size, mesh.data_rank
    out = {}
    for k, v in batch.items():
        if isinstance(v, list) or (isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1):
            if len(v) % n:
                raise ValueError(f"batch[{k!r}] has {len(v)} rows, not a multiple of the data "
                                 f"size {n}")
            step = len(v) // n
            out[k] = v[i * step:(i + 1) * step]
        else:
            out[k] = v
    return out


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce over `group` (sum | max | min); the identity
    without a group. One of the port's two collective choke points: an open
    `scaling.record_collectives()` notes it."""
    if group is None:
        return t
    import torch.distributed as dist

    if scaling.recording():
        scaling.note("all-reduce", t.numel() * t.element_size(),
                     dist.get_process_group_ranks(group))
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op], group=group)
    return t


def all_gather_flat(x: torch.Tensor, group, size: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate every rank's equal-length 1-D `x` in rank order -> [size *
    len(x)] (written into `out` when given); the list form of all_gather,
    which NCCL and gloo both take on CUDA tensors. The other collective
    choke point (payload: the gathered bytes)."""
    if out is None:
        out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    if group is None:
        return out.copy_(x)
    import torch.distributed as dist

    if scaling.recording():
        scaling.note("all-gather", size * x.numel() * x.element_size(),
                     dist.get_process_group_ranks(group))
    dist.all_gather(list(out.split(x.numel())), x.contiguous(), group=group)
    return out


def barrier(group=None) -> None:
    """Wait for every rank of `group` (default: all), bounded by the process
    group's timeout; nothing without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)
