"""A (data, model) mesh over the ranks of a `torch.distributed` job.

Port of `video_unscreen_tpu/parallel/mesh.py`, its inference half:
`make_mesh`, `batch_sharding` and `replicate`. The JAX mesh is a grid of
devices inside one program; here every rank is one process and the grid
is one of ranks: rank r sits at (data r // model, model r % model), and
each axis has one process group a row or column of the grid, made with
`new_group` over the default group's backend. So one piece of code runs
over `gloo` on the host, over `gloo` with several ranks sharing one card,
and over NCCL. Without a process group a mesh has one rank and no groups,
and every collective below is the identity.

A sharding here is what the caller does with a tensor, not an annotation
that a compiler reads: `Sharding.shard` takes this rank's block of the
leading axis, `Sharding.gather` puts the blocks of an axis back together
on every rank of it. The gather is an `all_reduce` (SUM) of the blocks in
a zero buffer: exact for any dtype, since each element has one nonzero
term, and it runs on CUDA tensors under `gloo`, whose `all_gather` takes
CPU tensors only.

`param_shardings` and `spatial_sharding` (tensor and spatial parallelism
for training) are not ported yet: ROADMAP.md, Queue 1, item 21c.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def mesh_shape(n: int, model_parallel: Optional[int] = None
               ) -> Tuple[int, int]:
    """(data, model) of an n-rank mesh, by the JAX rule: model 2 when n
    is even and above 1, else 1."""
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n < 1 or model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_parallel}")
    return n // model_parallel, model_parallel


class Mesh:
    """The ranks of the job as a 2-D grid. `shape` maps each axis name to
    its size, as the JAX mesh's; `coords` this rank's index on each axis;
    `groups` each axis' process group (None without a process group)."""

    def __init__(self, shape: Tuple[int, int], axis_names: Sequence[str],
                 rank: int, groups: Dict[str, object]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        n_model = shape[1]
        self.coords = dict(zip(self.axis_names,
                               (rank // n_model, rank % n_model)))
        self.groups = groups

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def axis(self, name: str):
        """(process group, size) of an axis longer than 1, the port's
        counterpart of JAX's (axis name, size); else None."""
        size = self.shape.get(name, 1)
        return (self.groups[name], size) if size > 1 else None


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: Optional[int] = None,
              axis_names: Sequence[str] = ("data", "model"),
              timeout: float = 300.0) -> Mesh:
    """The (data, model) mesh over the ranks of the default process group
    (`mesh_shape`'s split). `n_devices` must be the world size when a
    process group exists and 1 when none does. Every rank must call this
    in the same order: each makes every axis group, whose collectives fail
    after `timeout` seconds (a new group's own default is 30 minutes)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks asked for in a job of "
                         f"{world}: the mesh covers every rank")
    shape = mesh_shape(n, model_parallel)
    names = tuple(axis_names)
    if len(names) != 2:
        raise ValueError(f"two axis names, not {names}")
    if not initialized:
        return Mesh(shape, names, 0, {a: None for a in names})
    limit = timedelta(seconds=timeout)
    n_data, n_model = shape
    rank = dist.get_rank()
    groups = {}
    # every rank makes every group, in one order: the columns (one data
    # index apart), then the rows (one model index apart)
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)],
                           timeout=limit)
        if rank % n_model == m:
            groups[names[0]] = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)],
                           timeout=limit)
        if rank // n_model == d:
            groups[names[1]] = g
    return Mesh(shape, names, rank, groups)


class Sharding(NamedTuple):
    """The leading axis split over `axis` of `mesh` in equal blocks, or
    replicated (`axis` None)."""
    mesh: Mesh
    axis: Optional[str]

    def shard(self, x):
        """This rank's block of the leading axis of `x` (a tensor or numpy
        array), or `x` itself when replicated."""
        if self.axis is None:
            return x
        n = self.mesh.shape[self.axis]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows are not divisible by the "
                             f"{self.axis} axis ({n})")
        k = x.shape[0] // n
        i = self.mesh.index(self.axis)
        return x[i * k:(i + 1) * k]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The blocks of every rank of the axis, concatenated in axis
        order, on every rank of it."""
        group = self.mesh.groups.get(self.axis) if self.axis else None
        if group is None:
            return block
        n = self.mesh.shape[self.axis]
        k = block.shape[0]
        out = block.new_zeros((n * k,) + tuple(block.shape[1:]))
        i = self.mesh.index(self.axis)
        out[i * k:(i + 1) * k] = block
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading batch axis over `data`, the rest replicated."""
    return Sharding(mesh, mesh.axis_names[0])


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def axis_any(mask: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise OR of a bool mask over the ranks of `axis` ((process
    group, size) or None), the same on every rank of it: ranks that must
    enter a collective together decide from this, not from their own
    flags."""
    if axis is None:
        return mask
    flags = mask.to(torch.uint8)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=axis[0])
    return flags.bool()
