"""A (data, model) mesh over the ranks of a `torch.distributed` job.

Port of `video_unscreen_tpu/parallel/mesh.py`: `make_mesh`,
`batch_sharding`, `replicate`, `spatial_sharding` and `param_shardings`.
The JAX mesh is a grid of
devices inside one program; here every rank is one process and the grid
is one of ranks: rank r sits at (data r // model, model r % model), and
each axis has one process group a row or column of the grid, made with
`new_group` over the default group's backend. So one piece of code runs
over `gloo` on the host, over `gloo` with several ranks sharing one card,
and over NCCL. Without a process group a mesh has one rank and no groups,
and every collective below is the identity.

A sharding here is what the caller does with a tensor, not an annotation
that a compiler reads. Its `spec` names, as JAX's `PartitionSpec` does, the
mesh axis each leading dimension is split over (None: whole);
`Sharding.shard` takes this rank's block of every split dimension,
`Sharding.gather` puts the blocks back together on every rank. The gather
is an `all_reduce` (SUM) of the blocks in a zero buffer: exact for any
dtype, since each element has one nonzero term, and it runs on CUDA
tensors under `gloo`, whose `all_gather` takes CPU tensors only.

`param_shardings` is JAX's tensor-parallel rule, read on the flax layout
of each leaf (`utils/checkpoint.py:variables_tree`'s): a 4-D kernel whose
output channels (its last axis) are at least `min_channels` and divisible
by the model axis is split on them, a 1-D leaf of that kind on its only
axis, anything else is whole. `parallel/tensor_parallel.py:shard_model`
holds a model so. `spatial_sharding` (batch over data, W over model) is
defined as JAX defines it; no step uses it, in JAX or here.
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


class Axis(NamedTuple):
    """A mesh axis longer than 1 as the collectives take it: its process
    group, its size and this rank's index on it (its rank in the
    group)."""
    group: object
    size: int
    index: int


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

    def axis(self, name: str) -> Optional[Axis]:
        """The `Axis` of an axis longer than 1, the port's counterpart of
        JAX's (axis name, size); else None."""
        size = self.shape.get(name, 1)
        return (Axis(self.groups[name], size, self.coords[name])
                if size > 1 else None)


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


def gather_blocks(block: torch.Tensor, dim: int,
                  axis: Optional[Axis]) -> torch.Tensor:
    """The blocks of dimension `dim` held by the ranks of `axis`,
    concatenated in axis order, on every rank of it: an `all_reduce` of
    `block` placed in a zero buffer at this rank's offset."""
    if axis is None:
        return block
    k = block.shape[dim]
    shape = list(block.shape)
    shape[dim] = axis.size * k
    out = block.new_zeros(shape)
    out.narrow(dim, axis.index * k, k).copy_(block)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    return out


class Sharding(NamedTuple):
    """Dimension d of a value split over mesh axis `spec[d]` in equal
    blocks (dimensions past the spec, and None entries, whole); `spec`
    () is replication."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def shard(self, x):
        """This rank's block of `x` (a tensor or numpy array), or `x`
        itself when replicated."""
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            n = self.mesh.shape[name]
            if x.shape[dim] % n:
                raise ValueError(f"{x.shape[dim]} entries of dimension {dim}"
                                 f" are not divisible by the {name} axis "
                                 f"({n})")
            k = x.shape[dim] // n
            i = self.mesh.index(name)
            x = x[(slice(None),) * dim + (slice(i * k, (i + 1) * k),)]
        return x

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The blocks of every rank, put together in axis order, on every
        rank."""
        for dim, name in enumerate(self.spec):
            if name is not None:
                block = gather_blocks(block, dim, self.mesh.axis(name))
        return block


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading batch axis over `data`, the rest replicated."""
    return Sharding(mesh, (mesh.axis_names[0],))


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def spatial_sharding(mesh: Mesh) -> Sharding:
    """(N, H, W, C) activations: batch over `data`, W over `model` (JAX's
    `P("data", None, "model", None)`)."""
    data, model = mesh.axis_names
    return Sharding(mesh, (data, None, model, None))


def shard_axis(shape: Sequence[int], n_model: int,
               min_channels: int = 64) -> Optional[int]:
    """JAX's rule for one leaf of flax layout: the axis split over a model
    axis of `n_model` ranks, or None (whole)."""
    if n_model == 1:
        return None
    if len(shape) in (1, 4) and shape[-1] % n_model == 0 \
            and shape[-1] >= min_channels:
        return len(shape) - 1
    return None


def param_shardings(params, mesh: Mesh, min_channels: int = 64):
    """JAX's `param_shardings`: for a tree of arrays (nested dicts, flax
    layout), the same tree with each leaf's spec, `(None, None, None,
    "model")` for a split kernel, `("model",)` for a split 1-D leaf and
    `()` for a whole one (a `PartitionSpec` as a tuple). For a port model
    (before `tensor_parallel.shard_model`), the tree of its `params`
    collection, read from the shapes alone (`utils/checkpoint.py:
    params_layout`)."""
    name, n_model = mesh.axis_names[1], mesh.shape[mesh.axis_names[1]]

    def spec(shape):
        axis = shard_axis(shape, n_model, min_channels)
        if axis is None:
            return ()
        return tuple(name if d == axis else None for d in range(len(shape)))

    if isinstance(params, torch.nn.Module):
        from ..utils.checkpoint import params_layout
        tree: Dict = {}
        for path, _, _, shape in params_layout(params):
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = spec(shape)
        return tree

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return spec(tuple(node.shape)) if hasattr(node, "shape") else ()

    return walk(params)


def axis_any(mask: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Elementwise OR of a bool mask over the ranks of `axis` (or None),
    the same on every rank of it: ranks that must
    enter a collective together decide from this, not from their own
    flags."""
    if axis is None:
        return mask
    flags = mask.to(torch.uint8)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=axis[0])
    return flags.bool()
