"""Tensor parallelism over the model axis, and the collectives it needs.

JAX's step shards the conv kernels over `model` (`mesh.py:param_shardings`)
and lets XLA place the collectives. Here they are explicit, in Megatron's
f/g pair around every split convolution, and differentiable:

- `gather(block, dim, axis)`: the blocks of `dim` of every rank of the axis
  put together (`mesh.gather_blocks`, a zero-padded `all_reduce`, which
  `gloo` runs on CUDA tensors too); its backward keeps this rank's slice
  of the gradient. Every rank computes the same thing after a gather, so
  that slice is this rank's block of the whole gradient.
- `copy_to(x, axis)`: the identity; its backward sums the gradient over
  the axis. A split convolution's input gradient on one rank is the part
  that flows through its own output channels, and the sum is the whole.
- `all_sum(x, axis)`: the sum over the axis, whose backward sums the
  gradients (BatchNorm's statistics over the data axis, `models/
  batchnorm.py`, which `sync_data_axis` hands it).

`shard_model(model, mesh)` turns a built model into its tensor-parallel
form, in place. Each leaf that `param_shardings` splits (read on the flax
layout: a kernel's output channels, a 1-D leaf's only axis) is held as
this rank's 1/model block, so its `.grad` and both AdamW moments are
blocks too when the optimizer is made after it. The modules keep their
names (checkpoints and optimizers see the same parameter names) and
change class:

- `ShardedConv2d`: computes its block of output channels from `copy_to`
  of the input, then `gather`s it over the model axis. A depthwise
  convolution (flax kernel (3, 3, 1, C), split on C) reads only the
  matching block of input channels.
- `ShardedConvTranspose2d`: the same; torch keeps a transposed conv's
  output channels on dim 1 of its (in, out, kh, kw) weight, flax on the
  last axis of (kh, kw, in, out).
- `ShardedBatchNorm2d`: `gather`s its split scale and bias before use; its
  running statistics stay whole (JAX keeps `batch_stats` replicated).

With a model axis of 1 `shard_model` changes nothing. `sync_data_axis`
gives every BatchNorm the data axis and every dropout its data block
(`models/dropout.py`); with a data axis of 1 it changes nothing.
`full_grads`, `full_state_dict` and `global_grad_norm` read a split model
whole (collectives: every rank of the model axis calls them).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.batchnorm import FlaxBatchNorm2d
from ..models.dropout import dropouts
from ..utils.checkpoint import params_layout
from .mesh import Axis, Mesh, gather_blocks, shard_axis


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim, axis):
        ctx.dim, ctx.index, ctx.k = dim, axis.index, block.shape[dim]
        return gather_blocks(block.contiguous(), dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.k, ctx.k), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.group = axis.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.group = axis.group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def gather(block: torch.Tensor, dim: int, axis: Optional[Axis]
           ) -> torch.Tensor:
    """The blocks of `dim` over `axis` (or None), whole on every rank; the
    backward keeps this rank's slice."""
    return block if axis is None else _Gather.apply(block, dim, axis)


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`x`; the backward sums the gradient over `axis`."""
    return x if axis is None else _CopyTo.apply(x, axis)


def all_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of `x` over the ranks of `axis`; the backward sums the
    gradients."""
    return x if axis is None else _AllSum.apply(x, axis)


class _Sharded:
    """What a split module holds beside its blocks: `tp_axis` (the model
    axis) and `tp_dims` (leaf name -> the torch dimension split)."""
    tp_axis: Axis
    tp_dims: Dict[str, int]

    def full_param(self, name: str) -> torch.Tensor:
        """Leaf `name` (a parameter or a buffer) whole, without a
        gradient."""
        t = getattr(self, name)
        dim = self.tp_dims.get(name)
        if dim is None:
            return t
        with torch.no_grad():
            return gather_blocks(t.detach().contiguous(), dim, self.tp_axis)

    def full_grad(self, name: str) -> Optional[torch.Tensor]:
        g = getattr(self, name).grad
        dim = self.tp_dims.get(name)
        if g is None or dim is None:
            return g
        return gather_blocks(g.contiguous(), dim, self.tp_axis)


class ShardedConv2d(_Sharded, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp_axis
        x = copy_to(x, axis)
        groups = self.groups
        if groups > 1:   # depthwise: this block's input channels
            k = self.weight.shape[0]
            x = x.narrow(1, axis.index * k, k)
            groups = k
        out = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                       self.dilation, groups)
        return gather(out, 1, axis)


class ShardedConvTranspose2d(_Sharded, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv_transpose2d(copy_to(x, self.tp_axis), self.weight,
                                 self.bias, self.stride, self.padding,
                                 self.output_padding, self.groups,
                                 self.dilation)
        return gather(out, 1, self.tp_axis)


class ShardedBatchNorm2d(_Sharded, FlaxBatchNorm2d):
    def scale_bias(self):
        return tuple(gather(getattr(self, n), 0, self.tp_axis)
                     if n in self.tp_dims else getattr(self, n)
                     for n in ("weight", "bias"))


def _sharded_class(mod: nn.Module):
    """The split class of `mod`, or raise for a module the rule splits
    that has none."""
    if type(mod) is nn.Conv2d and mod.padding_mode == "zeros" and (
            mod.groups == 1
            or mod.groups == mod.in_channels == mod.out_channels):
        return ShardedConv2d
    if type(mod) is nn.ConvTranspose2d and mod.groups == 1 \
            and mod.padding_mode == "zeros":
        return ShardedConvTranspose2d
    if type(mod) is FlaxBatchNorm2d:
        return ShardedBatchNorm2d
    raise TypeError(f"no tensor-parallel form of {type(mod).__name__} "
                    f"({mod})")


def _torch_dim(mod: nn.Module, ndim: int) -> int:
    """The torch dimension of a leaf's flax output-channel axis."""
    return 1 if ndim == 4 and isinstance(mod, nn.ConvTranspose2d) else 0


def shard_model(model: nn.Module, mesh: Mesh,
                min_channels: int = 64) -> nn.Module:
    """`model`, in place, held as `param_shardings` splits it over the
    mesh's model axis (the module docstring); every rank must hold the
    same whole weights when this is called. Make the optimizer after it.
    The identity for a model axis of 1."""
    axis = mesh.axis(mesh.axis_names[1])
    if axis is None:
        return model
    plan: Dict[str, Dict[str, int]] = {}
    for _, mod_name, leaf, shape in params_layout(model):
        if shard_axis(shape, axis.size, min_channels) is not None:
            mod = model.get_submodule(mod_name)
            plan.setdefault(mod_name, {})[leaf] = _torch_dim(mod, len(shape))
    for mod_name, dims in plan.items():
        mod = model.get_submodule(mod_name)
        cls = _sharded_class(mod)
        for leaf, dim in dims.items():
            p = getattr(mod, leaf)
            k = p.shape[dim] // axis.size
            setattr(mod, leaf, nn.Parameter(
                p.detach().narrow(dim, axis.index * k, k).clone(),
                requires_grad=p.requires_grad))
        mod.__class__ = cls
        mod.tp_axis, mod.tp_dims = axis, dims
    return model


def sync_data_axis(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Every BatchNorm of `model` takes its statistics over the mesh's data
    axis and every dropout draws the whole batch's mask and keeps this
    rank's block; in place. The identity for a data axis of 1."""
    axis = mesh.axis(mesh.axis_names[0])
    if axis is None:
        return model
    for mod in model.modules():
        if isinstance(mod, FlaxBatchNorm2d):
            mod.data_sum = functools.partial(all_sum, axis=axis)
            mod.data_ranks = axis.size
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{type(mod).__name__} has no data axis")
    for mod in dropouts(model):
        mod.data_block = (axis.index, axis.size)
    return model


def _named_leaves(model: nn.Module):
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{leaf}" if mod_name else leaf), mod, leaf, p


def is_split(mod: nn.Module, leaf: str) -> bool:
    return leaf in getattr(mod, "tp_dims", ())


def full_grads(model: nn.Module) -> Dict[str, Optional[torch.Tensor]]:
    """Each parameter's gradient whole, by name."""
    return {name: mod.full_grad(leaf) if is_split(mod, leaf) else p.grad
            for name, mod, leaf, p in _named_leaves(model)}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every split leaf whole."""
    state = model.state_dict()
    for mod_name, mod in model.named_modules():
        for leaf in getattr(mod, "tp_dims", ()):
            state[f"{mod_name}.{leaf}" if mod_name else leaf] = \
                mod.full_param(leaf)
    return state


def global_grad_norm(model: nn.Module) -> torch.Tensor:
    """|g| over the whole gradient of a model, split or not: the squares
    of each whole leaf counted once, those of the split ones summed over
    the model axis. Without a split leaf, the expression of
    `train.clip_by_global_norm_`, bit for bit."""
    whole, split, axis = [], [], None
    for _, mod, leaf, p in _named_leaves(model):
        if p.grad is None:
            continue
        if is_split(mod, leaf):
            split.append(p.grad.square().sum())
            axis = mod.tp_axis
        else:
            whole.append(p.grad.square().sum())
    parts = [torch.stack(whole).sum()] if whole else []
    if split:
        parts.append(torch.stack(split).sum())
        dist.all_reduce(parts[-1], op=dist.ReduceOp.SUM, group=axis.group)
    return torch.sqrt(sum(parts))


def held_bytes(model: nn.Module, optimizer=None) -> int:
    """Bytes this rank holds of the parameters and the optimizer's state
    (AdamW's two moments and its step counts)."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    if optimizer is not None:
        for state in optimizer.state.values():
            n += sum(t.numel() * t.element_size() for t in state.values()
                     if torch.is_tensor(t))
    return n
