"""MattingUNet training, and what the trainers share, on one device or
over a (data, model) mesh of ranks.

Port of `video_unscreen_tpu/parallel/train.py`: the loss (L1 alpha plus
composition L1 in the trimap's unknown band), the state and the step. The
JAX trainers' pieces every family uses live here:

- `init_flax_like`: flax's initial distributions;
- `make_optimizer`: `optax.adamw(cosine_decay_schedule(lr, steps),
  weight_decay=1e-5)` as `torch.optim.AdamW` (optax's betas, eps and
  decay; torch's default decay is 1e-2) with optax's closed-form cosine
  as a `LambdaLR` (the recursive `CosineAnnealingLR` drifts from it);
- `clip_by_global_norm_`: optax's `clip_by_global_norm`, which scales by
  max_norm / |g| only when |g| >= max_norm (torch's `clip_grad_norm_`
  adds 1e-6 to the norm and always multiplies);
- `make_step` (a `TrainStep`): one value-and-grad, then `apply_gradients`:
  the clip, one AdamW update and one schedule step. A parameter the loss
  does not reach gets a zero gradient in the value-and-grad, not none:
  optax updates every leaf, so such a parameter still decays by lr * wd
  * p, where torch's AdamW would skip it;
- `dropout_generator`: the train step's own `torch.Generator` on the
  model's device, seeded, which the model's dropouts draw from
  (`models/dropout.py`).

Over ranks (`mesh`, `parallel/mesh.py:make_mesh`) the step equals JAX's
step over its mesh, which is one program on the whole batch:
`make_state(..., mesh=mesh)` holds the model split over the model axis
(`tensor_parallel.shard_model`) and gives its BatchNorms and dropouts the
data axis (`tensor_parallel.sync_data_axis`). Every rank makes the whole
batch and the step keeps its block (`batch_sharding(mesh).shard`); each
loss divides this rank's sum by the whole batch's count (`over_batch`), so
the losses and the gradients of the ranks of the data axis sum to the
whole batch's, and the step sums them; the clip takes the norm of the
whole gradient (`tensor_parallel.global_grad_norm`). On a (1, 1) mesh
every collective and the split are the identity.

Batches are the JAX makers' NHWC numpy dicts; `batch_to_device` uploads
them as they are and each loss moves images to NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.dropout import attach_generator, dropouts
from ..models.matting_unet import MattingUNet
from ..utils.checkpoint import load_matting_unet
from ..utils.device import resolve_device
from .mesh import Axis, Mesh, batch_sharding
from .tensor_parallel import global_grad_norm, shard_model, sync_data_axis

Batch = Dict[str, torch.Tensor]


def init_flax_like(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initial distributions: convolution kernels lecun-normal (a
    normal truncated at two standard deviations, scaled to variance
    1/fan_in, fan_in = input channels x kernel taps, for a transposed or a
    depthwise convolution too), biases 0; BatchNorm scale 1, bias 0, mean
    0, var 1."""
    # the standard deviation of N(0, 1) truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            # weights (out, in, kh, kw); transposed (in, out, kh, kw)
            fan_in = (mod.weight[:, 0] if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0]).numel()
            std = math.sqrt(1.0 / fan_in) / trunc_std
            with torch.no_grad():
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()


def make_optimizer(model: nn.Module, lr: float, steps: int):
    """(AdamW, LambdaLR) as `optax.adamw(cosine_decay_schedule(lr, steps),
    weight_decay=1e-5)`: step t uses lr * 0.5 (1 + cos(pi min(t, steps) /
    steps)), from t = 0."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-5)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps)))
    return opt, sched


def clip_by_global_norm_(model: nn.Module, max_norm: float
                         ) -> torch.Tensor:
    """optax's `clip_by_global_norm(max_norm)` on the `.grad` of `model`'s
    parameters, in place and without a host sync: g <- g where |g| <
    max_norm, else g / |g| * max_norm, |g| the norm of the whole gradient
    (`tensor_parallel.global_grad_norm`: a split model's too). Returns
    |g|."""
    norm = global_grad_norm(model)
    keep = norm < max_norm
    for p in model.parameters():
        if p.grad is not None:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * max_norm))
    return norm


def fill_missing_grads(model: nn.Module) -> None:
    """A zero gradient for every parameter the loss did not reach."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def dropout_generator(model: nn.Module,
                      seed: int) -> Optional[torch.Generator]:
    """A `torch.Generator` on the model's device, seeded with `seed`, that
    the model's dropouts now draw from; None for a model without one."""
    if not dropouts(model):
        return None
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    attach_generator(model, gen)
    return gen


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    """A numpy batch as tensors on `device`, in its own layout and dtype
    (NHWC images; a uint8 image stays uint8)."""
    return {k: torch.as_tensor(np.ascontiguousarray(a)).to(device)
            for k, a in batch.items()}


def nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> contiguous (N, C, H, W)."""
    return x.permute(0, 3, 1, 2).contiguous()


def make_state(model: nn.Module, device, seed: int, init_from,
               loader: Callable, mesh: Optional[Mesh] = None) -> nn.Module:
    """`model` on `device` ("cuda" unless the caller asks for "cpu") in
    train mode: flax's initialization from a `torch.Generator` seeded with
    `seed`, or the variables of a flax msgpack checkpoint (a path or a
    variables tree) mapped by `loader`; with `mesh`, then split over its
    model axis and synchronized over its data axis (the module
    docstring). Every rank loads or initializes the whole model."""
    device = resolve_device(device)
    if init_from is not None:
        model.load_state_dict(loader(init_from))
    else:
        init_flax_like(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    if mesh is not None:
        sync_data_axis(shard_model(model, mesh), mesh)
        model.train_mesh = mesh
    return model


def apply_gradients(model: nn.Module, optimizer, scheduler,
                    clip_norm: Optional[float] = None
                    ) -> Optional[torch.Tensor]:
    """The update from the model's `.grad`: optax's global-norm clip when
    `clip_norm` is given, one AdamW update and one schedule step. Returns
    |g| when it clipped."""
    grad_norm = None
    if clip_norm is not None:
        grad_norm = clip_by_global_norm_(model, clip_norm)
    optimizer.step()
    scheduler.step()
    return grad_norm


def data_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`x` (no gradient) summed over the ranks of the data axis (or
    None)."""
    if axis is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def over_batch(total: torch.Tensor, count,
               axis: Optional[Axis] = None) -> torch.Tensor:
    """This rank's part of a mean over the whole batch: `total` (this
    rank's sum) over `count` summed over the data axis (a tensor, summed by
    `data_sum`, or a number of entries, which every rank of the axis
    has). Summed over the axis, the parts and their gradients are the
    whole batch's."""
    if torch.is_tensor(count):
        return total / data_sum(count, axis)
    return total / (count * (1 if axis is None else axis.size))


class TrainStep:
    """One train step of `model` on `loss_fn(model, batch, axis=...)`,
    called with the whole numpy batch: `value_and_grad(batch)` (this
    rank's block on the device, the loss and the gradients, summed over
    the data axis: the model's `.grad`, whole with
    `tensor_parallel.full_grads`), then `apply()` (`apply_gradients`);
    `step(batch)` does both and returns the whole batch's loss, a 0-d
    tensor on the model's device, not synchronized. With `mesh`, `model`
    must come from `make_state(..., mesh=mesh)`."""

    def __init__(self, model: nn.Module, optimizer, scheduler,
                 loss_fn: Callable[..., torch.Tensor],
                 clip_norm: Optional[float] = None,
                 mesh: Optional[Mesh] = None,
                 to_device: Callable = None):
        if mesh is not None and getattr(model, "train_mesh", None) \
                is not mesh:
            raise ValueError("the model was not made for this mesh: "
                             "make_state(..., mesh=mesh)")
        self.model, self.optimizer, self.scheduler = model, optimizer, \
            scheduler
        self.loss_fn, self.clip_norm = loss_fn, clip_norm
        self.to_device = to_device or batch_to_device
        self.device = next(model.parameters()).device
        self.rows = None if mesh is None else batch_sharding(mesh)
        self.axis = None if mesh is None else mesh.axis(mesh.axis_names[0])

    def value_and_grad(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        model = self.model
        model.train()
        if self.rows is not None:
            batch = {k: self.rows.shard(v) for k, v in batch.items()}
        loss = self.loss_fn(model, self.to_device(batch, self.device),
                            axis=self.axis)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        fill_missing_grads(model)
        loss = loss.detach()
        if self.axis is not None:
            grads = [p.grad for p in model.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss[None]])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                            group=self.axis.group)
            start = 0
            for g in grads:
                g.copy_(flat[start:start + g.numel()].view(g.shape))
                start += g.numel()
            loss = flat[-1]
        return loss

    def apply(self) -> Optional[torch.Tensor]:
        return apply_gradients(self.model, self.optimizer, self.scheduler,
                               self.clip_norm)

    def __call__(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        loss = self.value_and_grad(batch)
        self.apply()
        return loss


def make_step(model: nn.Module, optimizer, scheduler,
              loss_fn: Callable[..., torch.Tensor],
              clip_norm: Optional[float] = None,
              mesh: Optional[Mesh] = None, to_device: Callable = None
              ) -> TrainStep:
    """The `TrainStep` of `loss_fn` (`loss_fn(model, device batch, axis=
    data axis or None)`)."""
    return TrainStep(model, optimizer, scheduler, loss_fn, clip_norm, mesh,
                     to_device)


def matting_loss(model: nn.Module, batch: Batch, axis=None) -> torch.Tensor:
    """L1 alpha plus composition loss in the unknown band (trimap channel
    1), each summed over the band and divided by its size (at least 1)
    over the whole batch (`data_sum`). `batch` is `batch_to_device`'s of
    `data_synth.make_batch`."""
    img, trimap, gt = batch["img"], batch["trimap"], batch["alpha_gt"]
    pred = model(nchw(img), nchw(batch["alpha_pre"]), nchw(trimap))[:, 0]
    unknown = trimap[..., 1]
    denom = torch.clamp_min(data_sum(unknown.sum(), axis), 1.0)
    alpha_l1 = ((pred - gt).abs() * unknown).sum() / denom
    comp_err = ((pred - gt)[..., None] * img).abs().mean(-1)
    comp_l1 = (comp_err * unknown).sum() / denom
    return alpha_l1 + comp_l1


def make_train_state(device="cuda", seed: int = 0, init_from=None,
                     model: Optional[nn.Module] = None,
                     mesh: Optional[Mesh] = None) -> nn.Module:
    """The MattingUNet (`model`, default `MattingUNet()`, the shipped
    (2, 2, 2, 2)) ready to train (`make_state`, `load_matting_unet`)."""
    return make_state(model if model is not None else MattingUNet(), device,
                      seed, init_from, load_matting_unet, mesh)


def make_train_step(model: nn.Module, optimizer, scheduler,
                    mesh: Optional[Mesh] = None) -> TrainStep:
    """The matting step: `make_step` of `matting_loss` (JAX's
    `make_train_step(model, optimizer, mesh)`)."""
    return make_step(model, optimizer, scheduler, matting_loss, mesh=mesh)
