"""MattingUNet training on one device, and what the trainers share.

Port of `video_unscreen_tpu/parallel/train.py` without the mesh: the loss
(L1 alpha plus composition L1 in the trimap's unknown band), the state and
the step. The JAX trainers' pieces every family uses live here:

- `init_flax_like`: flax's initial distributions;
- `make_optimizer`: `optax.adamw(cosine_decay_schedule(lr, steps),
  weight_decay=1e-5)` as `torch.optim.AdamW` (optax's betas, eps and
  decay; torch's default decay is 1e-2) with optax's closed-form cosine
  as a `LambdaLR` (the recursive `CosineAnnealingLR` drifts from it);
- `clip_by_global_norm_`: optax's `clip_by_global_norm`, which scales by
  max_norm / |g| only when |g| >= max_norm (torch's `clip_grad_norm_`
  adds 1e-6 to the norm and always multiplies);
- `make_step`: one value-and-grad, then `apply_gradients`: the clip,
  one AdamW update and one schedule step. A parameter the loss does not
  reach gets a zero gradient, not none: optax updates every leaf, so such
  a parameter still decays by lr * wd * p, where torch's AdamW would skip
  it;
- `dropout_generator`: the train step's own `torch.Generator` on the
  model's device, seeded, which the model's dropouts draw from
  (`models/dropout.py`).

Batches are the JAX makers' NHWC numpy dicts; `batch_to_device` uploads
them as they are and each loss moves images to NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.dropout import attach_generator, dropouts
from ..models.matting_unet import MattingUNet
from ..utils.checkpoint import load_matting_unet
from ..utils.device import resolve_device

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


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm(max_norm)` on the `.grad` of `params`,
    in place and without a host sync: g <- g where |g| < max_norm, else
    g / |g| * max_norm, |g| the norm over every gradient. Returns |g|."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
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
               loader: Callable) -> nn.Module:
    """`model` on `device` ("cuda" unless the caller asks for "cpu") in
    train mode: flax's initialization from a `torch.Generator` seeded with
    `seed`, or the variables of a flax msgpack checkpoint (a path or a
    variables tree) mapped by `loader`."""
    device = resolve_device(device)
    if init_from is not None:
        model.load_state_dict(loader(init_from))
    else:
        init_flax_like(model, torch.Generator().manual_seed(seed))
    return model.to(device).train()


def apply_gradients(model: nn.Module, optimizer, scheduler,
                    clip_norm: Optional[float] = None) -> None:
    """The update from the model's `.grad`: missing ones as zeros, optax's
    global-norm clip when `clip_norm` is given, one AdamW update and one
    schedule step."""
    fill_missing_grads(model)
    if clip_norm is not None:
        clip_by_global_norm_(model.parameters(), clip_norm)
    optimizer.step()
    scheduler.step()


def make_step(model: nn.Module, optimizer, scheduler,
              loss_fn: Callable[[nn.Module, Batch], torch.Tensor],
              clip_norm: Optional[float] = None
              ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """step(numpy batch) -> loss (a 0-d tensor on the model's device, not
    synchronized): `loss_fn` in train mode, its gradients and
    `apply_gradients`."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        model.train()
        loss = loss_fn(model, batch_to_device(batch, device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(model, optimizer, scheduler, clip_norm)
        return loss.detach()

    return step


def matting_loss(model: nn.Module, batch: Batch) -> torch.Tensor:
    """L1 alpha plus composition loss in the unknown band (trimap channel
    1), each summed over the band and divided by its size (at least 1).
    `batch` is `batch_to_device`'s of `data_synth.make_batch`."""
    img, trimap, gt = batch["img"], batch["trimap"], batch["alpha_gt"]
    pred = model(nchw(img), nchw(batch["alpha_pre"]), nchw(trimap))[:, 0]
    unknown = trimap[..., 1]
    denom = torch.clamp_min(unknown.sum(), 1.0)
    alpha_l1 = ((pred - gt).abs() * unknown).sum() / denom
    comp_err = ((pred - gt)[..., None] * img).abs().mean(-1)
    comp_l1 = (comp_err * unknown).sum() / denom
    return alpha_l1 + comp_l1


def make_train_state(device="cuda", seed: int = 0, init_from=None,
                     model: Optional[nn.Module] = None) -> nn.Module:
    """The MattingUNet (`model`, default `MattingUNet()`, the shipped
    (2, 2, 2, 2)) ready to train (`make_state`, `load_matting_unet`)."""
    return make_state(model if model is not None else MattingUNet(), device,
                      seed, init_from, load_matting_unet)


def make_train_step(model: nn.Module, optimizer, scheduler
                    ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """The matting step: `make_step` of `matting_loss`."""
    return make_step(model, optimizer, scheduler, matting_loss)
