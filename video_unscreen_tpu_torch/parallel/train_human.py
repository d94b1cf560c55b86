"""The SCHP human parser's training, on one device or over a mesh.

Port of `video_unscreen_tpu/parallel/train_human.py`: the batch maker
(synthetic people with LIP part labels, letterboxed into the square input
as the HumanSegAgent's warp does, the labels at the logits' 1/4
resolution), the foreground-weighted cross-entropy and the state and step
for `SCHPHumanParser(layers=...)`. The maker stays on the host in numpy,
draw for draw with the JAX maker; its cv2 calls are the port's
(`data_synth.py`): the filled distractor ellipse `_fill_ellipse`,
INTER_LINEAR on float32 `_resize_linear`, INTER_NEAREST on the int32 part
maps `_resize_nearest`. With `raw_uint8` the images go up as BGR uint8 and
`human_loss` normalizes them on the device. The optimizer is the JAX
tool's `optax.chain(clip_by_global_norm(1.0), adamw(...))`: the step clips
with optax's rule (`train.py:clip_by_global_norm_`) before AdamW. The
fusion head's dropout draws from the step's generator; the JAX step's
`fold_in(PRNGKey(23), step)` masks are not reproduced. Over a mesh
(`train.py`'s step) the weighted mean is the whole batch's and the clip
takes the norm of the whole gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.human_parse import SCHPHumanParser
from ..utils.checkpoint import load_schp
from .data_synth import (_fill_ellipse, _resize_linear, _resize_nearest,
                         _smooth_noise, draw_person)
from .mesh import Mesh
from .train import (Batch, TrainStep, dropout_generator, make_state,
                    make_step, nchw, over_batch)
from .train_seg import IMAGENET_MEAN, IMAGENET_STD

CLIP_NORM = 1.0   # the JAX tool's optax.clip_by_global_norm(1.0)


def make_human_batch(rng: np.random.RandomState, batch: int,
                     hw: Tuple[int, int] = (224, 224),
                     label_stride: int = 4,
                     raw_uint8: bool = False) -> Dict[str, np.ndarray]:
    """Person composites and LIP part labels at 1/`label_stride`:
    {"img": (B, h, w, 3) ImageNet-normalized RGB float32, or BGR uint8
    with `raw_uint8`, "label": (B, h // s, w // s) int32}."""
    h, w = hw
    imgs, labels = [], []
    for _ in range(batch):
        # the scene at a random aspect, letterboxed into the square input
        aspect = rng.uniform(0.45, 2.2) if rng.rand() < 0.7 else 1.0
        if aspect >= 1.0:
            sh, sw = h, max(int(w / aspect), 16)
        else:
            sh, sw = max(int(h * aspect), 16), w
        if rng.rand() < 0.15:   # an occasional green screen
            bg = np.zeros((sh, sw, 3), np.float32)
            bg[...] = (rng.uniform(0.05, 0.35), rng.uniform(0.5, 0.9),
                       rng.uniform(0.1, 0.4))
            bg += _smooth_noise(rng, sh, sw, 16) * 0.1
        else:
            coarse = max(sh // rng.choice([4, 6, 8]), 1)
            bg = (_smooth_noise(rng, sh, sw, scale=coarse) * 0.85
                  + _smooth_noise(rng, sh, sw, scale=max(sh // 24, 1)) * 0.15)
            gy = np.linspace(rng.uniform(0.6, 1.0), rng.uniform(0.9, 1.3),
                             sh, dtype=np.float32)[:, None, None]
            bg = bg * gy
        person, parts = draw_person(rng, sh, sw)
        alpha = (parts > 0).astype(np.float32)
        img = alpha[..., None] * person + (1 - alpha[..., None]) * bg
        # a distractor blob painted but labelled background
        if rng.rand() < 0.3:
            blob = np.zeros((sh, sw), np.uint8)
            center = (rng.randint(0, sw), rng.randint(0, sh))
            axes = (rng.randint(4, sw // 4), rng.randint(4, sh // 4))
            _fill_ellipse(blob, center, axes, rng.randint(0, 180), 0, 360, 1)
            blob = (blob > 0) & (parts == 0)
            img[blob] = rng.uniform(0.05, 0.95, 3).astype(np.float32)
        img += rng.randn(sh, sw, 3).astype(np.float32) * 0.02
        img = img.clip(0, 1)
        if rng.rand() < 0.3:    # a zoomed crop
            s = rng.uniform(0.4, 0.9)
            ch, cw = max(int(sh * s), 16), max(int(sw * s), 16)
            y0 = rng.randint(0, sh - ch + 1)
            x0 = rng.randint(0, sw - cw + 1)
            img = _resize_linear(img[y0:y0 + ch, x0:x0 + cw], sh, sw)
            parts = _resize_nearest(parts.astype(np.int32)[y0:y0 + ch,
                                                           x0:x0 + cw],
                                    sh, sw)
        if (sh, sw) != (h, w):  # the centred letterbox, black bands
            canvas = np.zeros((h, w, 3), np.float32)
            pcanvas = np.zeros((h, w), np.int32)
            y0, x0 = (h - sh) // 2, (w - sw) // 2
            canvas[y0:y0 + sh, x0:x0 + sw] = img
            pcanvas[y0:y0 + sh, x0:x0 + sw] = parts
            img, parts = canvas, pcanvas
        if raw_uint8:
            imgs.append((img * 255).astype(np.uint8))
        else:
            imgs.append((img[..., ::-1] - IMAGENET_MEAN) / IMAGENET_STD)
        labels.append(_resize_nearest(parts.astype(np.int32),
                                      h // label_stride, w // label_stride))
    return {"img": np.stack(imgs), "label": np.stack(labels)}


def normalize_bgr_uint8(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) BGR uint8 -> ImageNet-normalized RGB float32, on the
    tensor's device: (img[..., ::-1] / 255 - mean) / std."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img.flip(-1).to(torch.float32) / 255.0 - mean) / std


def human_loss(model: nn.Module, batch: Batch, fg_weight: float = 3.0,
               axis=None) -> torch.Tensor:
    """Cross-entropy of the 1/4-resolution fusion logits in at least
    float32 (the JAX loss casts them to float32; a float64 net keeps
    float64), person classes weighted by `fg_weight`: sum(ce * w) /
    sum(w) over the whole batch (`train.over_batch`); a uint8 image is
    normalized here."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        img = normalize_bgr_uint8(img)
    logits = model(nchw(img))
    label = batch["label"].long()
    ce = F.cross_entropy(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), label,
        reduction="none")
    wgt = torch.where(label > 0, fg_weight, 1.0)
    return over_batch((ce * wgt).sum(), wgt.sum(), axis)


def make_human_train_state(device="cuda", seed: int = 0, init_from=None,
                           model: Optional[nn.Module] = None,
                           mesh: Optional[Mesh] = None) -> nn.Module:
    """`model` (default `SCHPHumanParser(20)`, the ResNet-101 (3, 4, 23,
    3)) ready to train (`train.make_state`, `load_schp`)."""
    return make_state(model if model is not None else SCHPHumanParser(20),
                      device, seed, init_from, load_schp, mesh)


def make_human_train_step(model: nn.Module, optimizer, scheduler,
                          seed: int = 0, mesh: Optional[Mesh] = None
                          ) -> TrainStep:
    """The parser's step: `make_step` of `human_loss` with optax's global
    clip at 1.0 before AdamW, the dropout drawing from a generator seeded
    with `seed`."""
    dropout_generator(model, seed)
    return make_step(model, optimizer, scheduler, human_loss,
                     clip_norm=CLIP_NORM, mesh=mesh)
