"""The click-based interactive segmenter's training, on one device or over a
mesh.

Port of `video_unscreen_tpu/parallel/train_iseg.py`: the click batch
maker (a blob over a flat or textured background, 1-3
positive clicks inside it and 0-2 negative ones outside, drawn from the
`RandomState` as the JAX maker draws them), the mean sigmoid binary
cross-entropy against the mask and the state and step for
`DistMapsModel`. The ASPP's dropout draws from the step's generator; the
JAX step's `fold_in(PRNGKey(23), step)` masks are not reproduced. Over a
mesh (`train.py`'s step) the mean is the whole batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.iseg import DistMapsModel
from ..utils.checkpoint import load_iseg
from .data_synth import _random_alpha, _smooth_noise
from .mesh import Mesh
from .train import (Batch, TrainStep, dropout_generator, make_state,
                    make_step, nchw, over_batch)
from .train_seg import IMAGENET_MEAN, IMAGENET_STD


def _sample_point(rng, mask_bool):
    ys, xs = np.where(mask_bool)
    if len(ys) == 0:
        return None
    i = rng.randint(len(ys))
    return ys[i], xs[i]


def make_click_batch(rng: np.random.RandomState, batch: int,
                     hw: Tuple[int, int] = (128, 128),
                     max_clicks: int = 20) -> Dict[str, np.ndarray]:
    """{"img": (B, h, w, 3) ImageNet-normalized RGB, "points": (B,
    max_clicks, 3) rows of (is_positive, y, x), -1 in unused rows,
    "label": (B, h, w) int32 mask}."""
    h, w = hw
    imgs, points, labels = [], [], []
    for _ in range(batch):
        if rng.rand() < 0.4:    # a flat screen-like background
            bg = np.broadcast_to(
                rng.uniform(0.05, 0.95, 3).astype(np.float32),
                (h, w, 3)).copy()
            bg += _smooth_noise(rng, h, w, 16) * rng.uniform(0.0, 0.1)
        else:
            bg = _smooth_noise(rng, h, w)
        if rng.rand() < 0.5:
            fg = np.broadcast_to(
                rng.uniform(0.05, 0.95, 3).astype(np.float32),
                (h, w, 3)).copy()
        else:
            fg = _smooth_noise(rng, h, w, scale=4)
        alpha = _random_alpha(rng, h, w)
        img = alpha[..., None] * fg + (1 - alpha[..., None]) * bg
        img += rng.randn(h, w, 3).astype(np.float32) * 0.02
        label = (alpha > 0.5).astype(np.int32)

        pts = np.full((max_clicks, 3), -1.0, np.float32)
        idx = 0
        for _ in range(rng.randint(1, 4)):  # positives
            p = _sample_point(rng, label > 0)
            if p is not None:
                pts[idx] = (1.0, p[0], p[1])
                idx += 1
        for _ in range(rng.randint(0, 3)):  # negatives
            p = _sample_point(rng, label == 0)
            if p is not None:
                pts[idx] = (0.0, p[0], p[1])
                idx += 1
        imgs.append((img.clip(0, 1)[..., ::-1] - IMAGENET_MEAN)
                    / IMAGENET_STD)
        points.append(pts)
        labels.append(label)
    return {"img": np.stack(imgs), "points": np.stack(points),
            "label": np.stack(labels)}


def iseg_loss(model: nn.Module, batch: Batch, axis=None) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of the (B, 1, H, W) logits
    against the mask, over the whole batch (`train.over_batch`)."""
    logits = model(nchw(batch["img"]), batch["points"])
    bce = F.binary_cross_entropy_with_logits(
        logits[:, 0], batch["label"].to(logits.dtype), reduction="sum")
    return over_batch(bce, batch["label"].numel(), axis)


def make_iseg_train_state(device="cuda", seed: int = 0, init_from=None,
                          model: Optional[nn.Module] = None,
                          mesh: Optional[Mesh] = None) -> nn.Module:
    """`model` (default `DistMapsModel()`) ready to train
    (`train.make_state`, `load_iseg`)."""
    return make_state(model if model is not None else DistMapsModel(),
                      device, seed, init_from, load_iseg, mesh)


def make_iseg_train_step(model: nn.Module, optimizer, scheduler,
                         seed: int = 0, mesh: Optional[Mesh] = None
                         ) -> TrainStep:
    """The DistMaps step: `make_step` of `iseg_loss`, the ASPP's dropout
    drawing from a generator seeded with `seed`."""
    dropout_generator(model, seed)
    return make_step(model, optimizer, scheduler, iseg_loss, mesh=mesh)
