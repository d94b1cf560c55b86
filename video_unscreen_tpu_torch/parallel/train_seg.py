"""The binary DeepLab segmenter's training, on one device or over a mesh.

Port of `video_unscreen_tpu/parallel/train_seg.py`: the
synthetic batch maker (person-ish composites over green-screen or
textured backgrounds, cut as the SegAgent's grid TTA views them), the
softmax cross-entropy (optionally weighted) and the state and step for
`build_deeplab(num_classes=2)`. The maker stays on the host in numpy and
draws from the `RandomState` as the JAX maker does; its cv2 calls are the
port's numpy ones (`data_synth.py`): `cv2.resize` INTER_LINEAR on float32
images is `_resize_linear`, `cv2.copyMakeBorder(BORDER_REFLECT)` numpy's
"symmetric" pad. The ASPP's dropout draws from the step's generator
(`train.py:dropout_generator`), seeded with the step's `seed`; the JAX
step's `fold_in(PRNGKey(17), step)` masks are not reproduced. Over a
mesh (`train.py`'s step) the mean is the whole batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.deeplab import build_deeplab
from ..utils.checkpoint import load_deeplab
from .data_synth import (_random_alpha, _resize_linear, _smooth_noise,
                         draw_person, render_soft_person)
from .mesh import Mesh
from .train import (Batch, TrainStep, dropout_generator, make_state,
                    make_step, nchw, over_batch)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_seg_batch(rng: np.random.RandomState, batch: int,
                   hw: Tuple[int, int] = (128, 128),
                   green_screen_prob: float = 0.5) -> Dict[str, np.ndarray]:
    """Foreground blobs and people over green-screen or textured
    backgrounds, as the JAX maker draws them: {"img": (B, h, w, 3)
    ImageNet-normalized RGB, "label": (B, h, w) int32 in {0, 1}}."""
    h, w = hw
    imgs, labels = [], []
    for _ in range(batch):
        # a scene up to 2.5x the train size, windowed as the grid TTA does
        zoom = rng.uniform(1.0, 2.5)
        sh, sw = int(h * zoom), int(w * zoom)
        if rng.rand() < green_screen_prob:
            bg = np.zeros((sh, sw, 3), np.float32)
            bg[...] = (rng.uniform(0.05, 0.35), rng.uniform(0.5, 0.9),
                       rng.uniform(0.1, 0.4))
            bg += _smooth_noise(rng, sh, sw, 16) * 0.1
        else:
            bg = _smooth_noise(rng, sh, sw)
        # a vertical lighting gradient on every background
        gy = np.linspace(rng.uniform(0.7, 1.0), rng.uniform(0.9, 1.25),
                         sh, dtype=np.float32)[:, None, None]
        bg = (bg * gy).clip(0, 1)
        kind = rng.rand()
        if kind < 0.12:      # an empty scene
            fg = bg
            alpha = np.zeros((sh, sw), np.float32)
        elif kind < 0.55:    # a person, half of them soft-rendered
            if rng.rand() < 0.5:
                fg, alpha = render_soft_person(rng, sh, sw,
                                               ss=int(rng.choice([2, 4])))
            else:
                fg, parts = draw_person(rng, sh, sw)
                alpha = (parts > 0).astype(np.float32)
        elif kind < 0.78:    # a flat subject colour away from the screen's
            bg_mean = bg.reshape(-1, 3).mean(0)
            for _ in range(8):
                color = rng.uniform(0.05, 0.95, 3).astype(np.float32)
                if np.abs(color - bg_mean).sum() > 0.45:
                    break
            fg = np.broadcast_to(color, (sh, sw, 3)).copy()
            fg += _smooth_noise(rng, sh, sw, 16) * rng.uniform(0.0, 0.2)
            alpha = _random_alpha(rng, sh, sw)
        else:
            fg = _smooth_noise(rng, sh, sw, scale=4)
            alpha = _random_alpha(rng, sh, sw)
        img = alpha[..., None] * fg + (1 - alpha[..., None]) * bg
        img += rng.randn(sh, sw, 3).astype(np.float32) * 0.02
        img = img.clip(0, 1)
        if rng.rand() < 0.35:   # the whole-image view
            img = _resize_linear(img, h, w)
            alpha = _resize_linear(alpha, h, w)
        else:                   # a grid view, maybe of the reflect-padded
            if rng.rand() < 0.5:
                py, px = rng.randint(0, h // 2), rng.randint(0, w // 2)
                img = np.pad(img, ((0, py), (0, px), (0, 0)), "symmetric")
                alpha = np.pad(alpha, ((0, py), (0, px)), "symmetric")
            # resample windows that sit almost wholly inside the subject
            for _ in range(6):
                y0 = rng.randint(0, img.shape[0] - h + 1)
                x0 = rng.randint(0, img.shape[1] - w + 1)
                if (alpha[y0:y0 + h, x0:x0 + w] > 0.5).mean() < 0.85:
                    break
            img = img[y0:y0 + h, x0:x0 + w]
            alpha = alpha[y0:y0 + h, x0:x0 + w]
        if rng.rand() < 0.5:    # horizontal flip
            img = img[:, ::-1]
            alpha = alpha[:, ::-1]
        imgs.append((img[..., ::-1] - IMAGENET_MEAN) / IMAGENET_STD)
        labels.append((alpha > 0.5).astype(np.int32))
    return {"img": np.stack(imgs), "label": np.stack(labels)}


def seg_loss(model: nn.Module, batch: Batch, axis=None) -> torch.Tensor:
    """Softmax cross-entropy of the logits against the integer labels: the
    mean, or with a "weight" map sum(ce * weight) / sum(weight), over the
    whole batch (`train.over_batch`)."""
    logits = model(nchw(batch["img"]))
    ce = F.cross_entropy(logits, batch["label"].long(), reduction="none")
    wgt = batch.get("weight")
    if wgt is None:
        return over_batch(ce.sum(), ce.numel(), axis)
    return over_batch((ce * wgt).sum(), wgt.sum(), axis)


def make_seg_train_state(device="cuda", seed: int = 0, init_from=None,
                         model: Optional[nn.Module] = None,
                         mesh: Optional[Mesh] = None) -> nn.Module:
    """`model` (default `build_deeplab(num_classes=2)`, DeepLabV3+ on
    ResNet-50) ready to train (`train.make_state`, `load_deeplab`)."""
    return make_state(model if model is not None else build_deeplab(2),
                      device, seed, init_from, load_deeplab, mesh)


def make_seg_train_step(model: nn.Module, optimizer, scheduler,
                        seed: int = 0, mesh: Optional[Mesh] = None
                        ) -> TrainStep:
    """The segmenter step: `make_step` of `seg_loss`, the ASPP's dropout
    drawing from a generator seeded with `seed`."""
    dropout_generator(model, seed)
    return make_step(model, optimizer, scheduler, seg_loss, mesh=mesh)
