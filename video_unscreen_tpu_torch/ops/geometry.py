"""Geometry ops: target sizes, resize, pad/resize, normalization.

Port of `video_unscreen_tpu/ops/geometry.py` on (H, W[, C]) tensors:

- `resize` "linear" samples at half-pixel centres without antialiasing
  (`jax.image.resize(..., antialias=False)`, torch `bilinear` with
  `align_corners=False`); "nearest" reproduces `jax.image.resize`'s index
  rule exactly (floor((i + 0.5) * in / out) in float32), which is torch's
  "nearest-exact".
- `pad_resize` pads "symmetric" (the edge row repeated, cv2
  BORDER_REFLECT), built by hand: torch's "reflect" is REFLECT_101.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics of the reference preprocessing
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def get_target_size(h: int, w: int, target_long_side: int,
                    division: int = 1) -> Tuple[int, int]:
    """Long side to `target_long_side`, aspect kept, short side rounded UP
    to a multiple of `division`."""
    if h > w:
        th = target_long_side
        tw = int(float(target_long_side) * w / h)
        if tw % division != 0:
            tw = (tw // division + 1) * division
    else:
        tw = target_long_side
        th = int(float(target_long_side) * h / w)
        if th % division != 0:
            th = (th // division + 1) * division
    return th, tw


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).to(torch.int64).clamp_max(n_in - 1)


def resize(img: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "linear") -> torch.Tensor:
    """Resize an (H, W[, C]) image to `out_hw` with half-pixel sampling."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(img.shape[:2]) == out_hw:
        return img
    if method == "nearest":
        ys = _nearest_index(img.shape[0], out_hw[0], img.device)
        xs = _nearest_index(img.shape[1], out_hw[1], img.device)
        return img.index_select(0, ys).index_select(1, xs)
    if method != "linear":
        raise ValueError(f"resize: unknown method {method!r}")
    x = img.permute(2, 0, 1)[None] if img.dim() == 3 else img[None, None]
    y = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False,
                      antialias=False)[0]
    return y.permute(1, 2, 0).contiguous() if img.dim() == 3 else y[0]


def _fit_size(h: int, w: int, target_h: int, target_w: int):
    """(new_h, new_w, pad_h, pad_w, ratio) of an aspect-keeping fit."""
    if float(h) / w > float(target_h) / target_w:
        new_h = target_h
        ratio = float(target_h) / h
        new_w = int(float(target_h) * w / h)
        pad_h, pad_w = 0, target_w - new_w
    else:
        new_w = target_w
        ratio = float(target_w) / w
        new_h = int(float(target_w) * h / w)
        pad_h, pad_w = target_h - new_h, 0
    return new_h, new_w, pad_h, pad_w, ratio


def _pad_symmetric(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad bottom/right by mirroring with the edge included (numpy
    "symmetric")."""
    if pad_h > x.shape[0] or pad_w > x.shape[1]:
        raise ValueError("symmetric pad wider than the image")
    if pad_h:
        x = torch.cat([x, x[x.shape[0] - pad_h:].flip(0)], dim=0)
    if pad_w:
        x = torch.cat([x, x[:, x.shape[1] - pad_w:].flip(1)], dim=1)
    return x


def pad_resize(img: torch.Tensor, target_hw: Tuple[int, int],
               method: str = "linear") -> torch.Tensor:
    """Aspect-keeping resize, then symmetric pad bottom/right to
    `target_hw`."""
    h, w = img.shape[:2]
    new_h, new_w, pad_h, pad_w, _ = _fit_size(h, w, *target_hw)
    return _pad_symmetric(resize(img, (new_h, new_w), method), pad_h, pad_w)


def inv_pad_resize(img: torch.Tensor, ori_hw: Tuple[int, int],
                   method: str = "linear") -> torch.Tensor:
    """Crop the padding of `pad_resize` and resize back to `ori_hw`."""
    h, w = img.shape[:2]
    ori_h, ori_w = ori_hw
    if float(ori_h) / ori_w > float(h) / w:
        resized_h = h
        resized_w = int(float(h) * ori_w / ori_h)
    else:
        resized_w = w
        resized_h = int(float(w) * ori_h / ori_w)
    return resize(img[:resized_h, :resized_w], (ori_h, ori_w), method)


def imnormalize(img: torch.Tensor, mean=IMAGENET_MEAN,
                std=IMAGENET_STD) -> torch.Tensor:
    """BGR(0..255) -> RGB, /255, then (x - mean) / std per channel."""
    rgb = img.flip(-1) / 255.0
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=img.device)
    std = torch.as_tensor(np.asarray(std, np.float32), device=img.device)
    return (rgb - mean) / std
