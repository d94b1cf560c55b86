"""Trimap generation: morphology band plus chroma ensemble.

Port of `video_unscreen_tpu/ops/trimap.py`. On a CUDA tensor the
dilate/erode/select core is kernel K1 (`ops/kernels/morph.py:trimap`); on
a CPU tensor it is the shifted max/min chain.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .compositing import is_pixel_inrange
from .kernels.morph import trimap as _trimap
from .morphology import ellipse_offsets


def generate_trimap(mask: torch.Tensor, kernelsize: int = 3,
                    iters: int = 5) -> torch.Tensor:
    """Mask -> {0, 128, 255} trimap: unknown = the dilate - erode band."""
    return _trimap(mask, ellipse_offsets(kernelsize), iters)


def generate_trimap_withbg(mask: torch.Tensor, img: torch.Tensor,
                           bg: torch.Tensor, kernelsize: int = 3,
                           iters: int = 5,
                           color_winsize: Sequence[int] = (10, 100, 180)
                           ) -> torch.Tensor:
    """Trimap ensembled with a chroma background mask.

    Pixels of `img` inside the HSV window around the background color are
    "fuzzy"; when they cover at most 10% of the mask they are zeroed from
    it and marked unknown, otherwise the mask-only trimap stands. An empty
    mask passes through unchanged. A batch (B, H, W) of masks, with (B, H,
    W, 3) images and `bg` broadcasting to them, is decided mask by mask and
    goes through K1 in one call."""
    fg = mask > 0
    fg_count = fg.sum(dim=(-2, -1), keepdim=True)
    fuzzy = fg & is_pixel_inrange(img, bg, color_winsize)
    fallback = (fuzzy.sum(dim=(-2, -1), keepdim=True)
                / fg_count.clamp_min(1) > 0.1)
    take = ~fallback & fuzzy
    trimap = generate_trimap(torch.where(take, 0.0, mask), kernelsize, iters)
    trimap = torch.where(take, 128.0, trimap)
    return torch.where(fg_count == 0, mask, trimap)
