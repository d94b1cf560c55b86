"""Ellipse-kernel dilate/erode.

Port of `video_unscreen_tpu/ops/morphology.py:ellipse_kernel`,
`_se_offsets`, `_morph`, `dilate`, `erode`. Dispatch follows the tensor's
device: a CPU tensor takes the shifted max/min chain
(`kernels.morph.morph_plain`), a CUDA tensor the hand-written kernel K2
(`ops/kernels/morph.py`). Borders count as -inf when dilating and +inf
when eroding (cv2's default: no border growth or shrink).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.morph import morph as _morph_dispatch


def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)) replica."""
    r = (ksize - 1) // 2
    c = (ksize - 1) // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((ksize, ksize), np.uint8)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            j1, j2 = max(c - dx, 0), min(c + dx + 1, ksize)
            kernel[i, j1:j2] = 1
    return kernel


def cross_kernel(ksize: int) -> np.ndarray:
    """cv2.MORPH_CROSS replica."""
    kernel = np.zeros((ksize, ksize), np.uint8)
    kernel[ksize // 2, :] = 1
    kernel[:, ksize // 2] = 1
    return kernel


def _se_offsets(kernel: np.ndarray):
    """(dy, dx) offsets of the SE's active cells, relative to the anchor."""
    ky, kx = kernel.shape
    ay, ax = ky // 2, kx // 2
    return [(int(y) - ay, int(x) - ax) for y, x in np.argwhere(kernel > 0)]


def ellipse_offsets(ksize: int):
    return _se_offsets(ellipse_kernel(ksize))


def cross_offsets(ksize: int):
    return _se_offsets(cross_kernel(ksize))


def dilate(mask: torch.Tensor, kernelsize: int = 5,
           iters: int = 10) -> torch.Tensor:
    """Grayscale dilation with a cv2 ellipse kernel, iterated."""
    return _morph_dispatch(mask, ellipse_offsets(kernelsize), iters, True)


def erode(mask: torch.Tensor, kernelsize: int = 5,
          iters: int = 10) -> torch.Tensor:
    """Grayscale erosion with a cv2 ellipse kernel, iterated."""
    return _morph_dispatch(mask, ellipse_offsets(kernelsize), iters, False)
