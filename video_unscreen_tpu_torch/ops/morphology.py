"""Ellipse-kernel dilate/erode, open/close, the outer boundary and the
box filter.

Port of `video_unscreen_tpu/ops/morphology.py`. The dilate/erode chains
dispatch on the tensor's device: a CPU tensor takes the shifted max/min
chain (`kernels.morph.morph_plain`), a CUDA tensor the hand-written kernel
K2 (`ops/kernels/morph.py`). Borders count as -inf when dilating and +inf
when eroding (cv2's default: no border growth or shrink). The box filter
was never a TPU kernel: it is plain tensor code on either device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def morph_open(mask: torch.Tensor, kernelsize: int = 5,
               iters: int = 1) -> torch.Tensor:
    """Erode, then dilate, with the same ellipse (cv2.MORPH_OPEN)."""
    return dilate(erode(mask, kernelsize, iters), kernelsize, iters)


def morph_close(mask: torch.Tensor, kernelsize: int = 5,
                iters: int = 1) -> torch.Tensor:
    """Dilate, then erode, with the same ellipse (cv2.MORPH_CLOSE)."""
    return erode(dilate(mask, kernelsize, iters), kernelsize, iters)


def get_outer_boundary(mask: torch.Tensor, kernelsize: int = 7,
                       iters: int = 10) -> torch.Tensor:
    """The ring the dilation adds around the mask: dilate - mask, clipped
    to 0..255."""
    return (dilate(mask, kernelsize, iters) - mask).clamp(0.0, 255.0)


def _window_sum(x: torch.Tensor, ksize: int, dim: int) -> torch.Tensor:
    """Sums of `ksize` consecutive cells along `dim` (valid windows), added
    left to right from 0 as XLA's reduce_window adds them."""
    n = x.shape[dim] - ksize + 1
    s = x.narrow(dim, 0, n)
    for i in range(1, ksize):
        s = s + x.narrow(dim, i, n)
    return s


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized ksize x ksize mean of an (H, W) or (H, W, C) image,
    REFLECT_101 border (cv2.boxFilter's default): a column sum, then a row
    sum, over the reflect-padded image, divided by ksize^2."""
    lo = (ksize - 1) // 2
    hi = ksize - 1 - lo
    x = img[None] if img.dim() == 2 else img.permute(2, 0, 1)
    # torch's "reflect" leaves the edge out: cv2's REFLECT_101
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
    s = _window_sum(_window_sum(x, ksize, 1), ksize, 2) / float(ksize * ksize)
    return s[0] if img.dim() == 2 else s.permute(1, 2, 0).contiguous()
