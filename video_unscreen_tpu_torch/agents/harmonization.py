"""HarmonizationAgent: Lab toning of a foreground toward a background, and
box-filter smoothing at reduced resolution.

Port of `video_unscreen_tpu/agents/harmonization.py`: `_lab2bgr` (the
inverse of `ops.color.bgr2lab`), the device cores
`device_foreground_toning` and `device_smooth` on float tensors, and the
host API (`blur_work_hw`, `get_means`, `foreground_toning`,
`alpha_smoothing`, `background_blurring`) on numpy arrays. The person
replacement (`pipeline/replace.py`, `--harmonize`) composes the device
cores. None of it was a TPU kernel: it is plain tensor code on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.color import bgr2lab
from ..ops.geometry import get_target_size, resize
from ..ops.morphology import box_filter
from ..utils.device import as_float, resolve_device

# XYZ -> linear sRGB (the inverse of ops/color.py's _RGB2XYZ)
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875992, 0.041556),
            (0.055648, -0.204043, 1.057311))


def _lab2bgr(lab: torch.Tensor) -> torch.Tensor:
    """Lab in OpenCV 8-bit ranges -> BGR 0..255 (sRGB gamma, D65)."""
    l_ = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (l_ + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        return torch.where(t > 0.2068966, t ** 3, (t - 16.0 / 116.0) / 7.787)

    y = torch.where(l_ > 8.0, fy ** 3, l_ / 903.3)
    x = finv(fx) * 0.950456
    z = finv(fz) * 1.088754
    xyz = torch.stack([x, y, z], -1)
    m = torch.tensor(_XYZ2RGB, dtype=lab.dtype, device=lab.device)
    rgb = (xyz @ m.T).clamp(0.0, 1.0)
    rgb = torch.where(rgb > 0.0031308, 1.055 * rgb ** (1 / 2.4) - 0.055,
                      rgb * 12.92)
    return (rgb.flip(-1) * 255.0).clamp(0.0, 255.0)


class HarmonizationAgent:
    """The surface of the JAX `HarmonizationAgent`, plus `device`."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    # -- device cores -------------------------------------------------------
    def device_foreground_toning(self, fg: torch.Tensor, bg: torch.Tensor,
                                 alpha: torch.Tensor,
                                 toning_ratio: Sequence[float] = (
                                     0.5, 0.05, 0.05),
                                 max_shift: float = 15.0,
                                 min_shift: float = -30.0) -> torch.Tensor:
        """Shift the foreground's Lab means (over alpha > 0) toward the
        background's by `toning_ratio`, each shift clamped to [min_shift,
        max_shift]; (H, W, 3) BGR floats in and out."""
        fg_lab = bgr2lab(fg)
        bg_lab = bgr2lab(bg)
        sel = (alpha > 0)[..., None].to(torch.float32)
        fg_means = (fg_lab * sel).sum((0, 1)) / sel.sum().clamp_min(1)
        bg_means = bg_lab.mean((0, 1))
        ratio = torch.tensor([float(r) for r in toning_ratio],
                             device=fg.device)
        shift = (ratio * (bg_means - fg_means)).clamp(float(min_shift),
                                                      float(max_shift))
        return _lab2bgr((fg_lab + shift).clamp(0.0, 255.0))

    def device_smooth(self, img: torch.Tensor, iters: int, ksize: int,
                      work_hw: Tuple[int, int]) -> torch.Tensor:
        """`iters` box filters of size `ksize` at `work_hw`, then back to
        the image's size (linear resizes)."""
        ori_hw = tuple(img.shape[:2])
        small = resize(img, work_hw)
        for _ in range(int(iters)):
            small = box_filter(small, int(ksize))
        return resize(small, ori_hw)

    # -- host API -----------------------------------------------------------
    def blur_work_hw(self, h: int, w: int,
                     target_long_side: int = 480) -> Tuple[int, int]:
        """The reduced resolution the background blur works at."""
        return get_target_size(h, w, target_long_side)

    @torch.inference_mode()
    def get_means(self, img, mask=None, target_long_side=240) -> np.ndarray:
        """Channel means of `img` at long side `target_long_side`, over the
        pixels where the resized `mask` (0/1) is > 0 when given."""
        h, w = img.shape[:2]
        th, tw = get_target_size(h, w, target_long_side)
        small = resize(as_float(img, self.device), (th, tw))
        if mask is None:
            return small.mean((0, 1)).cpu().numpy()
        m = resize(as_float(mask, self.device) * 255.0, (th, tw)) > 0
        sel = m[..., None].to(torch.float32)
        return ((small * sel).sum((0, 1)) / sel.sum().clamp_min(1)
                ).cpu().numpy()

    @torch.inference_mode()
    def foreground_toning(self, fg, bg, alpha,
                          toning_ratio=(0.5, 0.05, 0.05), max_shift=15,
                          min_shift=-30) -> np.ndarray:
        out = self.device_foreground_toning(
            as_float(fg, self.device), as_float(bg, self.device),
            as_float(alpha, self.device), tuple(toning_ratio),
            float(max_shift), float(min_shift))
        return _to_u8(out)

    @torch.inference_mode()
    def alpha_smoothing(self, alpha, iters=3, ksize=3,
                        target_long_side=1920) -> np.ndarray:
        h, w = alpha.shape[:2]
        work = get_target_size(h, w, target_long_side)
        return _to_u8(self.device_smooth(as_float(alpha, self.device),
                                         int(iters), int(ksize), work))

    @torch.inference_mode()
    def background_blurring(self, bg, iters=3, ksize=3,
                            target_long_side=480) -> np.ndarray:
        h, w = bg.shape[:2]
        work = get_target_size(h, w, target_long_side)
        return _to_u8(self.device_smooth(as_float(bg, self.device),
                                         int(iters), int(ksize), work))


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """clip(0, 255).astype(uint8) of a float tensor, on the host."""
    return x.clamp(0, 255).to(torch.uint8).cpu().numpy()
