"""Chroma-prior segmentation: the weights-free seed of the green path.

Port of `video_unscreen_tpu/ops/chroma.py`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .color import bgr2hsv
from .compositing import _half_window
from .morphology import dilate, erode


def estimate_screen_color_hsv(img: torch.Tensor,
                              sat_thr: float = 60.0) -> torch.Tensor:
    """Dominant screen color in HSV: the hue-histogram peak over saturated
    pixels, with the mean S and V of the pixels near that hue."""
    hsv = bgr2hsv(img)
    h_ch, sat = hsv[..., 0], hsv[..., 1]
    bins = h_ch.to(torch.int64).clamp(0, 255).reshape(-1)
    weight = (sat > sat_thr).to(torch.float32).reshape(-1)
    hist = torch.zeros(256, dtype=torch.float32, device=img.device)
    hist.index_add_(0, bins, weight)
    peak = torch.argmax(hist).to(torch.float32)
    sel = ((torch.abs(h_ch - peak) < 8) & (sat > sat_thr)).to(torch.float32)
    cnt = sel.sum().clamp_min(1.0)
    s_mean = (hsv[..., 1] * sel).sum() / cnt
    v_mean = (hsv[..., 2] * sel).sum() / cnt
    return torch.stack([peak, s_mean, v_mean])


def chroma_segment(img: torch.Tensor,
                   color_winsize: Sequence[int] = (24, 140, 240),
                   clean_iters: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Foreground = NOT near the dominant screen color, cleaned by
    open/close morphology. Returns (mask 0/255, screen color HSV)."""
    hsv = bgr2hsv(img)
    bg_hsv = estimate_screen_color_hsv(img)
    half = _half_window(color_winsize, img.device)
    lower = torch.clamp(bg_hsv - half, 10.0, 255.0)
    upper = torch.clamp(bg_hsv + half, 10.0, 255.0)
    is_bg = ((hsv >= lower) & (hsv <= upper)).all(dim=-1)
    mask = torch.where(is_bg, 0.0, 255.0)
    mask = dilate(erode(mask, 3, clean_iters), 3, clean_iters)
    mask = erode(dilate(mask, 3, clean_iters), 3, clean_iters)
    return mask, bg_hsv
