"""Compositing math: chroma window, fg un-blend, bg blend-out, Lab color
correction, foreground gate, and the helpers no pipeline calls
(`composite_fgbg`, `get_mask`, `get_fgbox`, `get_fg_naive`,
`get_fg_with_colorremove`).

Port of `video_unscreen_tpu/ops/compositing.py`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .color import bgr2gray, bgr2hsv, bgr2lab, hsv2bgr
from .geometry import get_target_size, resize


def _half_window(winsize: Sequence[int], device) -> torch.Tensor:
    return torch.floor(torch.tensor([float(v) for v in winsize],
                                    device=device) / 2.0)


def is_pixel_inrange(img: torch.Tensor, bg: torch.Tensor,
                     winsize: Sequence[int] = (20, 20, 120)) -> torch.Tensor:
    """(..., H, W) bool: pixels of `img` inside the HSV window around `bg`
    (a (3,) color, or BGR colors of any shape broadcasting to `img`'s, such
    as an (H, W, 3) image or (S, 1, 1, 3) for a batch; BGR 0..255); bounds
    clamped to (10, 255)."""
    img_hsv = bgr2hsv(img)
    bg_hsv = bgr2hsv(bg[None, None, :])[0, 0] if bg.dim() == 1 \
        else bgr2hsv(bg)
    half = _half_window(winsize, img.device)
    lower = torch.clamp(bg_hsv - half, 10.0, 255.0)
    upper = torch.clamp(bg_hsv + half, 10.0, 255.0)
    return ((img_hsv >= lower) & (img_hsv <= upper)).all(dim=-1)


def get_fg(img: torch.Tensor, alpha: torch.Tensor,
           bg: torch.Tensor) -> torch.Tensor:
    """Un-blend img = a*fg + (1-a)*bg in HSV space, returning alpha*fg."""
    img_hsv = bgr2hsv(img)
    bg_hsv = bgr2hsv(bg)
    a = (alpha / 255.0)[..., None]
    return hsv2bgr(torch.clamp(img_hsv - (1.0 - a) * bg_hsv, 0.0, 255.0))


def get_fg_naive(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """fg = alpha * img."""
    return img * (alpha / 255.0)[..., None]


def get_fg_with_colorremove(img: torch.Tensor, alpha: torch.Tensor,
                            bg: torch.Tensor,
                            winsize: Sequence[int] = (10, 100, 120)
                            ) -> torch.Tensor:
    """`get_fg` with the alpha zeroed inside the chroma window of `bg`."""
    alpha = torch.where(is_pixel_inrange(img, bg, winsize), 0.0, alpha)
    return get_fg(img, alpha, bg)


def get_bg(alpha: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """(1 - alpha) * bg in HSV space."""
    bg_hsv = bgr2hsv(bg)
    a = (alpha / 255.0)[..., None]
    return hsv2bgr(torch.clamp((1.0 - a) * bg_hsv, 0.0, 255.0))


def exist_foreground(mask: torch.Tensor,
                     fg_exist_thr: float) -> torch.Tensor:
    """0-d bool: (mask >= 128).sum() > thr * h * w."""
    h, w = mask.shape
    return (mask >= 128).sum() > fg_exist_thr * h * w


def _sqrt_rounds(mean_exp: float) -> int:
    """Square roots after which the masked mean surely reaches `mean_exp`.

    Every selected value is a float32 in (0, 1], so at least 2**-149; after
    n roots it is at least 2**(-149 / 2**n), which is >= mean_exp once
    2**n >= 149 ln 2 / -ln(mean_exp)."""
    if not 0.0 < mean_exp < 1.0:
        raise ValueError(f"mean_exp must lie in (0, 1), got {mean_exp}")
    return math.ceil(math.log2(149.0 * math.log(2.0) / -math.log(mean_exp)))


def color_correct(img: torch.Tensor, alpha: torch.Tensor,
                  bg_color: torch.Tensor, target_long_side: int = 960,
                  mean_exp: float = 0.95) -> torch.Tensor:
    """Suppress residual background tint in the alpha via Lab ab-distance.

    The JAX package square-roots the min-max normalized distance map in a
    `lax.while_loop` until its mean over the alpha reaches `mean_exp`
    (`ops/compositing.py:181-186`). Here the loop has a fixed bound and each
    round applies the root only while the condition still holds: the
    condition depends on the map alone, so once it fails it stays failed,
    and no round needs a host sync."""
    h, w = img.shape[:2]
    th, tw = get_target_size(h, w, target_long_side)
    lab = bgr2lab(resize(img, (th, tw))) / 255.0
    bg_lab = bgr2lab(bg_color[None, None, :])[0, 0] / 255.0
    dist = torch.sqrt(((lab - bg_lab)[..., 1:] ** 2).sum(-1))
    dmin, dmax = dist.min(), dist.max()
    dist = (dist - dmin) / torch.clamp(dmax - dmin, min=1e-8)
    alpha_s = resize(alpha, (th, tw))
    sel = (alpha_s > 0) & (dist > 0)
    n_sel = sel.sum()
    cnt = n_sel.clamp_min(1)
    for _ in range(_sqrt_rounds(mean_exp)):
        mean = torch.where(sel, dist, 0.0).sum() / cnt
        go = (n_sel > 0) & (mean < mean_exp)
        dist = torch.where(go, torch.sqrt(dist), dist)
    dist = torch.where(alpha_s == 0, 0.0, dist)
    return alpha * resize(dist, (h, w), method="nearest")


def composite_fgbg(fg: torch.Tensor, alpha: torch.Tensor, bg: torch.Tensor,
                   extend: bool = False) -> torch.Tensor:
    """fg (alpha-premultiplied, 0..255) over the centre of `bg` resized to
    cover it, alphas above 0.9 taken as 1; with `extend`, the composite
    pasted back into the whole resized background."""
    fg_h, fg_w = fg.shape[:2]
    bg_h, bg_w = bg.shape[:2]
    if float(fg_h) / fg_w > float(bg_h) / bg_w:
        new_bg_h = fg_h
        new_bg_w = int(float(bg_w) * new_bg_h / bg_h)
    else:
        new_bg_w = fg_w
        new_bg_h = int(float(bg_h) * new_bg_w / bg_w)
    bg_r = resize(bg, (new_bg_h, new_bg_w))
    # the start of `jax.lax.dynamic_slice`, clamped to keep the window in
    left = min(max(new_bg_w // 2 - fg_w // 2, 0), new_bg_w - fg_w)
    top = min(max(new_bg_h // 2 - fg_h // 2, 0), new_bg_h - fg_h)
    bg_roi = bg_r[top:top + fg_h, left:left + fg_w]
    a = alpha / 255.0
    a = torch.where(a > 0.9, 1.0, a)[..., None]
    comp = torch.clamp(fg + bg_roi * (1.0 - a), 0.0, 255.0)
    if extend:
        out = bg_r.clone()
        out[top:top + fg_h, left:left + fg_w] = comp
        return out
    return comp


def get_mask(img: torch.Tensor):
    """(mask 0/255 (H, W, 1), mask 0/1 (H, W, 1)): gray > 25."""
    thresh = torch.where(bgr2gray(img) > 25.0, 255.0, 0.0)
    return thresh[..., None], (thresh / 255.0)[..., None]


def get_fgbox(fgmask: torch.Tensor, padsize: int = 5):
    """(top, bottom, left, right) 0-d tensors: the rows and columns of the
    foreground, padded by `padsize` and clamped to the image (top h and
    bottom -1, before the padding, when there is no foreground)."""
    h, w = fgmask.shape
    rows = (fgmask > 0).any(dim=1)
    cols = (fgmask > 0).any(dim=0)
    ridx = torch.arange(h, device=fgmask.device)
    cidx = torch.arange(w, device=fgmask.device)
    top = torch.where(rows, ridx, h).min()
    bottom = torch.where(rows, ridx, -1).max()
    left = torch.where(cols, cidx, w).min()
    right = torch.where(cols, cidx, -1).max()
    return ((top - padsize).clamp_min(0), (bottom + padsize).clamp_max(h),
            (left - padsize).clamp_min(0), (right + padsize).clamp_max(w))
