"""Visualization helpers.

Port of `video_unscreen_tpu/utils/visualize.py` without cv2, on numpy
arrays: `fuse_fgbg`, `get_roi`, `highlight_roi`, `tocolor`, and `show` /
`show_dist_hist` on their headless path, which writes a PNG with
`utils/fileio.py:write_png`. There is no window to show an image in on
either machine the port runs on, so with $DISPLAY set `show` raises
instead of opening one.
"""

from __future__ import annotations

import os

import numpy as np

from .. import runtime
from .fileio import write_png


def fuse_fgbg(fg: np.ndarray, bg: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """fg over bg by `mask` (0..255), uint8."""
    a = mask.astype(np.float32)[..., None] / 255.0
    out = a * fg.astype(np.float32) + (1.0 - a) * bg.astype(np.float32)
    return out.astype(np.uint8)


def get_roi(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The image weighted by `mask` (0..255): black outside it."""
    out = img.astype(np.float32) * (mask.astype(np.float32)[..., None] / 255.0)
    return out.astype(np.uint8)


def highlight_roi(img: np.ndarray, mask: np.ndarray,
                  ratio: float = 0.5) -> np.ndarray:
    """A red overlay on the ROI: the last (red, BGR) channel blended
    toward the mask where it is not 0."""
    out = img.copy()
    red = (ratio * out[:, :, -1].astype(np.float32)
           + (1.0 - ratio) * mask.astype(np.float32))
    out[:, :, -1] = np.where(mask == 0, img[:, :, -1],
                             red.astype(np.uint8))
    return out


def tocolor(img: np.ndarray) -> np.ndarray:
    """A gray (h, w) image as BGR (its value in each channel); a colour
    image as it is."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img


def show(img: np.ndarray, downscale: int = 1,
         fallback_path: str = "unscreen_show.png") -> str:
    """Write `img` (uint8 gray or BGR), its sides first divided by
    `downscale` (cv2.resize's INTER_LINEAR), to the PNG `fallback_path`;
    returns the path. With $DISPLAY set this raises: the port has no
    window to show it in."""
    if not isinstance(downscale, int):
        raise TypeError(f"downscale must be an int, got {downscale!r}")
    if os.environ.get("DISPLAY"):
        raise RuntimeError("show: the port opens no window; unset DISPLAY "
                           "to write the image to fallback_path")
    img = np.ascontiguousarray(img, np.uint8)
    if downscale != 1:
        h, w = img.shape[:2]
        img = runtime.resize_batch([img], (h // downscale,
                                           w // downscale))[0]
    write_png(fallback_path, img)
    return fallback_path


def show_dist_hist(samples: np.ndarray, num_hist: int = 20,
                   size: tuple = (320, 480),
                   fallback_path: str = "unscreen_hist.png") -> np.ndarray:
    """A histogram of samples in [0, 1] drawn as filled bars on a white
    BGR canvas of `size`, written by `show`; returns the canvas."""
    hist, _ = np.histogram(np.asarray(samples), num_hist, range=(0, 1))
    h, w = size
    canvas = np.full((h, w, 3), 255, np.uint8)
    peak = max(int(hist.max()), 1)
    bar_w = w // num_hist
    for i, count in enumerate(hist):
        bh = int((h - 20) * count / peak)
        x0 = i * bar_w + 1
        # cv2.rectangle(..., -1): both corners included
        canvas[max(h - 10 - bh, 0):h - 10 + 1,
               max(x0, 0):x0 + bar_w - 2 + 1] = (180, 90, 30)
    show(canvas, fallback_path=fallback_path)
    return canvas
