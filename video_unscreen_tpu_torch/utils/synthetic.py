"""Seeded synthetic inputs of the port's card runs: `chip_smoke.py` and
the profile and compare tools (`tools/*_torch*.py`).

`green_clip` makes green-screen frames with their ground truth, `soft_mask`
a grayscale mask for morphology, `bg_config` the bg configuration the card
runs (configs/bg.json with the weights-free chroma seed), and `iou` scores
an alpha against its ground truth. numpy only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import load_config

ROOT = Path(__file__).resolve().parents[2]


def green_clip(n, h, w, seed):
    """A magenta ellipse moving right over a noisy green screen (the
    pattern of the repo's synthetic clips; radii 260 x 170 and 6 px per
    frame at 1080p, scaled with the frame), and its GT alpha."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ry, rx, step = 260.0 * h / 1080, 170.0 * w / 1920, 6.0 * w / 1920
    frames, gts = [], []
    for t in range(n):
        blob = ((yy - h // 2) ** 2 / ry ** 2
                + (xx - (w // 3 + step * t)) ** 2 / rx ** 2) < 1.0
        img = np.empty((h, w, 3), np.float32)
        img[...] = (40, 190, 50)
        img[blob] = (150, 60, 170)
        img += rng.randn(h, w, 3).astype(np.float32) * 4
        frames.append(img.clip(0, 255).astype(np.uint8))
        gts.append(blob)
    return frames, gts


def soft_mask(h, w, seed):
    """Seeded soft ellipse with speckle: a grayscale mask for morphology."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w), np.float32)
    a[((yy - h // 2) ** 2 / (h * 0.3) ** 2
       + (xx - w // 3) ** 2 / (w * 0.2) ** 2) < 1.0] = 255.0
    a *= rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    a[rng.rand(h, w) < 0.002] = 200.0
    return a


def bg_config(stm_weights, matting_weights):
    """configs/bg.json with the weights-free chroma seed at 960 in place of
    SCHP: the card's copy cannot hold the SCHP weights, and the quality
    bars need a seed that finds the synthetic subject."""
    cfg = load_config(str(ROOT / "configs" / "bg.json"))
    cfg["binseg"] = {"type": "chroma", "input_long_side": 960}
    cfg["stm"]["model_path"] = str(stm_weights)
    cfg["vmatting"]["model_path"] = str(matting_weights)
    return cfg


def iou(alpha, gt):
    p = alpha >= 128
    return float((gt & p).sum() / max((gt | p).sum(), 1))
