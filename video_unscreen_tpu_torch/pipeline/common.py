"""Shared pipeline helpers."""

from __future__ import annotations

import functools

import numpy as np

from ..ops.connected import score_map


@functools.lru_cache(maxsize=16)
def _score_map(h: int, w: int, center) -> np.ndarray:
    sm = score_map(h, w, center)
    sm.setflags(write=False)
    return sm


def build_score_map(h: int, w: int, cfg: dict) -> np.ndarray:
    """Landscape/portrait location score map from the config, cached per
    geometry (port of `video_unscreen_tpu/pipeline/common.py`)."""
    centers = cfg["objectremoval"]["score_map_center"]
    center = tuple(centers["landscape"] if w > h else centers["portrait"])
    return _score_map(h, w, center)
