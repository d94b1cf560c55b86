"""Shared pipeline helpers (port of `video_unscreen_tpu/pipeline/common.py`):
the location score map, config-driven object removal, the host-side
foreground gate and artifact names."""

from __future__ import annotations

import functools
import os.path as osp
from typing import Optional

import numpy as np
import torch

from ..ops.connected import remove_invalid_objects, score_map


@functools.lru_cache(maxsize=16)
def _score_map(h: int, w: int, center) -> np.ndarray:
    sm = score_map(h, w, center)
    sm.setflags(write=False)
    return sm


def _center(h: int, w: int, cfg: dict):
    centers = cfg["objectremoval"]["score_map_center"]
    return tuple(centers["landscape"] if w > h else centers["portrait"])


def build_score_map(h: int, w: int, cfg: dict) -> np.ndarray:
    """Landscape/portrait location score map from the config, cached per
    geometry."""
    return _score_map(h, w, _center(h, w, cfg))


@functools.lru_cache(maxsize=16)
def _score_tensor(h: int, w: int, center, device: torch.device):
    return torch.from_numpy(np.array(_score_map(h, w, center))).to(device)


def remove_invalid_objects_cfg(cfg: dict, alpha: torch.Tensor,
                               segmask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Object removal at full resolution with the config's thresholds; the
    segmask defaults to the alpha itself. Takes uint8 or float (H, W)
    tensors and returns a uint8 tensor on the alpha's device."""
    a = alpha.to(torch.float32)
    seg = a if segmask is None else segmask.to(torch.float32)
    h, w = a.shape
    out = remove_invalid_objects(
        a, seg, _score_tensor(h, w, _center(h, w, cfg), a.device),
        saliency_thr=float(cfg["objectremoval"]["saliency_thr"]),
        consensus_thr=float(cfg["objectremoval"]["consensus_thr"]))
    return out.to(torch.uint8)


def exist_foreground_np(mask, thr: float) -> bool:
    """Host-side foreground gate: (mask >= 128).sum() > thr * h * w (one
    device sync for a CUDA tensor)."""
    h, w = mask.shape
    return bool((torch.as_tensor(mask) >= 128).sum() > thr * h * w)


def artifact_path(dst_dir: str, kind: str, fid: int) -> str:
    return osp.join(dst_dir, f"{kind}_{fid:06d}.jpg")
