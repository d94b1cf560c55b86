"""Shared pipeline helpers (port of `video_unscreen_tpu/pipeline/common.py`):
the location score map, config-driven object removal, the host-side
foreground gate and artifact names; and the fused pipelines' frame resize
on the device (`prep_frames`) and segment loop (`run_segments`)."""

from __future__ import annotations

import collections
import functools
import os.path as osp
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.connected import remove_invalid_objects, score_map
from ..ops.geometry import resize_nchw


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


def prep_frames(frames_full: torch.Tensor,
                work_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 (S, H, W, 3) on the device -> float32 at work resolution
    (resized on the device: the JAX pipelines' `host_downscale=False`)."""
    x = frames_full.to(torch.float32)
    if tuple(x.shape[1:3]) == tuple(work_hw):
        return x
    y = resize_nchw(x.permute(0, 3, 1, 2), work_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def run_segments(step: Callable, carries, frames, n_segments: int,
                 chunk_size: int, device: torch.device,
                 stats: collections.Counter) -> np.ndarray:
    """The fused pipelines' host loop. The clip is split into `n_segments`
    contiguous segments of ceil(N / S) frames (the tail padded with the
    last frame) advanced in lockstep: each step uploads one uint8 frame a
    segment, (S, H, W, 3), and `step(carries, frames)` returns (carries,
    uint8 (S, h, w, C) outputs); the outputs are fetched once every
    `chunk_size` steps (one sync each, counted in `stats`). Returns the
    (N, h, w, C) outputs in clip order, trimmed to N frames."""
    frames = list(frames)
    n = len(frames)
    seg_len = -(-n // n_segments)
    padded = frames + [frames[-1]] * (n_segments * seg_len - n)
    chunks = []
    for c0 in range(0, seg_len, chunk_size):
        outs = []
        for t in range(c0, min(c0 + chunk_size, seg_len)):
            batch = np.stack([np.asarray(padded[s * seg_len + t], np.uint8)
                              for s in range(n_segments)])
            carries, out = step(carries, torch.from_numpy(batch).to(device))
            outs.append(out)
        chunks.append(torch.stack(outs, dim=1).cpu().numpy())
        stats["syncs"] += 1
    # (S, seg_len, h, w, C) -> clip order, trimmed
    return np.concatenate(chunks, axis=1).reshape(
        (n_segments * seg_len,) + chunks[0].shape[2:])[:n]
