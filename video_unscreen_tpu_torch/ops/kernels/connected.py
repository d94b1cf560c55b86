"""K3 (connected-component labels with dense ids): wrapper and plain
version.

Replaces the Pallas TPU kernel `video_unscreen_tpu/ops/pallas/flood.py:
_flood_kernel` (entry `connected_components_compact`); the CUDA source is
`csrc/flood.cu`. Both versions return, for `mask > 0`:

- `labels`: 1 + the largest flat index of the pixel's 4-connected
  component, 0 off the mask (the JAX `ops/connected.py:connected_components`);
- `compact`: the component's rank 1..K when components are ordered by their
  last pixel in raster order (the Pallas kernel's `cid`).

Unlike the JAX flood, neither version stops after 64 sweeps: they agree
with it on every mask the JAX flood labels within its cap.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .morph import LaunchCount

FLOOD = LaunchCount("flood")

# convergence is checked every this many propagation steps (one host sync)
_CHECK_EVERY = 16


def _rank_roots(seg: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """Dense ids from converged labels: the raster rank of each root."""
    h, w = seg.shape
    ids = torch.arange(1, h * w + 1, device=seg.device,
                       dtype=torch.int32).reshape(h, w)
    root = (seg & (lbl == ids)).reshape(-1).to(torch.int32)
    rank = torch.cumsum(root, 0, dtype=torch.int32)
    idx = (lbl.reshape(-1).to(torch.int64) - 1).clamp_min(0)
    return torch.where(seg, rank[idx].reshape(h, w), 0)


def cc_plain(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterated 4-neighbour max propagation within the mask until stable,
    then the raster ranking of the roots."""
    seg = mask > 0
    h, w = seg.shape
    ids = torch.arange(1, h * w + 1, device=mask.device,
                       dtype=torch.int32).reshape(h, w)
    lbl = torch.where(seg, ids, 0)
    while True:
        prev = lbl
        for _ in range(_CHECK_EVERY):
            nb = lbl.clone()
            nb[1:] = torch.maximum(nb[1:], lbl[:-1])
            nb[:-1] = torch.maximum(nb[:-1], lbl[1:])
            nb[:, 1:] = torch.maximum(nb[:, 1:], lbl[:, :-1])
            nb[:, :-1] = torch.maximum(nb[:, :-1], lbl[:, 1:])
            lbl = torch.where(seg, nb, 0)
        if torch.equal(lbl, prev):
            break
    return lbl, _rank_roots(seg, lbl)


def connected_components_compact(
        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (labels, compact) int32 maps of `mask > 0` for an (H, W) mask."""
    if mask.device.type == "cpu":
        return cc_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"connected_components_compact: needs a CPU or "
                         f"CUDA tensor, got {mask.device}")
    if (mask.dtype != torch.float32 or mask.dim() != 2
            or not mask.is_contiguous()):
        raise ValueError(
            f"connected_components_compact: needs a contiguous 2-D float32 "
            f"tensor, got {mask.dtype} {tuple(mask.shape)} "
            f"contiguous={mask.is_contiguous()}")
    lib = build.library()
    h, w = mask.shape
    labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    compact = torch.empty_like(labels)
    counts = torch.empty(-(-h * w // 1024), dtype=torch.int32,
                         device=mask.device)
    launches = ctypes.c_int(0)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vut_flood(mask.data_ptr(), labels.data_ptr(),
                            compact.data_ptr(), counts.data_ptr(), h, w,
                            stream, ctypes.addressof(launches))
    build.check(err, "flood kernel")
    FLOOD.add(launches)
    return labels, compact
