"""Connected components and invalid-object removal.

Port of `video_unscreen_tpu/ops/connected.py`. Labeling is kernel K3 on a
CUDA tensor and its plain version on a CPU tensor
(`ops/kernels/connected.py`). The per-object sums (area, location
saliency, segmask consensus) are `index_add_` into a static h*w+1 bins
indexed by the dense component id: no host sync and no bin clamp, the
decisions of the JAX `remove_invalid_objects` (the path the JAX package
runs off-TPU), not of its 1024-bin TPU variant.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import resize
from .kernels.connected import connected_components_compact


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """4-connected labels of `mask > 0`: 0 is background, a component is
    labeled 1 + its largest flat pixel index."""
    return connected_components_compact(mask)[0]


def score_map(h: int, w: int, center=(0.5, 0.5)) -> np.ndarray:
    """Location score map: 1 at `center`, falling to 0 at the borders."""
    sm = np.ones((h, w), np.float64)
    y, x = int(h * center[0]), int(w * center[1])
    if w - x > 0:
        sm[:, x:w] = np.linspace(0, 1, w - x)[None, :] ** 2
    if x > 0:
        sm[:, 0:x] = np.linspace(1, 0, x)[None, :] ** 2
    if h - y > 0:
        sm[y:h] += np.linspace(0, 1, h - y)[:, None] ** 2
    if y > 0:
        sm[0:y] += np.linspace(1, 0, y)[:, None] ** 2
    sm = np.sqrt(sm)
    sm = (sm.max() - sm) / sm.max()
    return sm.astype(np.float32)


def remove_invalid_objects(alpha: torch.Tensor, segmask: torch.Tensor,
                           score: torch.Tensor, saliency_thr: float = 0.005,
                           consensus_thr: float = 0.5,
                           min_area: int = 100) -> torch.Tensor:
    """Zero foreground blobs that are small, off-center or not agreed by
    the segmentation mask.

    Per component: saliency = sum(score) / (h*w), consensus = mean of
    segmask/255. Keep iff area >= min_area and ((saliency > thr and
    consensus > consensus_thr) or saliency > 10*thr)."""
    h, w = alpha.shape
    _, cid = connected_components_compact(alpha)
    flat = cid.reshape(-1).to(torch.int64)
    n = h * w + 1
    ones = (flat > 0).to(torch.float32)
    zeros = torch.zeros(n, dtype=torch.float32, device=alpha.device)
    area = zeros.index_add(0, flat, ones)
    sal = zeros.index_add(0, flat, score.reshape(-1) * ones)
    cons = zeros.index_add(0, flat, (segmask.reshape(-1) / 255.0) * ones)
    saliency = sal / float(h * w)
    consensus = cons / area.clamp_min(1.0)
    valid = (area >= min_area) & (
        ((saliency > saliency_thr) & (consensus > consensus_thr))
        | (saliency > saliency_thr * 10.0))
    valid[0] = False
    keep = valid[flat].reshape(h, w)
    return torch.where(keep, alpha, 0.0)


def remove_invalid_objects_ds(alpha: torch.Tensor, segmask: torch.Tensor,
                              score: torch.Tensor,
                              saliency_thr: float = 0.005,
                              consensus_thr: float = 0.5,
                              min_area: int = 100,
                              downscale: int = 2) -> torch.Tensor:
    """remove_invalid_objects with labeling and sums at 1/downscale
    resolution (nearest resampling); `min_area` scales by downscale**2 and
    the keep-mask is resampled back onto the full-resolution alpha."""
    if downscale == 1:
        return remove_invalid_objects(alpha, segmask, score, saliency_thr,
                                      consensus_thr, min_area)
    h, w = alpha.shape
    lo = (h // downscale, w // downscale)
    kept = remove_invalid_objects(
        resize(alpha, lo, "nearest"), resize(segmask, lo, "nearest"),
        resize(score, lo, "nearest"), saliency_thr, consensus_thr,
        max(min_area // (downscale * downscale), 1))
    keep = resize((kept > 0).to(torch.float32), (h, w), "nearest") > 0
    return torch.where(keep, alpha, 0.0)
