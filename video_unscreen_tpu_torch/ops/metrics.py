"""Matting quality metrics: MIOU / SAD / MSE / GRAD / CONN (+ ROI SAD).

Port of `video_unscreen_tpu/ops/metrics.py`, the scoring of the evaluation
protocol (`pipeline/evaluate.py`). Each metric takes two (H, W) float32
alphas on 0..255 on the caller's device and returns a 0-d float32 tensor
there (`gradient_error` copies its 9x9 filter from the host, a host
sync, and `connectivity_error` syncs as below).

- `roi_sad` dilates and erodes the GT by the 5x5 ellipse ten times: K2
  (`ops/kernels/morph.py`) on a CUDA tensor, one launch a call.
- `gradient_error` is a correlation with edge padding (`F.pad(...,
  "replicate")`, then `F.conv2d`), as cv2.filter2D with BORDER_REPLICATE;
  the entry points keep TF32 off (`utils/device.py`).
- `connectivity_error` labels the 11 thresholded intersections with K3
  (`ops/kernels/connected.py`, its plain version on a CPU tensor) and
  counts each component's area with `torch.bincount` over the dense
  `compact` ids (K bins for K components; on a CUDA tensor bincount reads
  the largest id, one host sync a threshold). `compact` ranks components
  by their last pixel in raster order, the order of the JAX labels (1 + the
  largest flat index), so the first maximum of the areas is the component
  `jnp.argmax` picks among equal areas: the one with the smallest label.
  The thresholds are built as the JAX package builds them, bit for bit:
  int32 1..11 times float32 0.1 in float32, and t - 0.1 in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.connected import connected_components_compact
from .morphology import dilate, erode


def miou(alpha: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean of the fg and bg IoU, each 1 when its union is under 0.1% of
    the image."""
    h, w = alpha.shape

    def iou(a, p):
        inter = (a & p).sum()
        union = (a | p).sum()
        return torch.where(union < h * w * 0.001, 1.0,
                           inter / union.clamp_min(1))

    fg = iou(alpha > 127, pred > 127)
    bg = iou(alpha < 128, pred < 128)
    return (fg + bg) / 2.0


def _sqrt_area(h: int, w: int) -> float:
    """sqrt(h * w) rounded to float32, as `jnp.sqrt(float(h * w))`."""
    return float(np.sqrt(np.float32(h * w)))


def sad(alpha: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Sum of |pred - alpha| / 255, over sqrt(h * w)."""
    h, w = alpha.shape
    return (torch.abs((pred - alpha) / 255.0).sum()
            / _sqrt_area(h, w))


def roi_sad(alpha: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean |pred - alpha| / 255 inside the GT's boundary band (the 5x5
    ellipse's dilate XOR erode, 10 iterations each)."""
    roi = (dilate(alpha) > 0) ^ (erode(alpha) > 0)
    diff = torch.abs((pred - alpha) / 255.0)
    return torch.where(roi, diff, 0.0).sum() / roi.sum().clamp_min(1)


def mse(alpha: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Sum of the squared difference of the 0..1 alphas, / 1000."""
    d = (pred - alpha) / 255.0
    return (d * d).sum() / 1000.0


def _gauss_filter(sigma: float, epsilon: float = 1e-2) -> np.ndarray:
    """The x Gaussian-derivative filter, L2-normalized, built on the host
    in float64 and cast to float32."""
    half = np.ceil(sigma * np.sqrt(-2 * np.log(np.sqrt(2 * np.pi) * sigma
                                               * epsilon)))
    size = int(2 * half + 1)
    i = np.arange(size) - half
    g = np.exp(-i ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * np.pi))
    dg = -i * g / sigma ** 2
    fx = g[:, None] * dg[None, :]
    return (fx / np.sqrt((fx ** 2).sum())).astype(np.float32)


def _conv2d_replicate(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Correlation of an (H, W) image with a (kh, kw) kernel, edge
    pixels repeated (cv2.filter2D's BORDER_REPLICATE)."""
    kh, kw = kern.shape
    padded = F.pad(img[None, None], (kw // 2, kw // 2, kh // 2, kh // 2),
                   mode="replicate")
    return F.conv2d(padded, kern[None, None])[0, 0]


def gradient_error(alpha: torch.Tensor, pred: torch.Tensor,
                   sigma: float = 1.4) -> torch.Tensor:
    """Squared difference of the Gaussian-derivative gradient magnitudes
    of the min-max normalized alphas, / 1000."""
    fx = torch.from_numpy(_gauss_filter(sigma)).to(alpha.device)
    fy = fx.T.contiguous()

    def normed_grad(a):
        lo = a.min()
        a = (a - lo) / torch.clamp(a.max() - lo, min=1e-8)
        gx = _conv2d_replicate(a, fx)
        gy = _conv2d_replicate(a, fy)
        return torch.sqrt(gx * gx + gy * gy)

    d = normed_grad(alpha) - normed_grad(pred)
    return (d * d).sum() / 1000.0


def thresholds(step: float = 0.1) -> np.ndarray:
    """(1 .. round(1 / step) + 1) * step in float32, as the JAX package's
    `jnp.arange(1, n + 2) * step` (int32 times float32 in float32)."""
    n_steps = int(round(1.0 / step))
    return (np.arange(1, n_steps + 2, dtype=np.int32).astype(np.float32)
            * np.float32(step))


def connectivity_error(alpha: torch.Tensor, pred: torch.Tensor,
                       step: float = 0.1) -> torch.Tensor:
    """Connectivity error over the largest 4-connected component of each
    thresholded intersection of the GT and the prediction."""
    a = alpha / 255.0
    p = pred / 255.0
    round_down = torch.full_like(a, -1.0)
    for t in thresholds(step):
        # each threshold and t - step a float32 value, held exactly by
        # the Python float the comparisons and the select take
        inter = (a >= float(t)) & (p >= float(t))
        _, compact = connected_components_compact(inter.to(torch.float32))
        area = torch.bincount(compact.reshape(-1))
        area[0] = 0
        omega = (compact == torch.argmax(area)) & inter
        newly_off = (round_down == -1.0) & ~omega
        round_down = torch.where(newly_off, float(t - np.float32(step)),
                                 round_down)
    round_down = torch.where(round_down == -1.0, 1.0, round_down)
    a_diff = a - round_down
    p_diff = p - round_down
    a_phi = 1.0 - a_diff * (a_diff >= 0.15)
    p_phi = 1.0 - p_diff * (p_diff >= 0.15)
    return torch.abs(a_phi - p_phi).sum() / 1000.0
