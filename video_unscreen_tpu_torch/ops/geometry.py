"""Geometry ops: target sizes, resize, pad/resize, normalization.

Port of `video_unscreen_tpu/ops/geometry.py` on (H, W[, C]) tensors:

- `resize` "linear" samples at half-pixel centres without antialiasing
  (`jax.image.resize(..., antialias=False)`, torch `bilinear` with
  `align_corners=False`); "nearest" reproduces `jax.image.resize`'s index
  rule exactly (floor((i + 0.5) * in / out) in float32), which is torch's
  "nearest-exact".
- `resize_nchw`'s gradient is the product with the transposed
  interpolation matrices (`_linear_matrix`, two matmuls), so a train
  step's gradients on the card are the same bits from run to run: torch's
  own CUDA backward of a bilinear resize sums with atomics. Its forward,
  and the whole resize where no gradient is taken, is `F.interpolate`.
- `pad_resize` pads "symmetric" (the edge row repeated, cv2
  BORDER_REFLECT), built by hand: torch's "reflect" is REFLECT_101.
- `affine_warp_axis_aligned` (the SCHP seed's person-box warp) is two
  products with resampling matrices built on the host in float64 and cast
  to float32, as in the JAX package.
- `affine_warp` is the general 2x3 warp (bilinear, zero fill), the inverse
  taken from the matrix in float32 on the tensor's device and each output
  sampled as `jax.scipy.ndimage.map_coordinates(order=1, mode="constant")`
  does: four corners weighted (1 - f) or f along y and x, a corner outside
  the image counting 0, summed in map_coordinates' order. No path of the
  port calls it (the seed uses the axis-aligned form); `get_affine_params`
  builds its person-box matrices, and `remove_blackborder` and
  `add_blackborder` crop and restore all-zero borders, on the host.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics of the reference preprocessing
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def get_target_size(h: int, w: int, target_long_side: int,
                    division: int = 1) -> Tuple[int, int]:
    """Long side to `target_long_side`, aspect kept, short side rounded UP
    to a multiple of `division`."""
    if h > w:
        th = target_long_side
        tw = int(float(target_long_side) * w / h)
        if tw % division != 0:
            tw = (tw // division + 1) * division
    else:
        tw = target_long_side
        th = int(float(target_long_side) * h / w)
        if th % division != 0:
            th = (th // division + 1) * division
    return th, tw


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).to(torch.int64).clamp_max(n_in - 1)


def resize(img: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "linear") -> torch.Tensor:
    """Resize an (H, W[, C]) image to `out_hw` with half-pixel sampling."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(img.shape[:2]) == out_hw:
        return img
    if method == "nearest":
        ys = _nearest_index(img.shape[0], out_hw[0], img.device)
        xs = _nearest_index(img.shape[1], out_hw[1], img.device)
        return img.index_select(0, ys).index_select(1, xs)
    if method != "linear":
        raise ValueError(f"resize: unknown method {method!r}")
    x = img.permute(2, 0, 1)[None] if img.dim() == 3 else img[None, None]
    y = resize_nchw(x, out_hw)[0]
    return y.permute(1, 2, 0).contiguous() if img.dim() == 3 else y[0]


@functools.lru_cache(maxsize=64)
def _linear_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) weights of torch's "bilinear" along one axis
    (align_corners=False, no antialiasing): source (i + 0.5) n_in / n_out
    - 0.5, at least 0, its two neighbours weighted by the fraction,
    computed in the type torch computes them in (float32, or float64 for
    float64), held in `dtype`. Built once per shape, type and device: a
    train step or a BRS call takes the same few for every backward."""
    dt = torch.promote_types(dtype, torch.float32)
    scale = torch.tensor(n_in / n_out, dtype=dt)
    src = (scale * (torch.arange(n_out, dtype=dt, device=device) + 0.5)
           - 0.5).clamp_min(0.0)
    i0 = src.to(torch.int64)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    frac = src - i0.to(dt)
    mat = torch.zeros(n_out, n_in, dtype=dt, device=device)
    rows = torch.arange(n_out, device=device)
    mat.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    mat.index_put_((rows, i1), frac, accumulate=True)
    return mat.to(dtype)


class _ResizeNCHW(torch.autograd.Function):
    """`F.interpolate` bilinear forward; the backward g -> A_h^T g A_w."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    def backward(ctx, grad):
        (h, w), (oh, ow) = ctx.in_hw, grad.shape[-2:]
        a_h = _linear_matrix(h, oh, grad.dtype, grad.device)
        a_w = _linear_matrix(w, ow, grad.dtype, grad.device)
        return torch.matmul(torch.matmul(a_h.t(), grad), a_w), None


def resize_nchw(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """"linear" `resize` of an (N, C, H, W) batch; where a gradient is
    taken, with the deterministic one above."""
    size = (int(out_hw[0]), int(out_hw[1]))
    if x.requires_grad and torch.is_grad_enabled():
        return _ResizeNCHW.apply(x, size)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def _fit_size(h: int, w: int, target_h: int, target_w: int):
    """(new_h, new_w, pad_h, pad_w, ratio) of an aspect-keeping fit."""
    if float(h) / w > float(target_h) / target_w:
        new_h = target_h
        ratio = float(target_h) / h
        new_w = int(float(target_h) * w / h)
        pad_h, pad_w = 0, target_w - new_w
    else:
        new_w = target_w
        ratio = float(target_w) / w
        new_h = int(float(target_w) * h / w)
        pad_h, pad_w = target_h - new_h, 0
    return new_h, new_w, pad_h, pad_w, ratio


def _pad_symmetric(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad bottom/right by mirroring with the edge included (numpy
    "symmetric")."""
    if pad_h > x.shape[0] or pad_w > x.shape[1]:
        raise ValueError("symmetric pad wider than the image")
    if pad_h:
        x = torch.cat([x, x[x.shape[0] - pad_h:].flip(0)], dim=0)
    if pad_w:
        x = torch.cat([x, x[:, x.shape[1] - pad_w:].flip(1)], dim=1)
    return x


def pad_resize(img: torch.Tensor, target_hw: Tuple[int, int],
               method: str = "linear") -> torch.Tensor:
    """Aspect-keeping resize, then symmetric pad bottom/right to
    `target_hw`."""
    h, w = img.shape[:2]
    new_h, new_w, pad_h, pad_w, _ = _fit_size(h, w, *target_hw)
    return _pad_symmetric(resize(img, (new_h, new_w), method), pad_h, pad_w)


def inv_pad_resize(img: torch.Tensor, ori_hw: Tuple[int, int],
                   method: str = "linear") -> torch.Tensor:
    """Crop the padding of `pad_resize` and resize back to `ori_hw`."""
    h, w = img.shape[:2]
    ori_h, ori_w = ori_hw
    if float(ori_h) / ori_w > float(h) / w:
        resized_h = h
        resized_w = int(float(h) * ori_w / ori_h)
    else:
        resized_w = w
        resized_h = int(float(w) * ori_h / ori_w)
    return resize(img[:resized_h, :resized_w], (ori_h, ori_w), method)


def imnormalize(img: torch.Tensor, mean=IMAGENET_MEAN,
                std=IMAGENET_STD) -> torch.Tensor:
    """BGR(0..255) -> RGB, /255, then (x - mean) / std per channel."""
    rgb = img.flip(-1) / 255.0
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=img.device)
    std = torch.as_tensor(np.asarray(std, np.float32), device=img.device)
    return (rgb - mean) / std


def _lerp_matrix(out_size: int, scale: float, offset: float,
                 in_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear-resampling matrix of the 1-D map
    src = scale * dst + offset; out-of-range neighbours contribute 0."""
    o = np.arange(out_size, dtype=np.float64)
    src = scale * o + offset
    i0 = np.floor(src).astype(np.int64)
    w = (src - i0).astype(np.float64)
    a = np.zeros((out_size, in_size), np.float64)
    for idx, wt in ((i0, 1.0 - w), (i0 + 1, w)):
        valid = (idx >= 0) & (idx < in_size)
        np.add.at(a, (o[valid].astype(np.int64), idx[valid]), wt[valid])
    return a.astype(np.float32)


def warp_matrices(matrix: np.ndarray, in_hw: Tuple[int, int],
                  out_hw: Tuple[int, int], device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """(A_y, A_x) of an axis-aligned 2x3 affine `matrix` (src -> dst, as
    cv2.warpAffine; pure scale and translation), as float32 tensors on
    `device`: output(dst) samples the input at M^-1 dst."""
    m = np.asarray(matrix, np.float64)
    if m[0, 1] != 0.0 or m[1, 0] != 0.0:
        raise ValueError("affine_warp_axis_aligned needs an axis-aligned "
                         "matrix")
    sx, tx, sy, ty = m[0, 0], m[0, 2], m[1, 1], m[1, 2]
    ay = _lerp_matrix(out_hw[0], 1.0 / sy, -ty / sy, in_hw[0])
    ax = _lerp_matrix(out_hw[1], 1.0 / sx, -tx / sx, in_hw[1])
    return (torch.from_numpy(ay).to(device),
            torch.from_numpy(ax).to(device))


def warp_planes(x: torch.Tensor, ay: torch.Tensor,
                ax: torch.Tensor) -> torch.Tensor:
    """A_y @ x @ A_x^T over the last two axes of a float (..., H, W)
    stack: the rows first, then the columns, as the JAX package's two
    einsums."""
    return torch.matmul(torch.matmul(ay, x.to(torch.float32)), ax.T)


def affine_warp_axis_aligned(img: torch.Tensor, matrix: np.ndarray,
                             out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear warp with zero fill of an (H, W[, C]) image, or a (B, H, W,
    C) batch, by an axis-aligned host `matrix`, as two resampling
    products; float32 out."""
    hw_axes = (0, 1) if img.dim() < 4 else (1, 2)
    in_hw = (img.shape[hw_axes[0]], img.shape[hw_axes[1]])
    ay, ax = warp_matrices(matrix, in_hw, out_hw, img.device)
    if img.dim() == 2:
        return warp_planes(img, ay, ax)
    x = img.movedim(-1, -3)               # channels before H, W
    return warp_planes(x, ay, ax).movedim(-3, -1)


def remove_blackborder(img: np.ndarray, location=None):
    """Crop the all-zero border rows and columns of a host image: (crop,
    (top, left, bottom, right)); with `location` given, just that crop. An
    image with no nonzero row or column comes back whole."""
    h, w = img.shape[:2]
    if location is not None:
        t, left, b, r = location
        return img[t:b, left:r]
    rows = img.reshape(h, -1).sum(axis=1)
    cols = np.moveaxis(img, 1, 0).reshape(w, -1).sum(axis=1)
    t = int(np.argmax(rows > 0)) if (rows > 0).any() else 0
    b = h - int(np.argmax(rows[::-1] > 0)) if (rows > 0).any() else h
    left = int(np.argmax(cols > 0)) if (cols > 0).any() else 0
    r = w - int(np.argmax(cols[::-1] > 0)) if (cols > 0).any() else w
    if left >= r or t >= b:
        return img, (0, 0, h, w)
    return img[t:b, left:r], (t, left, b, r)


def add_blackborder(img: np.ndarray, ori_size, location) -> np.ndarray:
    """Inverse of `remove_blackborder`: `img` placed at `location` in zeros
    of `ori_size` (h, w)."""
    t, left, b, r = location
    ori_h, ori_w = ori_size
    out = np.zeros((ori_h, ori_w) + img.shape[2:], img.dtype)
    out[t:b, left:r] = img
    return out


def get_affine_params(center_xy, src_size, dst_hw,
                      inv: bool = False) -> np.ndarray:
    """The float32 2x3 matrix that scales a `src_size` (w, h) box centred at
    `center_xy` to fill `dst_hw`: src -> dst pixel coordinates, or dst ->
    src with `inv`."""
    cx, cy = float(center_xy[0]), float(center_xy[1])
    sw, sh = float(src_size[0]), float(src_size[1])
    dh, dw = int(dst_hw[0]), int(dst_hw[1])
    scale_x, scale_y = dw / sw, dh / sh
    if not inv:   # p_dst = S (p_src - c) + d / 2
        return np.array([[scale_x, 0.0, dw / 2.0 - scale_x * cx],
                         [0.0, scale_y, dh / 2.0 - scale_y * cy]],
                        np.float32)
    return np.array([[1.0 / scale_x, 0.0, cx - dw / (2.0 * scale_x)],
                     [0.0, 1.0 / scale_y, cy - dh / (2.0 * scale_y)]],
                    np.float32)


def affine_warp(img: torch.Tensor, matrix,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Warp an (H, W[, C]) image by a 2x3 affine `matrix` (src -> dst, as
    cv2.warpAffine): output(p) = input(M^-1 p), bilinear, zero outside;
    float32 out (the module docstring)."""
    m = torch.as_tensor(np.asarray(matrix), dtype=torch.float32,
                        device=img.device)
    a, b, tx = m[0, 0], m[0, 1], m[0, 2]
    c, d, ty = m[1, 0], m[1, 1], m[1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    gy = torch.arange(out_h, dtype=torch.float32, device=img.device)[:, None]
    gx = torch.arange(out_w, dtype=torch.float32, device=img.device)[None]
    src_x = ia * gx + ib * gy + itx
    src_y = ic * gx + id_ * gy + ity
    in_h, in_w = img.shape[:2]
    x = img.to(torch.float32)

    def taps(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        i = lower.to(torch.int64)
        return [(i, 1 - upper_w), (i + 1, upper_w)]

    out = None
    for yi, wy in taps(src_y, in_h):
        for xi, wx in taps(src_x, in_w):
            valid = (yi >= 0) & (yi < in_h) & (xi >= 0) & (xi < in_w)
            v = x[yi.clamp(0, in_h - 1), xi.clamp(0, in_w - 1)]
            if x.dim() == 3:
                valid, wgt = valid[..., None], (wy * wx)[..., None]
            else:
                wgt = wy * wx
            term = wgt * torch.where(valid, v, 0.0)
            out = term if out is None else out + term
    return out
