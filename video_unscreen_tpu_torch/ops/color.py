"""Color-space conversions in OpenCV 8-bit ranges on float tensors.

Port of `video_unscreen_tpu/ops/color.py` (`bgr2rgb`, `bgr2gray`,
`bgr2hsv`, `hsv2bgr`, `bgr2lab`, `yuv420_to_bgr`): HSV with H in 0..180
and S/V in 0..255, Lab as L*255/100 and a/b offset by 128, so the
pipeline's windows and thresholds carry over.
Channels are last, as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8

# sRGB(D65) -> XYZ, as OpenCV's RGB2Lab (sRGB gamma applied first)
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XN, _ZN = 0.950456, 1.088754


def bgr2rgb(img: torch.Tensor) -> torch.Tensor:
    return img.flip(-1)


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_BGR2GRAY on floats: 0.299 R + 0.587 G + 0.114 B. For
    uint8 images cv2 rounds in fixed point instead:
    `runtime.bgr_to_gray`."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def bgr2hsv(img: torch.Tensor) -> torch.Tensor:
    """BGR(0..255) -> HSV with H in 0..180, S/V in 0..255."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    s = torch.where(v > 0, 255.0 * c / v.clamp_min(_EPS), 0.0)
    cc = c.clamp_min(_EPS)
    h_r = 60.0 * (g - b) / cc
    h_g = 120.0 + 60.0 * (b - r) / cc
    h_b = 240.0 + 60.0 * (r - g) / cc
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(c <= _EPS, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0
    return torch.stack([h, s, v], dim=-1)


def hsv2bgr(img: torch.Tensor) -> torch.Tensor:
    """HSV (H 0..180, S/V 0..255) -> BGR(0..255)."""
    h = img[..., 0] * 2.0  # degrees
    s = img[..., 1] / 255.0
    v = img[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = (torch.floor(hp).to(torch.int64) % 6).unsqueeze(-1)

    def pick(*by_sector):
        return torch.stack(by_sector, dim=-1).gather(-1, idx)[..., 0]

    r = pick(c, x, z, z, x, c)
    g = pick(x, c, c, x, z, z)
    b = pick(z, z, x, c, c, x)
    m = v - c
    return torch.stack([b + m, g + m, r + m], dim=-1)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    # only read where t > 0.008856; the clamp keeps the unused lanes finite
    return t.clamp_min(0.0).pow(1.0 / 3.0)


def bgr2lab(img: torch.Tensor) -> torch.Tensor:
    """BGR(0..255) -> Lab in OpenCV 8-bit ranges."""
    rgb = img.flip(-1) / 255.0
    rgb = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    m = torch.tensor(_RGB2XYZ, dtype=img.dtype, device=img.device)
    xyz = rgb @ m.T
    x = xyz[..., 0] / _XN
    y = xyz[..., 1]
    z = xyz[..., 2] / _ZN

    def f(t):
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    l_ = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    a = 500.0 * (fx - fy) + 128.0
    b = 200.0 * (fy - fz) + 128.0
    return torch.stack([l_ * 255.0 / 100.0, a, b], dim=-1)


def yuv420_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """I420 uint8 (..., H * 3 / 2, W), the layout of
    `cv2.cvtColor(bgr, COLOR_BGR2YUV_I420)` (H rows of Y, then the H/2 x
    W/2 U plane, then V), to float32 BGR 0..255 (..., H, W, 3): chroma
    upsampled by nearest neighbour, OpenCV's studio-swing BT.601
    coefficients."""
    hh, w = yuv.shape[-2:]
    h = hh * 2 // 3
    lead = yuv.shape[:-2]
    flat = yuv.reshape(lead + (hh * w,)).to(torch.float32)
    q = (h // 2) * (w // 2)
    y = flat[..., :h * w].reshape(lead + (h, w))

    def chroma(plane):
        c = plane.reshape(lead + (h // 2, w // 2))
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    u = chroma(flat[..., h * w:h * w + q])
    v = chroma(flat[..., h * w + q:h * w + 2 * q])
    c = (y - 16.0) * 1.164
    d = u - 128.0
    e = v - 128.0
    r = c + 1.596 * e
    g = c - 0.813 * e - 0.391 * d
    b = c + 2.018 * d
    return torch.stack([b, g, r], dim=-1).clamp(0.0, 255.0)
