"""Synthetic figures and clips without cv2: the part of
`video_unscreen_tpu/parallel/data_synth.py` that STM training and the
evaluation reach (`draw_person`, `make_nongreen_clip`,
`render_soft_person`, `make_eval_clip` in every variant,
`make_multishot_clip`) and the matting trainer's `make_batch`.

The figures draw from the `np.random.RandomState` in exactly the order the
JAX package's do; no cv2 call there consumes the generator, so one seed
gives the same figures and only the rasterization differs. The cv2 calls
are replaced by numpy, bit-equal to the cv2 the JAX package runs with
where a test says so:

- `cv2.resize(..., INTER_CUBIC)` by `_resize_cubic` (cv2's float path:
  Keys' cubic with a = -0.75, half-pixel centres, edge pixels repeated;
  to float32 rounding);
- `cv2.resize(..., INTER_AREA)` at the integer supersample by
  `_resize_area` (its block sums in cv2's order);
- `cv2.resize(..., INTER_LINEAR)` of float32 images by `_resize_linear`
  (cv2's float path: a + f (b - a) with fused multiply-adds, x then y;
  bit-equal) and `INTER_NEAREST` by `_resize_nearest` (bit-equal);
- `cv2.GaussianBlur(a, (k, k), 0)` by `_gaussian_blur` (cv2's fixed
  kernels for k = 3, 5, 7, borders BORDER_REFLECT_101), and with a sigma
  by `_gaussian_blur_sigma`; `cv2.filter2D` with a 1 x k kernel by
  `_correlate_rows` (cv2's fused multiply-adds, its scalar tail without),
  with a k x k kernel by `_filter2d` (its nonzero taps, likewise);
- `cv2.dilate`/`cv2.erode` with the 3x3 ellipse by the port's morphology
  (`ops/morphology.py` on a CPU tensor: K2's plain version, borders
  ignored as cv2 ignores them; bit-equal);
- `cv2.circle` (filled) by `_fill_circle`: the pixels within the radius,
  as cv2 fills them;
- `cv2.ellipse` (filled), `cv2.line` and `cv2.polylines` by cv2's own
  algorithms (`ellipse2Poly`, `ThickLine`, `FillConvexPoly`, `Line2`,
  `clipLine` and `LineIterator` of drawing.cpp, in 16-bit fixed point),
  written in Python. They give cv2's pixels but for boundary pixels where
  a thick segment leaves the image and for the arc of the hair cap, which
  cv2 fills with its general polygon filler and this with the convex one.
- the integer-translation `cv2.warpAffine` of `train_stm.py` and of
  `make_batch` by `translate` (an exact shift, zeros shifted in), and the
  float one of the multi-shot clip by `_warp_translate` (cv2's float32
  bilinear);
- the JPEG round trip of the "jpeg" variant by the port's codec
  (`runtime`, bit-equal to cv2's libjpeg).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.morphology import dilate, erode

Point = Tuple[int, int]


def _resize_cubic(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """(sh, sw, C) float32 -> (h, w, C), cv2's INTER_CUBIC."""
    def taps(n_dst: int, n_src: int):
        f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
             ).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        x = f - i0.astype(np.float32)
        a = np.float32(-0.75)
        c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1
        c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        c3 = 1 - c0 - c1 - c2
        idx = np.clip(i0[:, None] + np.arange(-1, 3), 0, n_src - 1)
        return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)

    sh, sw = src.shape[:2]
    iy, cy = taps(h, sh)
    ix, cx = taps(w, sw)
    rows = np.einsum("hk,hkwc->hwc", cy, src[iy])           # (h, sw, C)
    return np.einsum("wk,hwkc->hwc", cx, rows[:, ix]).astype(np.float32)


def _smooth_noise(rng, h, w, scale=8):
    small = rng.rand(max(h // scale, 1), max(w // scale, 1), 3)
    return _resize_cubic(small.astype(np.float32), h, w).clip(0, 1)


# cv2's fixed Gaussian kernels for an odd size <= 7 and sigma 0
_SMALL_GAUSSIAN = {
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def _gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) of a 2-D float32 image."""
    kern = np.asarray(_SMALL_GAUSSIAN[k], np.float32)
    r = k // 2
    out = img.astype(np.float32)
    for axis in (1, 0):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(kern[i] * np.take(p, np.arange(i, i + n), axis=axis)
                  for i in range(k)).astype(np.float32)
    return out


def _resize_area(src: np.ndarray, ss: int) -> np.ndarray:
    """cv2.resize(src, (w // ss, h // ss), interpolation=INTER_AREA) of a
    float32 (h, w[, C]) image, h and w multiples of `ss`: cv2's integer
    area path, each output the float32 sum of its ss x ss block taken row
    by row in groups of four (its unrolled loop), times 1 / ss^2."""
    h, w = src.shape[:2]
    blocks = src.astype(np.float32).reshape(h // ss, ss, w // ss, ss,
                                            *src.shape[2:])
    terms = [blocks[:, i, :, j] for i in range(ss) for j in range(ss)]
    total = np.zeros_like(terms[0])
    for k in range(0, len(terms) - 3, 4):
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
    for t in terms[len(terms) - len(terms) % 4:]:
        total = total + t
    return (total * np.float32(1.0 / (ss * ss))).astype(np.float32)


def _fma32(a, b, c):
    """float32 fused multiply-add, a * b + c rounded once (the product of
    two float32 is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of a row of n padded by r each side, cv2's
    BORDER_REFLECT_101."""
    return _pad_index(n, r, r)


# cv2's SIMD width in float32 lanes (AVX2): the elements of a row past the
# last whole vector are summed by its scalar loop, without fused
# multiply-adds
_LANES = 8


def _correlate_rows(img: np.ndarray, kern: np.ndarray,
                    symmetric: bool = False,
                    tail_axis: int = 1) -> np.ndarray:
    """Correlation of each row of an (h, w[, C]) float32 image with a 1-D
    kernel centred on its middle tap, BORDER_REFLECT_101, in float32 as
    the cv2 the JAX package runs with sums it: tap by tap from the first
    (cv2.filter2D, and sepFilter2D's row pass), or, `symmetric`, the
    centre tap's product first and then each pair of mirrored pixels,
    added in float32, times its tap (sepFilter2D's column pass with a
    symmetric kernel). Its vector loop fuses each multiply-add; the
    elements past the last whole vector of `_LANES` along `tail_axis` (a
    row's w x C values, or, for a column pass run on the transpose, its
    columns) take its scalar loop, which does not."""
    r = len(kern) // 2
    src = img.astype(np.float32)[:, _reflect101(img.shape[1], r)]
    w = img.shape[1]
    kern = np.asarray(kern, np.float32)
    if symmetric:
        taps = [(kern[r + i], src[:, r - i:r - i + w]
                 + src[:, r + i:r + i + w]) for i in range(1, r + 1)]
        first = kern[r] * src[:, r:r + w]
    else:
        taps = [(kern[i], src[:, i:i + w]) for i in range(1, len(kern))]
        first = kern[0] * src[:, 0:w]
    fused, plain = first, first
    for k, x in taps:
        fused = _fma32(k, x, fused)
        plain = plain + k * x
    return np.where(_scalar_tail(img.shape, tail_axis), plain, fused)


def _scalar_tail(shape, tail_axis: int = 1) -> np.ndarray:
    """Where cv2's scalar loop takes over from its vectors of `_LANES`: the
    elements past the last whole vector of a row's w x C values
    (`tail_axis` 1), or of the columns (0, a column pass run on the
    transpose); broadcastable to `shape`."""
    n = shape[tail_axis] * (int(np.prod(shape[2:])) if tail_axis == 1
                            else 1)
    tail = np.zeros(n, bool)
    tail[n // _LANES * _LANES:] = True
    if tail_axis == 1:
        return tail.reshape((1,) + tuple(shape[1:]))
    return tail.reshape((-1,) + (1,) * (len(shape) - 1))


def _filter2d(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kern) of an (h, w[, C]) float32 image with a
    float32 k x k kernel, anchor at (k // 2, k // 2) (an even k too),
    BORDER_REFLECT_101: cv2's direct sum over the kernel's nonzero taps in
    row-major order, the vector loop fusing each multiply-add and the
    scalar tail not (`_correlate_rows`). Bit-equal to the cv2 the JAX
    package runs with for k <= 11; from k = 12 (144 taps) cv2 sums by DFT,
    which this differs from by float32 rounding (~2e-7)."""
    k = kern.shape[0]
    a = k // 2
    h, w = img.shape[:2]
    ys = _pad_index(h, a, k - 1 - a)
    xs = _pad_index(w, a, k - 1 - a)
    src = img.astype(np.float32)[ys][:, xs]
    taps = [(kern[y, x], src[y:y + h, x:x + w])
            for y, x in zip(*np.nonzero(kern))]
    first = taps[0][0] * taps[0][1]
    fused, plain = first, first
    for c, x in taps[1:]:
        fused = _fma32(c, x, fused)
        plain = plain + c * x
    return np.where(_scalar_tail(img.shape), plain, fused)


def _pad_index(n: int, before: int, after: int) -> np.ndarray:
    """Source indices of a row of n padded by `before` and `after`,
    BORDER_REFLECT_101."""
    i = np.abs(np.arange(-before, n + after))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _linear_taps(n_dst: int, n_src: int):
    """(i0, i1, f) of cv2's float INTER_LINEAR along one axis: the source
    coordinate (d + 0.5) / (n_dst / n_src) - 0.5 in float64, i0 its floor
    and f = s - i0 rounded to float32, both clamped to the edge pixels."""
    s = (np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
    i0 = np.floor(s).astype(np.int64)
    f = (s - i0).astype(np.float32)
    f[(i0 < 0) | (i0 >= n_src - 1)] = 0.0
    i0 = np.clip(i0, 0, n_src - 1)
    return i0, np.minimum(i0 + 1, n_src - 1), f


def _resize_linear(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(src, (w, h)) (INTER_LINEAR) of an (sh, sw[, C]) float32
    image, bit-equal to the cv2 the JAX package runs with: along x, then
    along y, each output a + f (b - a) as a fused multiply-add."""
    x0, x1, fx = _linear_taps(w, src.shape[1])
    y0, y1, fy = _linear_taps(h, src.shape[0])
    extra = (None,) * (src.ndim - 2)
    fx = fx[(None, slice(None)) + extra]
    fy = fy[(slice(None), None) + extra]
    s = src.astype(np.float32)
    rows = _fma32(fx, s[:, x1] - s[:, x0], s[:, x0])
    return _fma32(fy, rows[y1] - rows[y0], rows[y0])


def _resize_nearest(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_NEAREST): the source
    index floor(d * (1 / (n_dst / n_src))) in float64, as cv2 computes it
    (an exact floor(d * n_src / n_dst) differs on some sizes)."""
    def index(n_dst, n_src):
        return np.minimum(np.floor(np.arange(n_dst) * (
            1.0 / (n_dst / n_src))).astype(np.int64), n_src - 1)

    return src[index(h, src.shape[0])][:, index(w, src.shape[1])]


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) for sigma > 0: the taps
    in float64, normalized, then cast to float32."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def _gaussian_blur_sigma(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a 2-D float32 image: the
    kernel size cv2 picks for float32 (round(8 sigma + 1), made odd),
    rows, then columns with the kernel's symmetry, BORDER_REFLECT_101."""
    ksize = int(np.rint(sigma * 4 * 2 + 1)) | 1
    kern = _gaussian_kernel(ksize, sigma)
    rows = _correlate_rows(img, kern)
    return _correlate_rows(rows.T, kern, symmetric=True,
                           tail_axis=0).T.copy()


def _warp_translate(src: np.ndarray, tx: float, ty: float) -> np.ndarray:
    """cv2.warpAffine(src, [[1, 0, tx], [0, 1, ty]], (w, h)) of a 2-D
    float32 image, INTER_LINEAR, zero outside, as the cv2 the JAX package
    runs with computes it for float images: each source coordinate x - tx
    in float32 (the inverse matrix cast to float32), its fraction f = s -
    floor(s), and two lerps a + f (b - a) as fused multiply-adds, along x
    and then along y (bit-equal to it; OpenCV 4's 1/32-pixel table is not
    used for float32 here)."""
    h, w = src.shape
    inv_t = (np.float32(-tx), np.float32(-ty))
    sx = np.arange(w, dtype=np.float32) + inv_t[0]
    sy = np.arange(h, dtype=np.float32) + inv_t[1]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx = (sx - x0.astype(np.float32))[None, :]
    fy = (sy - y0.astype(np.float32))[:, None]
    pad = np.zeros((h + 2, w + 2), np.float32)   # one ring of zeros
    pad[1:-1, 1:-1] = src

    def tap(dy, dx):
        return pad[np.clip(y0 + dy + 1, 0, h + 1)[:, None],
                   np.clip(x0 + dx + 1, 0, w + 1)[None, :]]

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma32(fx, v01 - v00, v00)
    bottom = _fma32(fx, v11 - v10, v10)
    return _fma32(fy, bottom - top, top)


def _jpeg_roundtrip(frame: np.ndarray, quality: int) -> np.ndarray:
    """cv2.imdecode(cv2.imencode(".jpg", frame, quality)) through the
    port's codec (bit-equal to cv2's libjpeg)."""
    import os.path as osp
    import tempfile

    from .. import runtime
    with tempfile.TemporaryDirectory() as tmp:
        path = osp.join(tmp, "frame.jpg")
        runtime.encode_batch([path], frame[None], quality=quality, threads=1)
        return runtime.decode_batch([path], threads=1)[0]


# -- rasterization: cv2's drawing.cpp, in 16-bit fixed point --------------
_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _put(img: np.ndarray, pts, val) -> None:
    h, w = img.shape[:2]
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = val


def _clip_line(w: int, h: int, p1: Point, p2: Point):
    """cv2's `clipLine` to a w x h image: (p1, p2) clipped, or None when
    the segment misses it."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else ((x1, y1), (x2, y2))


def _line_fixed(img: np.ndarray, p1, p2, val) -> None:
    """cv2's `Line2`: an 8-connected segment between fixed-point ends."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if x_major:
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        x_step, y_step = _ONE, _cdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        x_step, y_step = _cdiv(dx << _SHIFT, abs(dy) | 1), _ONE
        count = (y2 - y1) >> _SHIFT
    pts = [((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)]
    x1, y1 = x1 + _HALF, y1 + _HALF
    if x_major:
        x1 >>= _SHIFT
        pts += [(x1 + n, (y1 + n * y_step) >> _SHIFT)
                for n in range(count + 1)]
    else:
        y1 >>= _SHIFT
        pts += [((x1 + n * x_step) >> _SHIFT, y1 + n)
                for n in range(count + 1)]
    _put(img, pts, val)


def _fill_convex(img: np.ndarray, v, val) -> None:
    """cv2's `FillConvexPoly` of fixed-point vertices `v`: the outline,
    then each row from the two edge walkers' x, rounded."""
    h, w = img.shape[:2]
    n = len(v)
    p0, imin = v[-1], 0
    for i, p in enumerate(v):
        if p[1] < v[imin][1]:
            imin = i
        _line_fixed(img, p0, p, val)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    xmin, xmax = (min(xs) + _HALF) >> _SHIFT, (max(xs) + _HALF) >> _SHIFT
    ymin, ymax = (min(ys) + _HALF) >> _SHIFT, (max(ys) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{"idx": imin, "di": 1, "x": -_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": n - 1, "x": -_ONE, "dx": 0, "ye": ymin}]
    left = n
    y = ymin
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                more = left > 0
                left -= 1
                if not more:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    e.update(ye=ty, x=v[idx0][0], idx=idx, dx=_cdiv(
                        (v[idx][0] - v[idx0][0]) * 2 + (ty - y),
                        2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if left < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0]["x"], edges[1]["x"]))
            x0, x1 = (a + _HALF) >> _SHIFT, (b + _HALF) >> _SHIFT
            if x1 >= 0 and x0 < w:
                img[y, max(x0, 0):min(x1, w - 1) + 1] = val
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _fill_circle(img: np.ndarray, center: Point, radius: int, val) -> None:
    """cv2.circle(img, center, radius, val, -1): the pixels within the
    radius."""
    h, w = img.shape[:2]
    yy, xx = np.ogrid[:h, :w]
    inside = (xx - center[0]) ** 2 + (yy - center[1]) ** 2 <= radius ** 2
    img[inside] = val


def _sin_deg(deg: int) -> float:
    """cv2's sine table: sin of whole degrees to 7 decimals, as float."""
    return float(np.float32(round(float(np.sin(np.deg2rad(deg))), 7)))


def _ellipse_poly(center: Point, axes: Point, angle: int, start: int,
                  end: int):
    """cv2's `ellipse2Poly` vertices, in fixed point (its step in degrees
    by size)."""
    cx, cy = center[0] << _SHIFT, center[1] << _SHIFT
    ax, ay = abs(axes[0]) << _SHIFT, abs(axes[1]) << _SHIFT
    size = (max(ax, ay) + _HALF) >> _SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    angle %= 360
    alpha, beta = _sin_deg(450 - angle), _sin_deg(angle)
    pts = []
    for i in range(start, end + delta, delta):
        a = min(i, end)
        x, y = ax * _sin_deg(450 - a), ay * _sin_deg(a)
        pt = (int(np.rint(cx + x * alpha - y * beta)),
              int(np.rint(cy + x * beta + y * alpha)))
        if not pts or pts[-1] != pt:
            pts.append(pt)
    return pts


def _fill_ellipse(img: np.ndarray, center: Point, axes: Point, angle: int,
                  start: int, end: int, val) -> None:
    """cv2.ellipse(img, center, axes, angle, start, end, val, -1). cv2
    fills an arc (with its centre) by its general polygon filler; this
    fills the same convex polygon by `_fill_convex`, which can differ from
    it by a boundary pixel."""
    pts = _ellipse_poly(center, axes, angle, start, end)
    if end - start < 360:
        pts.append((center[0] << _SHIFT, center[1] << _SHIFT))
    _fill_convex(img, pts, val)


def _line8(img: np.ndarray, p1: Point, p2: Point, val) -> None:
    """cv2.line(img, p1, p2, val) at thickness 1 (`Line`, LINE_8): the
    segment clipped to the image, then `LineIterator`'s Bresenham walk
    from its left end."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - (dy + dy), x1, y1
    pts = []
    for _ in range(dx + 1):
        pts.append((x, y))
        step = err < 0
        err += -(dy + dy) + ((dx + dx) if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0
    _put(img, pts, val)


def _thick_line(img: np.ndarray, p0: Point, p1: Point, val,
                thickness: int, caps=(True, True)) -> None:
    """cv2's `ThickLine` (integer ends): for thickness > 1 a quad of
    half-width ceil(thickness / 2) and, where `caps` says, round caps of
    that radius (cv2.line caps both ends; cv2.polylines the first
    segment's both and each later one's end); for thickness 1 `_line8`."""
    if thickness <= 1:
        _line8(img, p0, p1, val)
        return
    x0, y0 = p0[0] << _SHIFT, p0[1] << _SHIFT
    x1, y1 = p1[0] << _SHIFT, p1[1] << _SHIFT
    dx, dy = (x0 - x1) / _ONE, (y1 - y0) / _ONE
    r2 = dx * dx + dy * dy
    half = thickness << (_SHIFT - 1)
    if r2 > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * _ONE * 0.5) / np.sqrt(r2)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(x0 + ex, y0 + ey), (x0 - ex, y0 - ey),
                           (x1 - ex, y1 - ey), (x1 + ex, y1 + ey)], val)
    radius = (half + _HALF) >> _SHIFT
    for end, cap in zip((p0, p1), caps):
        if cap:
            _fill_circle(img, end, radius, val)


def _polyline(img: np.ndarray, pts, val, thickness: int) -> None:
    """cv2.polylines(img, [pts], False, val, thickness): `ThickLine` along
    each segment, the first with both caps, later ones with their end's."""
    for i in range(1, len(pts)):
        _thick_line(img, tuple(pts[i - 1]), tuple(pts[i]), val, thickness,
                    (i == 1, True))


def translate(img: np.ndarray, tx: int, ty: int) -> np.ndarray:
    """out[y, x] = img[y - ty, x - tx], 0 where that is outside: the
    integer-translation `cv2.warpAffine` of the clip maker."""
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    ys, yd = slice(max(-ty, 0), min(h, h - ty)), slice(max(ty, 0),
                                                       min(h, h + ty))
    xs, xd = slice(max(-tx, 0), min(w, w - tx)), slice(max(tx, 0),
                                                       min(w, w + tx))
    out[yd, xd] = img[ys, xs]
    return out


# -- the figures -----------------------------------------------------------
def _random_alpha(rng, h, w):
    """Union of random ellipses, gaussian-soft edges."""
    alpha = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(1, 4)):
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(
            w // 4, 3 * w // 4)
        ay, ax = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
        ang = rng.randint(0, 180)
        _fill_ellipse(alpha, (cx, cy), (ax, ay), ang, 0, 360, 1.0)
    k = rng.choice([3, 5, 7])
    return _gaussian_blur(alpha, k).clip(0, 1)


# LIP part classes of the synthetic person (as the JAX package's)
LIP_HAIR, LIP_UPPER, LIP_PANTS, LIP_FACE = 2, 5, 9, 13
LIP_ARM_L, LIP_ARM_R, LIP_LEG_L, LIP_LEG_R = 14, 15, 16, 17
LIP_SHOE_L, LIP_SHOE_R = 18, 19


def draw_person(rng: np.random.RandomState, h: int, w: int,
                scale: float = None, phase: float = None,
                cx_frac: float = None, hair_strands: bool = False,
                avoid_green: bool = False):
    """Articulated person-shaped figure with LIP part labels: (img (h, w, 3)
    float32 BGR 0..1, parts (h, w) int32 LIP classes). The JAX package's
    `draw_person`, draw for draw; `hair_strands` adds the thin polyline
    wisps off the hair cap that the eval-clip makers render (soft
    sub-pixel boundaries once downsampled)."""
    parts = np.zeros((h, w), np.int32)
    s = (scale if scale is not None
         else rng.uniform(0.35, 0.9)) * h  # body height in px
    cx = (cx_frac if cx_frac is not None
          else rng.uniform(0.25, 0.75)) * w
    y0 = rng.uniform(0.02, max(0.04, 0.95 - s / h)) * h
    lean = rng.uniform(-0.08, 0.08)  # whole-body lean
    swing = 0.0 if phase is None else float(np.sin(phase))

    def pt(dx, dy):
        """Body-frame point: dx in body widths, dy in body heights."""
        return (int(cx + (dx + lean * dy) * s), int(y0 + dy * s))

    th = max(int(0.055 * s), 2)  # limb thickness
    hip_y, knee_y, foot_y = 0.55, 0.78, 0.97
    spread = rng.uniform(0.04, 0.12)
    for side, leg_cls, shoe_cls in ((-1, LIP_LEG_L, LIP_SHOE_L),
                                    (1, LIP_LEG_R, LIP_SHOE_R)):
        sp = side * spread + 0.08 * swing * side
        hip = pt(side * 0.05, hip_y)
        knee = pt(sp, knee_y)
        foot = pt(sp * rng.uniform(0.9, 1.6), foot_y)
        _thick_line(parts, hip, knee, LIP_PANTS, th)       # thigh = pants
        _thick_line(parts, knee, foot, int(leg_cls), th)   # lower leg
        _fill_ellipse(parts, foot, (max(int(0.06 * s), 2),
                                    max(int(0.03 * s), 1)),
                      0, 0, 360, int(shoe_cls))
    # torso (upper clothes) over the hip area
    _fill_ellipse(parts, pt(0, 0.38), (max(int(0.14 * s), 3),
                                       max(int(0.19 * s), 4)),
                  int(lean * 60), 0, 360, LIP_UPPER)
    # arms from the shoulders: walking counter-swing or random pose
    for side, arm_cls in ((-1, LIP_ARM_L), (1, LIP_ARM_R)):
        sw = -0.06 * swing * side
        sh = pt(side * 0.12, 0.24)
        elbow = pt(side * rng.uniform(0.14, 0.24) + sw, 0.38)
        hand = pt(side * rng.uniform(0.08, 0.3) + 2 * sw,
                  rng.uniform(0.46, 0.56))
        _thick_line(parts, sh, elbow, int(arm_cls), max(int(0.04 * s), 2))
        _thick_line(parts, elbow, hand, int(arm_cls), max(int(0.04 * s), 2))
    # head: face circle with a hair cap
    head_c = pt(rng.uniform(-0.02, 0.02), 0.10)
    hr = max(int(0.085 * s), 3)
    _fill_circle(parts, head_c, hr, LIP_FACE)
    _fill_ellipse(parts, (head_c[0], head_c[1] - int(0.35 * hr)),
                  (int(1.05 * hr), hr), 0, 180, 360, LIP_HAIR)
    if hair_strands:
        # thin wisps off the cap
        for _ in range(rng.randint(10, 22)):
            ang = rng.uniform(-2.6, -0.5)  # upward-ish fan
            x0 = head_c[0] + int(np.cos(ang) * hr * 0.9)
            y0s = head_c[1] + int(np.sin(ang) * hr * 0.9)
            pts = [(x0, y0s)]
            vx, vy = np.cos(ang), np.sin(ang)
            for _seg in range(3):
                vx += rng.uniform(-0.4, 0.4)
                vy += rng.uniform(-0.2, 0.4)  # droop
                step = rng.uniform(0.2, 0.55) * hr
                pts.append((int(pts[-1][0] + vx * step),
                            int(pts[-1][1] + vy * step)))
            _polyline(parts, pts, LIP_HAIR, max(int(0.012 * s), 1))

    # paint: per-part base color x smooth texture
    img = np.zeros((h, w, 3), np.float32)
    skin = rng.uniform(0.35, 0.85, 3).astype(np.float32)
    colors = {
        LIP_HAIR: rng.uniform(0.02, 0.35, 3),
        LIP_FACE: skin, LIP_ARM_L: skin, LIP_ARM_R: skin,
        LIP_UPPER: rng.uniform(0.05, 0.95, 3),
        LIP_PANTS: rng.uniform(0.05, 0.8, 3),
        LIP_LEG_L: None, LIP_LEG_R: None,   # pants color or skin
        LIP_SHOE_L: rng.uniform(0.02, 0.5, 3),
        LIP_SHOE_R: None,
    }
    colors[LIP_SHOE_R] = colors[LIP_SHOE_L]
    if avoid_green:  # green-screen clips: clothing must not key out
        for cls in (LIP_UPPER, LIP_PANTS):
            c = np.asarray(colors[cls], np.float32)
            if c[1] >= c.max() - 0.05:  # BGR: green-dominant
                c[1] = c.min() * 0.8
            colors[cls] = c
    leg = skin if rng.rand() < 0.5 else colors[LIP_PANTS]
    colors[LIP_LEG_L] = colors[LIP_LEG_R] = leg
    tex = 0.85 + 0.3 * _smooth_noise(rng, h, w, 8)
    for cls, col in colors.items():
        sel = parts == cls
        img[sel] = np.asarray(col, np.float32)
    img = (img * tex).clip(0, 1)
    return img, parts


def make_nongreen_clip(n=5, h=96, w=128, seed=0, person_scale=0.7,
                       walk=False):
    """Synthetic non-green clip: a person (walking, with `walk`, a phase a
    frame) over a textured, gradient-lit natural background, moved 2 px a
    frame. Returns (frames uint8 BGR list, GT alphas uint8 list, part
    maps list)."""
    rng = np.random.RandomState(seed)
    bg = (_smooth_noise(rng, h, w, scale=max(h // 6, 1)) * 0.85
          + _smooth_noise(rng, h, w, scale=max(h // 24, 1)) * 0.15)
    gy = np.linspace(0.75, 1.15, h, dtype=np.float32)[:, None, None]
    bg = (bg * gy).clip(0, 1)
    frames, gts, parts_list = [], [], []
    state = rng.get_state()
    for t in range(n):
        rng.set_state(state)  # the same person each frame...
        phase = (2.0 * np.pi * t / 8.0) if walk else None
        person, parts = draw_person(rng, h, w, scale=person_scale,
                                    phase=phase)
        shift = int(round(2.0 * t))  # ...moved across the frames
        person = np.roll(person, shift, axis=1)
        parts = np.roll(parts, shift, axis=1)
        alpha = (parts > 0).astype(np.float32)
        img = alpha[..., None] * person + (1 - alpha[..., None]) * bg
        img = img + np.random.RandomState(seed + 100 + t).randn(
            h, w, 3).astype(np.float32) * 0.015
        frames.append((img.clip(0, 1) * 255).astype(np.uint8))
        gts.append((alpha * 255).astype(np.uint8))
        parts_list.append(parts)
    return frames, gts, parts_list


def render_soft_person(rng: np.random.RandomState, h: int, w: int,
                       ss: int = 4, **kw):
    """A person drawn at `ss` times the size, with hair wisps, and
    area-downsampled: the hard part labels become a soft alpha with
    sub-pixel boundaries. Returns (img (h, w, 3), alpha (h, w)) float32."""
    img_hi, parts_hi = draw_person(rng, h * ss, w * ss,
                                   hair_strands=True, **kw)
    alpha_hi = (parts_hi > 0).astype(np.float32)
    return _resize_area(img_hi, ss), _resize_area(alpha_hi, ss)


EVAL_VARIANTS = ("plain", "motion_blur", "shadow", "jpeg", "occluder",
                 "two_person")


def make_eval_clip(kind: str = "green", n: int = 12, h: int = 288,
                   w: int = 512, seed: int = 0, ss: int = 4,
                   variant: str = "plain"):
    """Evaluation clip: a walking person with soft hair-wisp boundaries
    over a gradient-lit green screen ("green") or a textured natural
    background ("natural"). `variant` adds a degradation of real footage:
    "motion_blur" (the person layer blurred along its displacement),
    "shadow" (a soft offset shadow on the background), "jpeg" (the
    composite through JPEG at quality 40-60), "occluder" (a static pillar
    in front, cut out of the GT) or "two_person" (a second, smaller
    walker behind, in counter-phase; the GT is the union). Returns (frames
    uint8 BGR list, GT soft alphas uint8 list)."""
    if variant not in EVAL_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {EVAL_VARIANTS}")
    rng = np.random.RandomState(seed)
    gy = np.linspace(rng.uniform(0.75, 0.95), rng.uniform(1.0, 1.2), h,
                     dtype=np.float32)[:, None, None]
    if kind == "green":
        bg = np.zeros((h, w, 3), np.float32)
        bg[...] = (rng.uniform(0.1, 0.3), rng.uniform(0.55, 0.8),
                   rng.uniform(0.15, 0.35))
        bg += _smooth_noise(rng, h, w, 16) * 0.08
    else:
        # two octaves: coarse structure and mild fine detail
        bg = (_smooth_noise(rng, h, w, scale=max(h // 6, 1)) * 0.85
              + _smooth_noise(rng, h, w, scale=max(h // 24, 1)) * 0.15)
    bg = (bg * gy).clip(0, 1)
    scale = rng.uniform(0.55, 0.8)
    state = rng.get_state()

    if variant == "occluder":
        # a static pillar in the walker's path, never green
        px0 = int(w * rng.uniform(0.45, 0.55))
        pw = int(w * rng.uniform(0.05, 0.09))
        pillar_mask = np.zeros((h, w), np.float32)
        pillar_mask[:, px0:px0 + pw] = 1.0
        pillar_color = np.array([rng.uniform(0.3, 0.6),
                                 rng.uniform(0.1, 0.25),
                                 rng.uniform(0.3, 0.6)], np.float32)
        pillar = (pillar_color[None, None]
                  * (0.8 + 0.4 * _smooth_noise(rng, h, w, 12)))
    if variant == "two_person":
        scale2 = scale * rng.uniform(0.55, 0.75)
        seed2 = rng.randint(1 << 31)
    jpeg_q = int(rng.uniform(40, 60))

    frames, gts = [], []
    prev_cx = None
    for t in range(n):
        rng.set_state(state)  # the same body, another pose and place
        cxf = 0.32 + 0.36 * t / max(n - 1, 1)
        img, alpha = render_soft_person(rng, h, w, ss=ss, scale=scale,
                                        phase=2.0 * np.pi * t / 8.0,
                                        cx_frac=cxf,
                                        avoid_green=(kind == "green"))
        if variant == "motion_blur":
            # a box blur along the displacement since the last frame
            dx = 0 if prev_cx is None else int(round((cxf - prev_cx) * w))
            ksz = min(max(abs(dx), 1), max(w // 40, 3)) * 2 + 1
            kern = np.full(ksz, 1.0 / ksz, np.float32)
            img = _correlate_rows(img, kern)
            alpha = _correlate_rows(alpha, kern)
            prev_cx = cxf
        if variant == "two_person":
            rng2 = np.random.RandomState(seed2)
            cxf2 = 0.72 - 0.3 * t / max(n - 1, 1)  # walks the other way
            img2, alpha2 = render_soft_person(
                rng2, h, w, ss=ss, scale=scale2,
                phase=np.pi + 2.0 * np.pi * t / 8.0, cx_frac=cxf2,
                avoid_green=(kind == "green"))
            # person 1 in front of person 2
            img = (alpha[..., None] * img
                   + (1 - alpha[..., None]) * alpha2[..., None] * img2)
            alpha = np.maximum(alpha, alpha2)
        comp_bg = bg
        if variant == "shadow":
            sh = np.roll(alpha, (int(0.04 * h), int(0.06 * w)), (0, 1))
            sh = _gaussian_blur_sigma(sh, max(h / 72.0, 1.0))
            comp_bg = bg * (1.0 - 0.45 * sh[..., None])
        comp = alpha[..., None] * img + (1 - alpha[..., None]) * comp_bg
        if variant == "occluder":
            comp = (pillar_mask[..., None] * pillar
                    + (1 - pillar_mask[..., None]) * comp)
            alpha = alpha * (1.0 - pillar_mask)
        comp = comp + np.random.RandomState(seed + 500 + t).randn(
            h, w, 3).astype(np.float32) * 0.01
        frame = (comp.clip(0, 1) * 255).astype(np.uint8)
        if variant == "jpeg":
            frame = _jpeg_roundtrip(frame, jpeg_q)
        frames.append(frame)
        gts.append((alpha * 255).astype(np.uint8))
    return frames, gts


def make_multishot_clip(n_shots: int = 2, frames_per_shot: int = 8,
                        h: int = 128, w: int = 128, seed: int = 5):
    """Multi-shot clip for the STM propagation and ISeg correction
    protocol: in each shot a flat-colour ellipse drifts over its own
    textured background, and a hard cut (a new background, subject and
    place) separates the shots. Returns (frames uint8 BGR, GT masks uint8
    {0, 255}, the indices where a shot after the first begins)."""
    frames, masks, cuts = [], [], []
    for s in range(n_shots):
        rng = np.random.RandomState(seed + 37 * s)
        small = rng.rand(16, 16, 3).astype(np.float32)
        bg = _resize_cubic(small, h, w).clip(0, 1)
        fg_color = rng.uniform(0.2, 0.8, 3).astype(np.float32)
        cx = int(rng.uniform(0.25, 0.75) * w)
        cy = int(rng.uniform(0.35, 0.65) * h)
        ax = int(rng.uniform(0.12, 0.2) * w)
        ay = int(rng.uniform(0.18, 0.28) * h)
        ang = rng.uniform(0, 180)
        vx, vy = rng.uniform(1.5, 3.5), rng.uniform(0.5, 2.0)
        base = np.zeros((h, w), np.float32)
        # cv2.ellipse rounds its angle to whole degrees
        _fill_ellipse(base, (cx, cy), (ax, ay), int(np.rint(ang)), 0, 360,
                      1.0)
        if s > 0:
            cuts.append(len(frames))
        for t in range(frames_per_shot):
            alpha = _warp_translate(base, float(np.float32(vx * t)),
                                    float(np.float32(vy * t)))
            img = (alpha[..., None] * fg_color
                   + (1 - alpha[..., None]) * bg)
            img += rng.randn(h, w, 3).astype(np.float32) * 0.02
            frames.append((img.clip(0, 1) * 255).astype(np.uint8))
            masks.append((alpha > 0.5).astype(np.uint8) * 255)
    return frames, masks, cuts


def _motion_blur_kernel(blur_len: int, ang: float) -> np.ndarray:
    """The matting batch's directional line kernel: one tap a column on
    the line through the centre at angle `ang`, normalized."""
    kern = np.zeros((blur_len, blur_len), np.float32)
    c = (blur_len - 1) / 2.0
    for i in range(blur_len):
        y = int(round(c + (i - c) * np.tan(ang)))
        if 0 <= y < blur_len:
            kern[y, i] = 1.0
    kern /= max(kern.sum(), 1.0)
    return kern


def make_batch(rng: np.random.RandomState, batch: int,
               hw: Tuple[int, int] = (128, 128),
               imagenet_norm: bool = True) -> Dict[str, np.ndarray]:
    """The MattingUNet's training batch, the JAX package's `make_batch`
    draw for draw: a person (soft or hard-edged) or a blob over a green,
    textured or noise background, 30% motion-blurred with its alpha, the
    GT trimap from a 3x3-ellipse dilate/erode band (wider when blurred),
    the previous alpha a shifted GT (or 0 for a clip's first frame).
    Returns NHWC numpy: {"img": (B, h, w, 3) RGB (ImageNet-normalized),
    "alpha_pre": (B, h, w, 1), "trimap": (B, h, w, 3) one-hot (0 bg, 1
    unknown, 2 fg), "alpha_gt": (B, h, w)}."""
    h, w = hw
    imgs, alpha_pres, trimaps, gts = [], [], [], []
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for _ in range(batch):
        r_bg = rng.rand()
        if r_bg < 0.3:
            bg = np.zeros((h, w, 3), np.float32)
            bg[...] = (rng.uniform(0.05, 0.35), rng.uniform(0.5, 0.9),
                       rng.uniform(0.1, 0.4))
            bg += _smooth_noise(rng, h, w, 16) * 0.1
        elif r_bg < 0.7:
            coarse = max(h // rng.choice([4, 6, 8]), 1)
            bg = (_smooth_noise(rng, h, w, scale=coarse) * 0.85
                  + _smooth_noise(rng, h, w, scale=max(h // 24, 1)) * 0.15)
            gy = np.linspace(rng.uniform(0.6, 1.0), rng.uniform(0.9, 1.3),
                             h, dtype=np.float32)[:, None, None]
            bg = (bg * gy).clip(0, 1)
        else:
            bg = _smooth_noise(rng, h, w)
        r_fg = rng.rand()
        if r_fg < 0.35:
            fg, alpha = render_soft_person(rng, h, w, ss=2)
        elif r_fg < 0.65:
            fg, parts = draw_person(rng, h, w)
            alpha = (parts > 0).astype(np.float32)
        else:
            fg = _smooth_noise(rng, h, w, scale=4)
            alpha = _random_alpha(rng, h, w)
        blur_len = 0
        if rng.rand() < 0.3:
            blur_len = int(rng.uniform(3, max(w // 12, 6)))
            kern = _motion_blur_kernel(blur_len, rng.uniform(-0.35, 0.35))
            fg = _filter2d(fg, kern)
            alpha = _filter2d(alpha, kern)

        img = alpha[..., None] * fg + (1 - alpha[..., None]) * bg
        img += rng.randn(h, w, 3).astype(np.float32) * 0.02
        img = img.clip(0, 1)

        hard = torch.from_numpy((alpha > 0.5).astype(np.float32))
        iters = rng.randint(2, 6) + blur_len // 2
        dil = dilate(hard, 3, iters).numpy()
        ero = erode(hard, 3, iters).numpy()
        tri_cls = np.ones((h, w), np.int32)  # unknown
        tri_cls[ero > 0] = 2
        tri_cls[dil == 0] = 0
        trimap = np.eye(3, dtype=np.float32)[tri_cls]

        shift = rng.randint(-3, 4, size=2)
        alpha_pre = translate(alpha, int(shift[1]), int(shift[0]))
        if rng.rand() < 0.2:
            alpha_pre = np.zeros_like(alpha)

        rgb = img[..., ::-1]
        if imagenet_norm:
            rgb = (rgb - mean) / std
        imgs.append(rgb)
        alpha_pres.append(alpha_pre[..., None])
        trimaps.append(trimap)
        gts.append(alpha)
    return {"img": np.stack(imgs), "alpha_pre": np.stack(alpha_pres),
            "trimap": np.stack(trimaps), "alpha_gt": np.stack(gts)}
