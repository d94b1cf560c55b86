"""Synthetic training figures without cv2: the part of
`video_unscreen_tpu/parallel/data_synth.py` that STM training reaches.

`_smooth_noise`, `_random_alpha` and `draw_person` draw from the
`np.random.RandomState` in exactly the order the JAX package's do; no cv2
call there consumes the generator, so one seed gives the same figures and
only the rasterization differs. The cv2 calls are replaced by numpy:

- `cv2.resize(..., INTER_CUBIC)` by `_resize_cubic` (cv2's float path:
  Keys' cubic with a = -0.75, half-pixel centres, edge pixels repeated);
- `cv2.GaussianBlur(a, (k, k), 0)` by `_gaussian_blur` (cv2's fixed
  kernels for k = 3, 5, 7 with sigma 0, borders reflected without the edge
  pixel, cv2's BORDER_REFLECT_101);
- `cv2.circle` (filled) by `_fill_circle`: the pixels within the radius,
  as cv2 fills them;
- `cv2.ellipse` (filled) and `cv2.line` (thick) by cv2's own algorithms
  (`ellipse2Poly`, `ThickLine`, `FillConvexPoly` and `Line2` of
  drawing.cpp, in 16-bit fixed point), written in Python. They give cv2's
  pixels but for a boundary pixel where a segment leaves the image (cv2
  clips it first) and for the arc of the hair cap, which cv2 fills with
  its general polygon filler and this with the convex one.
- the integer-translation `cv2.warpAffine` of `train_stm.py` by
  `translate` (an exact shift, zeros shifted in).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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


def _thick_line(img: np.ndarray, p0: Point, p1: Point, val,
                thickness: int) -> None:
    """cv2.line(img, p0, p1, val, thickness) for thickness > 1: cv2's
    `ThickLine`, a quad of half-width ceil(thickness / 2) and round caps
    of that radius."""
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
    _fill_circle(img, p0, radius, val)
    _fill_circle(img, p1, radius, val)


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
    `draw_person`, draw for draw; `hair_strands` (used only by the eval-clip
    makers, not ported) raises."""
    if hair_strands:
        raise NotImplementedError(
            "hair_strands belongs to the eval-clip makers, not ported yet "
            "(ROADMAP.md, Queue 1 item 21)")
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
