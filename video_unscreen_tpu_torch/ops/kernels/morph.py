"""K1 (fused trimap) and K2 (iterated dilate/erode): wrappers and plain
versions.

Replaces the Pallas TPU kernels `video_unscreen_tpu/ops/pallas/morph.py`
(`_trimap_kernel`, `_morph_kernel`); the CUDA source is `csrc/morph.cu`.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(the shifted max/min chain of `ops/morphology.py:_morph` in the JAX
package), a CUDA tensor launches the kernel or raises. `offsets` are the
(dy, dx) cells of the structuring element relative to its anchor, so that
out[y, x] = max (or min) of x[y + dy, x + dx]; outside the image counts as
-inf (dilate) or +inf (erode).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build

Offsets = Sequence[Tuple[int, int]]


class LaunchCount:
    """Calls of a wrapper that ran its kernel, and the device kernel
    launches those calls made, as the C entry reports them (a long morph
    chain takes several launches, a flood call seven). Plain-version calls
    are not counted."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.launches = 0

    def add(self, launches: ctypes.c_int) -> None:
        self.calls += 1
        self.launches += launches.value


TRIMAP = LaunchCount("trimap")
MORPH = LaunchCount("morph")


# -- plain versions ------------------------------------------------------------
def _shift2d(img: torch.Tensor, dy: int, dx: int,
             fill: float) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx] inside the image, else `fill`."""
    h, w = img.shape
    out = torch.full_like(img, fill)
    y0, y1 = max(-dy, 0), min(h, h - dy)
    x0, x1 = max(-dx, 0), min(w, w - dx)
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = img[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def morph_plain(x: torch.Tensor, offsets: Offsets, iters: int,
                is_dilate: bool) -> torch.Tensor:
    """Iterated dilate/erode as a chain of shifted max/min."""
    fill = float("-inf") if is_dilate else float("inf")
    combine = torch.maximum if is_dilate else torch.minimum
    out = x
    for _ in range(iters):
        acc = out
        for dy, dx in offsets:
            if dy or dx:
                acc = combine(acc, _shift2d(out, dy, dx, fill))
        out = acc
    return out


def trimap_plain(x: torch.Tensor, offsets: Offsets,
                 iters: int) -> torch.Tensor:
    """{0, 128, 255}: 255 where the erode > 127, 0 where the dilate < 128."""
    tri = torch.full_like(x, 128.0)
    tri = torch.where(morph_plain(x, offsets, iters, False) > 127.0, 255.0,
                      tri)
    return torch.where(morph_plain(x, offsets, iters, True) < 128.0, 0.0,
                       tri)


# -- kernels -----------------------------------------------------------------
def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous 2-D float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def _c_offsets(offsets: Offsets):
    flat = [int(v) for off in offsets for v in off]
    return (ctypes.c_int * max(len(flat), 1))(*flat), len(flat) // 2


def morph(x: torch.Tensor, offsets: Offsets, iters: int,
          is_dilate: bool) -> torch.Tensor:
    """K2: `iters` dilations (or erosions) of the (H, W) mask `x`."""
    if x.device.type == "cpu":
        return morph_plain(x, offsets, iters, is_dilate)
    _check_input(x, "morph")
    lib = build.library()
    out = torch.empty_like(x)
    # the scratch a chain longer than one launch ping-pongs through; the C
    # side decides how many launches a chain takes
    tmp = torch.empty_like(x)
    offs, n = _c_offsets(offsets)
    launches = ctypes.c_int(0)
    h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vut_morph(x.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                            h, w, ctypes.addressof(offs), n, int(iters),
                            int(is_dilate), stream,
                            ctypes.addressof(launches))
    build.check(err, "morph kernel")
    MORPH.add(launches)
    return out


def trimap(x: torch.Tensor, offsets: Offsets, iters: int) -> torch.Tensor:
    """K1: the fused dilate/erode/select trimap of the (H, W) mask `x`."""
    if x.device.type == "cpu":
        return trimap_plain(x, offsets, iters)
    _check_input(x, "trimap")
    lib = build.library()
    out = torch.empty_like(x)
    # scratch for the dilate and erode chains, used when they are too long
    # for the fused launch alone
    tmp_d, tmp_e = torch.empty_like(x), torch.empty_like(x)
    offs, n = _c_offsets(offsets)
    launches = ctypes.c_int(0)
    h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vut_trimap(x.data_ptr(), out.data_ptr(), tmp_d.data_ptr(),
                             tmp_e.data_ptr(), h, w, ctypes.addressof(offs),
                             n, int(iters), stream,
                             ctypes.addressof(launches))
    build.check(err, "trimap kernel")
    TRIMAP.add(launches)
    return out
