"""File I/O: image lists, parallel image decode, image writes.

Port of `video_unscreen_tpu/utils/fileio.py` without cv2: JPEG files go
through the port's own threaded codec (`runtime/loader.cpp`, bit-equal to
libjpeg-turbo) and resizes through its host prep (`runtime/hostprep.cpp`,
cv2's INTER_LINEAR). PNG files, 8-bit gray or BGR, go through a lossless
codec on the standard library's `zlib` and `struct` (`write_png`,
`read_png`). Another format raises and names itself (the JAX package
falls back to cv2 there). `save_video` writes an MJPEG MP4
(`utils/video.py`), where the JAX package writes MPEG-4 Part 2 through
cv2: neither machine the port runs on has an MPEG-4 encoder.
"""

from __future__ import annotations

import os
import os.path as osp
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from .. import runtime
from . import video

_JPEG = (".jpg", ".jpeg")
_PNG = (".png",)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types: gray and RGB (8 bits a sample)
_GRAY, _RGB = 0, 2


def read_txt_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def write_txt_list(path: str, items: Sequence[str]) -> None:
    with open(path, "w") as f:
        for it in items:
            f.write(f"{it}\n")


def _image_format(path: str) -> str:
    ext = osp.splitext(path)[1].lower()
    if ext in _JPEG:
        return "jpeg"
    if ext in _PNG:
        return "png"
    raise ValueError(
        f"{path}: {ext.lstrip('.').upper() or 'extensionless'} images are "
        f"not supported; the port reads and writes JPEG and PNG only")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 gray (h, w) or BGR (h, w, 3) image as a lossless
    8-bit PNG (every row unfiltered, zlib-compressed)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 3:
        kind, rows = _RGB, img[..., ::-1]
    elif img.ndim == 2:
        kind, rows = _GRAY, img
    else:
        raise ValueError(f"write_png: uint8 (h, w) or (h, w, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + rows[0].size), np.uint8)  # filter byte 0: None
    raw[:, 1:] = rows.reshape(h, -1)
    data = (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, kind,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) of `h` rows of `stride` bytes, `bpp` bytes a pixel."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prior
        elif ft in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ft == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit gray or RGB PNG, not interlaced (what `write_png` and
    cv2.imwrite write): a uint8 (h, w) gray or (h, w, 3) BGR image. Every
    row filter type is read."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    at, idat, hdr = 8, [], None
    while at < len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        at += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, kind, _, _, interlace = hdr
    if depth != 8 or kind not in (_GRAY, _RGB) or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {kind}, "
                         f"interlace {interlace}: only 8-bit gray or RGB, "
                         f"not interlaced, is read")
    bpp = 1 if kind == _GRAY else 3
    out = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if kind == _GRAY:
        return out.reshape(h, w)
    return np.ascontiguousarray(out.reshape(h, w, 3)[..., ::-1])


def parallel_read_img(paths: Sequence[str],
                      num_workers: int = 16) -> List[np.ndarray]:
    """Decode image files to BGR uint8 arrays, as cv2.IMREAD_COLOR does
    (a gray PNG comes back with three equal channels): JPEGs concurrently
    and all at the first file's size (the frames of a clip share one
    geometry), PNGs one by one."""
    paths = list(paths)
    kinds = {_image_format(p) for p in paths}
    if kinds == {"jpeg"}:
        return list(runtime.decode_batch(paths, threads=num_workers))
    out = []
    for p in paths:
        if _image_format(p) == "jpeg":
            out.append(runtime.decode_batch([p], threads=1)[0])
            continue
        img = read_png(p)
        out.append(np.repeat(img[..., None], 3, axis=2) if img.ndim == 2
                   else img)
    return out


def _png_rgb_to_gray(bgr: np.ndarray) -> np.ndarray:
    """libpng's `png_set_rgb_to_gray(png, 1, 0.299, 0.587)`, which cv2
    asks for when it reads a colour PNG as gray: a pixel with R = G = B
    keeps R; any other gets (9797 R + 19234 G + 3737 B) >> 15, the
    coefficients truncated to 15 bits and the sum truncated (not cvtColor's
    rounding)."""
    x = bgr.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    mixed = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (r == b), r, mixed).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """An image file as (h, w) gray uint8, as `cv2.imread(path,
    IMREAD_GRAYSCALE)` reads it: a JPEG through the codec's grayscale
    output (a colour file's luma plane), a gray PNG as it is, a colour PNG
    through libpng's conversion (`_png_rgb_to_gray`)."""
    if _image_format(path) == "jpeg":
        return runtime.decode_gray_batch([path], threads=1)[0]
    img = read_png(path)
    return img if img.ndim == 2 else _png_rgb_to_gray(img)


def save_img(path: str, img: np.ndarray, long_side: int = -1) -> None:
    """Write a BGR (h, w, 3) or gray (h, w) uint8 image as a JPEG or a PNG
    (by the extension), its long side first brought down to `long_side`
    when it is longer."""
    fmt = _image_format(path)
    img = np.ascontiguousarray(img, np.uint8)
    if long_side > 0:
        h, w = img.shape[:2]
        if max(h, w) > long_side:
            hw = ((long_side, int(w * long_side / h)) if h > w
                  else (int(h * long_side / w), long_side))
            img = runtime.resize_batch([img], hw)[0]
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    if fmt == "png":
        write_png(path, img)
    else:
        runtime.encode_batch([path], img[None])


def frame_hw(path: str) -> Tuple[int, int]:
    """(h, w) of a JPEG (from its frame header) or PNG file."""
    if _image_format(path) == "jpeg":
        hw = runtime.probe(path)
        if hw is None:
            raise ValueError(f"{path}: not a readable JPEG")
        return hw
    return read_png(path).shape[:2]


def save_video(frame_dir: str, video_path: str, fps: float = 25.0,
               filename_tmpl: str = "{:06d}.jpg") -> int:
    """Assemble the frames of `frame_dir` (every `.jpg` and `.png`, sorted
    by name, as the JAX package selects them) into an MJPEG MP4 at `fps`
    (`utils/video.py:write_mjpeg_mp4`); returns the frame count. The
    video's size is the first frame's with each side rounded down to even,
    and a frame of another size is left out: what `cv2.VideoWriter` does
    with the frames the JAX package hands it. A JPEG of that size goes in
    as its own bytes; a PNG, or a frame cropped to even sides (its top
    left, as cv2 crops it), is encoded at quality 95. `filename_tmpl` is
    unused, as in the JAX package."""
    names = sorted(f for f in os.listdir(frame_dir)
                   if f.endswith((".jpg", ".png")))
    if not names:
        raise ValueError(f"no frames in {frame_dir}")
    paths = [osp.join(frame_dir, f) for f in names]

    def even(hw):
        return hw[0] & ~1, hw[1] & ~1

    h, w = even(frame_hw(paths[0]))

    def frames():
        for p in paths:
            hw = frame_hw(p)
            if even(hw) != (h, w):
                continue
            if _image_format(p) == "jpeg" and hw == (h, w):
                with open(p, "rb") as f:
                    yield f.read()
                continue
            img = parallel_read_img([p], num_workers=1)[0]
            yield runtime.encode_jpeg(np.ascontiguousarray(img[:h, :w]), 95)

    os.makedirs(osp.dirname(video_path) or ".", exist_ok=True)
    return video.write_mjpeg_mp4(video_path, frames(), (w, h), fps)
