"""File I/O: image lists, parallel JPEG decode, image writes.

Port of `video_unscreen_tpu/utils/fileio.py` without cv2: JPEG files go
through the port's native codec (`runtime/loader.cpp`, threaded libjpeg)
and resizes through its host prep (`runtime/hostprep.cpp`, cv2's
INTER_LINEAR). The codec reads and writes JPEG only: another format raises
and names itself (the JAX package falls back to cv2 there). `save_video`
is not ported (it needs a video encoder; ROADMAP.md items 18 and 19).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Sequence

import numpy as np

from .. import runtime

_JPEG = (".jpg", ".jpeg")


def read_txt_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def write_txt_list(path: str, items: Sequence[str]) -> None:
    with open(path, "w") as f:
        for it in items:
            f.write(f"{it}\n")


def _require_jpeg(path: str) -> None:
    ext = osp.splitext(path)[1].lower()
    if ext not in _JPEG:
        raise ValueError(
            f"{path}: {ext.lstrip('.').upper() or 'extensionless'} images "
            f"are not supported; the port's codec reads and writes JPEG "
            f"only")


def parallel_read_img(paths: Sequence[str],
                      num_workers: int = 16) -> List[np.ndarray]:
    """Decode JPEG files concurrently to BGR uint8 arrays, all at the first
    file's size (the frames of a clip share one geometry)."""
    paths = list(paths)
    for p in paths:
        _require_jpeg(p)
    return list(runtime.decode_batch(paths, threads=num_workers))


def save_img(path: str, img: np.ndarray, long_side: int = -1) -> None:
    """Write a BGR (h, w, 3) or gray (h, w) uint8 image as a JPEG, its long
    side first brought down to `long_side` when it is longer."""
    _require_jpeg(path)
    img = np.ascontiguousarray(img, np.uint8)
    if long_side > 0:
        h, w = img.shape[:2]
        if max(h, w) > long_side:
            hw = ((long_side, int(w * long_side / h)) if h > w
                  else (int(h * long_side / w), long_side))
            img = runtime.resize_batch([img], hw)[0]
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    runtime.encode_batch([path], img[None])
