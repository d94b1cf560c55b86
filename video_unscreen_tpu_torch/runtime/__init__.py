"""The port's native host runtime (ctypes over two C++ libraries).

- `loader.cpp`, the port's own baseline JPEG codec (no library: written
  from ITU-T T.81, held bit for bit to libjpeg-turbo as cv2 and the JAX
  package's runtime use it): `probe`, `decode_batch`,
  `decode_gray_batch` (the luma plane, as cv2's IMREAD_GRAYSCALE),
  `encode_batch` (BGR as 4:2:0, or gray for 2-D images) and
  `encode_jpeg` (one image to bytes). A progressive, arithmetic-coded,
  lossless, 12-bit, CMYK or RGB-coded file raises with that name (the
  JAX package's libjpeg decodes those).
- `hostprep.cpp`, host frame work without OpenCV or libjpeg:
  `resize_batch` (bit-equal to `cv2.resize(..., INTER_LINEAR)` on uint8),
  `bgr_to_i420_batch` (bit-equal to `cv2.cvtColor(...,
  COLOR_BGR2YUV_I420)`) and `prep_batch`, both in one pass into a
  caller's buffer (the streamer's pinned memory); the host fetch's fg
  un-blends `get_fg_batch` and `unblend_fg_batch`; `bgr_to_hsv` and
  `hsv_to_bgr`, bit-equal to cv2's 8-bit conversions. `ctypes` releases
  the GIL for each call.
- `bgr_to_gray` (numpy): `cv2.cvtColor(..., COLOR_BGR2GRAY)` on uint8,
  bit for bit.

Each library is built at first use with its own `g++` call (no `-l`
library) into `video_unscreen_tpu_torch/_build/`, named by a hash of its
one source file and the flags. A failed build raises; nothing falls back
to another codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
THREADS = min(8, os.cpu_count() or 1)
_MSG_CAP = 512  # bytes of a codec error message

_P, _I = ctypes.c_void_p, ctypes.c_int
_libs = {}


def _lib_path(src: Path, flags: Tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS + flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libvut_{src.stem}_{h.hexdigest()[:16]}.so"


def _build(src: Path, flags: Tuple[str, ...] = ()) -> Path:
    """Compile `src` unless its library exists; raise if g++ fails or is
    missing."""
    out = _lib_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, *flags, str(src), "-o",
                                   tmp], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build {src.name}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed on {src.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _codec() -> ctypes.CDLL:
    if "codec" not in _libs:
        lib = ctypes.CDLL(str(_build(_HERE / "loader.cpp")))
        for name in ("vu_decode_batch", "vu_decode_gray_batch"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = [
                _P, _I, _I, _I, _P, _I, ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, _I]
        lib.vu_encode_batch.restype = _I
        lib.vu_encode_batch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I]
        lib.vu_encode_memory.restype = ctypes.c_long
        lib.vu_encode_memory.argtypes = [_P, _I, _I, _I, _I, _P,
                                         ctypes.c_long]
        lib.vu_probe.restype = _I
        lib.vu_probe.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_char_p, _I]
        _libs["codec"] = lib
    return _libs["codec"]


def available() -> bool:
    """Whether `g++` built the JPEG codec (what the JAX package's
    `runtime.available()` answers). It needs no library, so it builds
    wherever `g++` runs; the codec's own calls raise where it does not."""
    try:
        _codec()
    except RuntimeError:
        return False
    return True


def _hostprep() -> ctypes.CDLL:
    if "hostprep" not in _libs:
        # no fused multiply-adds but the ones the source asks for
        lib = ctypes.CDLL(str(_build(_HERE / "hostprep.cpp",
                                     ("-ffp-contract=off",))))
        lib.vu_prep_batch.restype = _I
        lib.vu_prep_batch.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I]
        for name in ("vu_get_fg_batch", "vu_unblend_fg_batch"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = [_P, _P, _P, _P, _I, _I, _I, _I]
        for name in ("vu_bgr2hsv_cv", "vu_hsv2bgr_cv"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = [_P, _P, _I, _I, _I]
        _libs["hostprep"] = lib
    return _libs["hostprep"]


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _probe(path: str) -> Tuple[Optional[Tuple[int, int]], str]:
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_CAP)
    if _codec().vu_probe(os.fsencode(path), ctypes.byref(h), ctypes.byref(w),
                         msg, _MSG_CAP) != 0:
        return None, msg.value.decode(errors="replace")
    return (h.value, w.value), ""


def probe(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) of a JPEG file from its frame header (any JPEG, also one
    the decoder refuses), or None if it has none."""
    return _probe(path)[0]


def _first_size(paths: Sequence[str]) -> Tuple[int, int]:
    hw, why = _probe(paths[0])
    if hw is None:
        raise RuntimeError(f"{paths[0]}: {why}")
    return hw


def _decode(fn, paths: Sequence[str], hw: Tuple[int, int],
            out: np.ndarray, threads: int) -> np.ndarray:
    """Run a batch decode of the codec; raises with the first failed file
    and why it failed."""
    first = ctypes.c_int(-1)
    msg = ctypes.create_string_buffer(_MSG_CAP)
    failures = fn(_c_paths(paths), len(paths), *hw, out.ctypes.data, threads,
                  ctypes.byref(first), msg, _MSG_CAP)
    if failures:
        raise RuntimeError(
            f"{paths[first.value]}: {msg.value.decode(errors='replace')} "
            f"({failures} of {len(paths)} JPEG decodes failed)")
    return out


def decode_batch(paths: Sequence[str],
                 target_hw: Optional[Tuple[int, int]] = None,
                 threads: int = 16) -> np.ndarray:
    """Threaded JPEG decode to one (n, h, w, 3) BGR uint8 array, at the
    first file's size unless `target_hw` is given (then resized with the
    codec's float bilinear). Raises, naming the file and why, if a file
    does not decode."""
    paths = list(paths)
    if not paths:
        raise ValueError("decode_batch: no paths")
    th, tw = _first_size(paths) if target_hw is None else target_hw
    return _decode(_codec().vu_decode_batch, paths, (th, tw),
                   np.empty((len(paths), th, tw, 3), np.uint8), threads)


def decode_gray_batch(paths: Sequence[str], threads: int = 16) -> np.ndarray:
    """Threaded JPEG decode to one (n, h, w) gray uint8 array, at the first
    file's size: the luma plane of a colour file, which is what
    `cv2.imread(..., IMREAD_GRAYSCALE)` reads (not the BGR decode's
    `bgr_to_gray`). Raises, naming the file and why, if a file does not
    decode or has another size."""
    paths = list(paths)
    if not paths:
        raise ValueError("decode_gray_batch: no paths")
    hw = _first_size(paths)
    return _decode(_codec().vu_decode_gray_batch, paths, hw,
                   np.empty((len(paths),) + hw, np.uint8), threads)


def _image_batch(imgs: np.ndarray, what: str) -> np.ndarray:
    imgs = np.ascontiguousarray(imgs, np.uint8)
    if imgs.ndim not in (3, 4) or (imgs.ndim == 4 and imgs.shape[3] != 3) \
            or 0 in imgs.shape[1:3]:
        raise ValueError(f"{what}: images of shape {imgs.shape}, want "
                         f"(n, h, w) or (n, h, w, 3), h and w > 0")
    return imgs


def encode_batch(paths: Sequence[str], imgs: np.ndarray, quality: int = 95,
                 threads: int = 16) -> int:
    """Threaded JPEG encode of (n, h, w, 3) BGR or (n, h, w) gray uint8
    images, byte for byte what `cv2.imwrite` writes at that quality.
    Returns the failure count (0); raises if a file was not written."""
    paths = list(paths)
    imgs = _image_batch(imgs, "encode_batch")
    if len(paths) != imgs.shape[0]:
        raise ValueError(f"encode_batch: {len(paths)} paths for "
                         f"{imgs.shape[0]} images")
    n, h, w = imgs.shape[:3]
    c = 1 if imgs.ndim == 3 else 3
    failures = _codec().vu_encode_batch(_c_paths(paths), imgs.ctypes.data,
                                        n, h, w, c, int(quality), threads)
    if failures:
        raise RuntimeError(f"{failures} of {n} JPEG encodes failed (first "
                           f"path {paths[0]})")
    return failures


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """One (h, w, 3) BGR or (h, w) gray uint8 image as JPEG bytes (what
    `encode_batch` writes to a file)."""
    img = _image_batch(np.asarray(img)[None], "encode_jpeg")
    h, w = img.shape[1:3]
    c = 1 if img.ndim == 3 else 3
    cap = h * w * c + 4096
    while True:
        buf = np.empty(cap, np.uint8)
        n = _codec().vu_encode_memory(img.ctypes.data, h, w, c, int(quality),
                                      buf.ctypes.data, cap)
        if n < 0:
            raise RuntimeError(f"JPEG encode of a {img.shape[1:]} image "
                               f"failed")
        if n <= cap:
            return buf[:n].tobytes()
        cap = n


def _frame_pointers(frames: Sequence[np.ndarray]) -> Tuple[List, tuple]:
    """Validate a batch of same-shaped contiguous uint8 images; return
    their data pointers and shape."""
    if not frames:
        raise ValueError("empty batch")
    shape = frames[0].shape
    for f in frames:
        if not (isinstance(f, np.ndarray) and f.dtype == np.uint8
                and f.flags.c_contiguous and f.shape == shape):
            raise ValueError(
                f"host prep wants contiguous uint8 images of one shape "
                f"{shape}; got {getattr(f, 'dtype', type(f))} "
                f"{getattr(f, 'shape', '')}")
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] not in
                                    (1, 3)):
        raise ValueError(f"host prep: image shape {shape}")
    return [f.ctypes.data for f in frames], shape


def prep_batch(frames: Sequence[np.ndarray], out_hw: Tuple[int, int],
               i420: bool, out: Optional[np.ndarray] = None,
               threads: int = THREADS) -> np.ndarray:
    """Each frame resized to `out_hw` with cv2's INTER_LINEAR (copied when
    it has that size already), then, if `i420`, converted to cv2's I420
    layout (h * 3 / 2, w): all in one call, into `out` (n, ...) when
    given. `frames` are contiguous uint8 (h, w), (h, w, 1) or (h, w, 3)
    arrays of one shape (three channels for I420)."""
    ptrs, shape = _frame_pointers(list(frames))
    sh, sw = shape[:2]
    c = 1 if len(shape) == 2 else shape[2]
    dh, dw = (int(v) for v in out_hw)
    if i420 and (c != 3 or dh % 2 or dw % 2):
        raise ValueError(f"I420 needs 3-channel frames of even size, got "
                         f"{shape} -> {(dh, dw)}")
    one = (dh * 3 // 2, dw) if i420 else (dh, dw) + shape[2:]
    want = (len(ptrs),) + one
    if out is None:
        out = np.empty(want, np.uint8)
    elif out.shape != want or out.dtype != np.uint8 or \
            not out.flags.c_contiguous:
        raise ValueError(f"prep_batch: out {out.dtype} {out.shape}, want "
                         f"contiguous uint8 {want}")
    _hostprep().vu_prep_batch((ctypes.c_void_p * len(ptrs))(*ptrs),
                              len(ptrs), sh, sw, c, dh, dw, int(bool(i420)),
                              out.ctypes.data, int(threads))
    return out


def resize_batch(frames: Sequence[np.ndarray], out_hw: Tuple[int, int],
                 out: Optional[np.ndarray] = None,
                 threads: int = THREADS) -> np.ndarray:
    """`cv2.resize(f, (w, h), interpolation=INTER_LINEAR)` of each uint8
    BGR or single-plane frame, stacked: (n, h, w[, c])."""
    return prep_batch(frames, out_hw, False, out, threads)


def bgr_to_i420_batch(frames: Sequence[np.ndarray],
                      out: Optional[np.ndarray] = None,
                      threads: int = THREADS) -> np.ndarray:
    """`cv2.cvtColor(f, COLOR_BGR2YUV_I420)` of each (h, w, 3) frame (h, w
    even), stacked: (n, h * 3 / 2, w)."""
    frames = list(frames)
    hw = frames[0].shape[:2] if frames else (0, 0)
    return prep_batch(frames, hw, True, out, threads)


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_BGR2GRAY)` of a uint8 (..., 3) BGR image,
    bit for bit: (3735 B + 19235 G + 9798 R + 16384) >> 15, the rounding
    of the cv2 build the JAX package runs with (its Intel IPP path; equal
    to it on every one of the 2^24 BGR triples). OpenCV's plain C path
    rounds (1868 B + 9617 G + 4899 R + 8192) >> 14 instead, which differs
    by 1 on 0.26% of the triples. Both give v for B = G = R = v. The float
    `ops.color.bgr2gray` is another function: it truncates."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"bgr_to_gray wants uint8 (..., 3), got {img.dtype} "
                         f"{img.shape}")
    x = img.astype(np.int32)
    y = 3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2] + 16384
    return (y >> 15).astype(np.uint8)


def _images(x: np.ndarray, what: str) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8)
    if x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"{what}: images of shape {x.shape}, want "
                         f"(n, h, w, 3)")
    return x


def _unblend(fn: str, frames: np.ndarray, alphas: np.ndarray, bg,
             threads: int) -> np.ndarray:
    frames = _images(frames, fn)
    alphas = np.ascontiguousarray(alphas, np.uint8)
    if alphas.shape != frames.shape[:3]:
        raise ValueError(f"{fn}: alphas {alphas.shape} for frames "
                         f"{frames.shape}")
    out = np.empty_like(frames)
    getattr(_hostprep(), fn)(frames.ctypes.data, alphas.ctypes.data,
                             bg.ctypes.data, out.ctypes.data,
                             *frames.shape[:3], int(threads))
    return out


def get_fg_batch(frames: np.ndarray, alphas: np.ndarray,
                 bg_colors: np.ndarray, threads: int = 16) -> np.ndarray:
    """The HSV foreground un-blend on the host (the reference's
    `fgfuncs.py:84-110`) against each frame's screen colour: (n, h, w, 3)
    uint8 BGR frames, (n, h, w) uint8 alphas, (n, 3) float BGR colours ->
    (n, h, w, 3) uint8. The background is the frame itself where alpha <
    128. Threaded in C++."""
    bg_colors = np.ascontiguousarray(bg_colors, np.float32)
    if bg_colors.shape != (len(frames), 3):
        raise ValueError(f"get_fg_batch: bg_colors {bg_colors.shape}, want "
                         f"({len(frames)}, 3)")
    return _unblend("vu_get_fg_batch", frames, alphas, bg_colors, threads)


def unblend_fg_batch(frames: np.ndarray, alphas: np.ndarray,
                     bgs: np.ndarray, threads: int = 16) -> np.ndarray:
    """The same un-blend against a background image a pixel (bg mode's
    host reconstruction): `bgs` (n, h, w, 3) uint8 BGR."""
    bgs = _images(bgs, "unblend_fg_batch")
    if bgs.shape != np.shape(frames):
        raise ValueError(f"unblend_fg_batch: bgs {bgs.shape} for frames "
                         f"{np.shape(frames)}")
    return _unblend("vu_unblend_fg_batch", frames, alphas, bgs, threads)


def _hsv(fn: str, img: np.ndarray, threads: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim < 2 or img.shape[-1] != 3:
        raise ValueError(f"{fn}: want uint8 (..., w, 3), got {img.shape}")
    out = np.empty_like(img)
    w = img.shape[-2]
    getattr(_hostprep(), fn)(img.ctypes.data, out.ctypes.data,
                             img.size // (3 * w), w, int(threads))
    return out


def bgr_to_hsv(img: np.ndarray, threads: int = THREADS) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_BGR2HSV)` of uint8 (..., w, 3) images (H in
    0..179), bit for bit, row by row."""
    return _hsv("vu_bgr2hsv_cv", img, threads)


def hsv_to_bgr(img: np.ndarray, threads: int = THREADS) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_HSV2BGR)` of uint8 (..., w, 3) HSV images,
    bit for bit, row by row. The cv2 build the JAX package runs (5.0.0)
    rounds a pixel by where it sits in its row: the first 32 * (w // 32)
    truncate (its vector loop), the rest round to nearest (its scalar
    tail); this function does the same."""
    return _hsv("vu_hsv2bgr_cv", img, threads)
