"""The port's own JPEG codec (`video_unscreen_tpu_torch/runtime/loader.cpp`,
no library) against libjpeg-turbo: the JAX package's runtime (the system
libjpeg-turbo), its `parallel_read_img` and cv2 (its bundled copy).

- Decode is bit-equal to JAX's `runtime.decode_batch` and
  `utils.fileio.parallel_read_img` on files cv2 writes: sizes 1x1 to
  1080x1920, qualities 50 to 100, subsampling 4:2:0, 4:2:2, 4:4:4 and
  4:4:0, optimized Huffman tables, restart intervals and gray files,
  smooth and uniform-noise images.
- The gray decode is bit-equal to `cv2.imread(..., IMREAD_GRAYSCALE)`.
- Encode is byte-equal to JAX's `runtime.encode_batch` and to
  `cv2.imwrite`, BGR and gray, at the same qualities and sizes.
- Progressive, arithmetic-coded, lossless, 12-bit, CMYK and truncated
  files raise, naming the file and the mode.
- `chip_smoke.py`'s codec constants are libjpeg's hashes of the same
  frames.
"""
import hashlib
import importlib.util
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest

from video_unscreen_tpu import runtime as jrt
from video_unscreen_tpu.utils import fileio as jfileio
from video_unscreen_tpu_torch import runtime as rt
from video_unscreen_tpu_torch.utils.synthetic import green_clip

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(1, 1), (7, 9), (37, 53), (72, 96), (1080, 1920)]
QUALITIES = [50, 75, 95, 100]
SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111,
            "440": 0x121111}
EXTRAS = {"": [], "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
          "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


def _image(kind, h, w, seed=0):
    if kind == "noise":
        return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
            np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(h + w - 2, 1)
                    + 60 * np.sin(x / 5.0)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cases(hw):
    """(quality, image kind, extra) of one size: every combination at the
    small sizes, one file a kind at 1080x1920 (a noise file there is
    6 MB)."""
    if hw == (1080, 1920):
        return [(95, "smooth", ""), (100, "noise", "")]
    return [(q, k, e) for q in QUALITIES for k in ("smooth", "noise")
            for e in EXTRAS]


def _write(d, hw, q, kind, samp, extra, gray=False):
    img = _image(kind, *hw)
    if gray:
        img = np.ascontiguousarray(img[..., 1])
    p = str(d / f"{hw[0]}x{hw[1]}_q{q}_{kind}_{samp}_{extra or 'plain'}"
                f"{'_gray' if gray else ''}.jpg")
    cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, q,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[samp]]
                + EXTRAS[extra])
    return p


@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decode_bit_equal_to_libjpeg(tmp_path, hw, samp):
    paths = [_write(tmp_path, hw, q, kind, samp, extra)
             for q, kind, extra in _cases(hw)]
    for p in paths:
        got = rt.decode_batch([p], threads=1)[0]
        assert rt.probe(p) == hw
        np.testing.assert_array_equal(got, jrt.decode_batch([p])[0],
                                      err_msg=p)
        np.testing.assert_array_equal(got, cv2.imread(p), err_msg=p)
    np.testing.assert_array_equal(
        np.stack(jfileio.parallel_read_img(paths)),
        rt.decode_batch(paths, threads=4))


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_gray_decode_bit_equal_to_cv2(tmp_path, hw):
    """The luma plane of every subsampling, and gray files (one
    component), read as cv2's IMREAD_GRAYSCALE reads them; a gray file
    read as BGR has three equal channels, as cv2 reads it."""
    paths = [_write(tmp_path, hw, q, kind, samp, extra)
             for samp in SAMPLING for q, kind, extra in _cases(hw)[::5]]
    grays = [_write(tmp_path, hw, q, kind, "420", extra, gray=True)
             for q, kind, extra in _cases(hw)]
    for p in paths + grays:
        np.testing.assert_array_equal(
            rt.decode_gray_batch([p], threads=1)[0],
            cv2.imread(p, cv2.IMREAD_GRAYSCALE), err_msg=p)
    for p in grays:
        got = rt.decode_batch([p], threads=1)[0]
        np.testing.assert_array_equal(got, cv2.imread(p), err_msg=p)
        np.testing.assert_array_equal(got, jrt.decode_batch([p])[0],
                                      err_msg=p)


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
@pytest.mark.parametrize("hw", SIZES + [(16, 16), (17, 33), (8, 24)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_encode_byte_equal_to_libjpeg(tmp_path, hw, gray):
    """Every quality on a smooth and a noise image (1080x1920: 95 and
    100); the sizes cover the MCU's dummy blocks at the right and the
    bottom and the chroma rows past the image."""
    qs = [95, 100] if hw == (1080, 1920) else [1] + QUALITIES
    for q in qs:
        for kind in ("smooth", "noise"):
            img = _image(kind, *hw, seed=q)
            if gray:
                img = np.ascontiguousarray(img[..., 0])
            ref, got = str(tmp_path / "cv2.jpg"), str(tmp_path / "port.jpg")
            cv2.imwrite(ref, img, [cv2.IMWRITE_JPEG_QUALITY, q])
            rt.encode_batch([got], img[None], quality=q, threads=1)
            want = Path(ref).read_bytes()
            assert Path(got).read_bytes() == want, (hw, q, kind)
            assert rt.encode_jpeg(img, q) == want, (hw, q, kind)
            if not gray:  # JAX's runtime encodes BGR only
                lib = str(tmp_path / "jax.jpg")
                jrt.encode_batch([lib], img[None], quality=q)
                assert Path(lib).read_bytes() == want, (hw, q, kind)


def _baseline(tmp_path):
    p = tmp_path / "base.jpg"
    cv2.imwrite(str(p), _image("noise", 24, 32))
    return p.read_bytes()


def _with_sof(data, marker=None, precision=None):
    """The file with its SOF0 marker or precision byte changed."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _cmyk(_):
    """SOI, a frame header of 4 components, EOI."""
    sof = bytes([0xFF, 0xC0, 0, 20, 8, 0, 8, 0, 8, 4]) + bytes(
        b for i in range(4) for b in (i + 1, 0x11, 0))
    return b"\xff\xd8" + sof + b"\xff\xd9"


@pytest.mark.parametrize("make,match", [
    (lambda t: None, "a progressive JPEG"),
    (lambda t: _with_sof(_baseline(t), marker=0xC9), "arithmetic-coded"),
    (lambda t: _with_sof(_baseline(t), marker=0xC3), "a lossless JPEG"),
    (lambda t: _with_sof(_baseline(t), precision=12), "a 12-bit JPEG"),
    (_cmyk, "a CMYK or YCCK JPEG"),
    (lambda t: _baseline(t)[:400], "truncated"),
], ids=["progressive", "arithmetic", "lossless", "12bit", "cmyk",
        "truncated"])
def test_unsupported_files_raise_by_name(tmp_path, make, match):
    bad = tmp_path / "bad.jpg"
    data = make(tmp_path)
    if data is None:
        cv2.imwrite(str(bad), _image("noise", 24, 32),
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    else:
        bad.write_bytes(data)
    good = tmp_path / "good.jpg"
    good.write_bytes(_baseline(tmp_path))
    for read in (rt.decode_batch, rt.decode_gray_batch):
        with pytest.raises(RuntimeError, match=match) as err:
            read([str(good), str(bad)])
        assert str(bad) in str(err.value)


def test_chip_smoke_codec_constants_are_libjpegs():
    """The hashes `chip_smoke.py`'s codec phase checks on the card are
    those of libjpeg (JAX's runtime) for the same frames: the frames, the
    8 files encoded at quality 95, and those files decoded."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    frames = np.stack(green_clip(smoke.N_FRAMES, *smoke.FRAME_HW,
                                 seed=smoke.SEED)[0])
    assert hashlib.sha256(frames.tobytes()).hexdigest() == \
        smoke.CODEC_SHA256["frames"]
    with tempfile.TemporaryDirectory() as d:
        paths = [f"{d}/{i}.jpg" for i in range(len(frames))]
        jrt.encode_batch(paths, frames, quality=smoke.CODEC_QUALITY)
        enc = hashlib.sha256(b"".join(Path(p).read_bytes() for p in paths))
        dec = hashlib.sha256(jrt.decode_batch(paths).tobytes())
    assert enc.hexdigest() == smoke.CODEC_SHA256["encoded"]
    assert dec.hexdigest() == smoke.CODEC_SHA256["decoded"]


def test_available_answers_whether_the_codec_builds(monkeypatch, tmp_path):
    """The codec needs only g++: `available()` is True here, and False
    (with every codec call raising, naming the compiler) without it."""
    assert rt.available()
    monkeypatch.setattr(rt, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(rt, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rt, "_libs", {})
    assert not rt.available()
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        rt.decode_batch([str(tmp_path / "a.jpg")])
