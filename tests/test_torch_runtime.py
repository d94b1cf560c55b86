"""The port's native host runtime (`video_unscreen_tpu_torch/runtime`)
against cv2 and the JAX package's runtime.

- `resize_batch` is bit-equal to `cv2.resize(..., INTER_LINEAR)` on uint8
  BGR and single planes: production (1080x1920 -> 544x960), an exact 2x
  downscale (cv2 takes its INTER_AREA shortcut there, which the
  fixed-point formula reproduces), odd sizes and an upscale. The vertical
  pass must use OpenCV's 8-bit rounding,
  (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2, in
  every column: the textbook (S0 * b0 + S1 * b1 + 2^21) >> 22 differs by
  1 on about 12% of the pixels.
- `bgr_to_i420_batch` is bit-equal to `cv2.cvtColor(...,
  COLOR_BGR2YUV_I420)` at even sizes.
- `decode_batch` is bit-equal to the JAX runtime's on the same files and
  within `tests/test_runtime.py`'s bound of `cv2.imread` (mean |diff| <
  2); encodes round-trip in 3 channels and 1 (`tests/test_torch_codec.py`
  holds the codec bit for bit).
- A build without its compiler raises (no `None`, no other codec).
"""
import os

import cv2
import numpy as np
import pytest

from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu import runtime as jrt
from video_unscreen_tpu_torch import runtime as rt

RESIZES = [((1080, 1920), (544, 960)), ((192, 256), (96, 128)),
           ((97, 131), (64, 86)), ((64, 86), (97, 131))]


def _images(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src_hw,dst_hw", RESIZES)
def test_resize_bit_equal_to_cv2(src_hw, dst_hw, channels):
    shape = src_hw + (3,) if channels == 3 else src_hw
    imgs = _images(2, shape, seed=sum(src_hw) + channels)
    got = rt.resize_batch(imgs, dst_hw)
    want = np.stack([cv2.resize(i, dst_hw[::-1],
                                interpolation=cv2.INTER_LINEAR)
                     for i in imgs])
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(544, 960), (96, 128), (270, 480)])
def test_i420_bit_equal_to_cv2(hw):
    imgs = _images(2, hw + (3,), seed=hw[0])
    got = rt.bgr_to_i420_batch(imgs)
    want = np.stack([cv2.cvtColor(i, cv2.COLOR_BGR2YUV_I420) for i in imgs])
    assert got.shape == (2, hw[0] * 3 // 2, hw[1])
    np.testing.assert_array_equal(got, want)


def test_prep_batch_resizes_then_packs():
    """One call does what the JAX host path does with two cv2 calls."""
    imgs = _images(3, (192, 256, 3), seed=5)
    out = np.empty((3, 144, 128), np.uint8)
    rt.prep_batch(imgs, (96, 128), True, out=out)
    want = np.stack([cv2.cvtColor(cv2.resize(i, (128, 96)),
                                  cv2.COLOR_BGR2YUV_I420) for i in imgs])
    np.testing.assert_array_equal(out, want)


def test_prep_batch_rejects_bad_input():
    img = _images(1, (96, 128, 3), seed=1)[0]
    with pytest.raises(ValueError, match="contiguous uint8"):
        rt.resize_batch([img[:, ::2]], (48, 64))
    with pytest.raises(ValueError, match="contiguous uint8"):
        rt.resize_batch([img.astype(np.float32)], (48, 64))
    with pytest.raises(ValueError, match="even size"):
        rt.prep_batch([img], (47, 64), True)
    with pytest.raises(ValueError, match="want contiguous uint8"):
        rt.resize_batch([img], (48, 64), out=np.empty((1, 48, 65, 3),
                                                      np.uint8))


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vut_runtime")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        img = np.zeros((72, 96, 3), np.uint8)
        img[:] = (i * 20, 100, 200 - i * 20)
        img[10:50, 20:70] = rng.randint(0, 255, 3)
        p = str(d / f"frame_{i:06d}.jpg")
        cv2.imwrite(p, img)
        paths.append(p)
    return d, paths


def test_decode_equals_jax_runtime(jpeg_files):
    _, paths = jpeg_files
    got = rt.decode_batch(paths, threads=4)
    assert got.shape == (6, 72, 96, 3) and rt.probe(paths[0]) == (72, 96)
    np.testing.assert_array_equal(got, jrt.decode_batch(paths, threads=4))
    np.testing.assert_array_equal(
        rt.decode_batch(paths, target_hw=(36, 48), threads=4),
        jrt.decode_batch(paths, target_hw=(36, 48), threads=4))
    for i, p in enumerate(paths):
        diff = np.abs(got[i].astype(int) - cv2.imread(p).astype(int))
        assert diff.mean() < 2.0, f"frame {i}: mean diff {diff.mean()}"


def test_decode_failure_raises(jpeg_files):
    d, paths = jpeg_files
    with pytest.raises(RuntimeError, match="1 of 2 JPEG decodes failed"):
        rt.decode_batch([paths[0], str(d / "missing.jpg")])


@pytest.mark.parametrize("channels", [3, 1])
def test_encode_round_trip(jpeg_files, channels):
    d, _ = jpeg_files
    shape = (40, 50, 3) if channels == 3 else (40, 50)
    imgs = np.stack([np.full(shape, c, np.uint8) for c in (30, 128, 220)])
    paths = [str(d / f"enc{channels}_{i}.jpg") for i in range(3)]
    assert rt.encode_batch(paths, imgs, quality=95, threads=2) == 0
    for i, p in enumerate(paths):
        back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert back.shape == shape, (p, back.shape)
        assert np.abs(back.astype(int) - imgs[i].astype(int)).mean() < 3.0


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(rt, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(rt, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rt, "_libs", {})
    img = _images(1, (8, 8, 3), seed=0)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        rt.resize_batch(img, (4, 4))
    assert not os.listdir(tmp_path / "build")
