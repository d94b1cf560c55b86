"""The port's wire packing (`video_unscreen_tpu_torch/ops/wirepack.py`)
against the JAX package's `ops/wirepack.py` on the same planes: the packed
bytes equal byte for byte (float input, the all-0 and all-255 planes, a
random plane at full capacity, an overflow that keeps the true count and
drops the values past the capacity, a batch of 3 against `jax.vmap`),
and the host unpack's round trip, fallback and ValueError."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_unscreen_tpu.ops import wirepack as jw
from video_unscreen_tpu_torch.ops import wirepack as tw


def _mostly_binary_plane(rng, h, w, band_frac=0.03):
    a = np.where(rng.rand(h, w) < 0.4, 255, 0).astype(np.uint8)
    band = rng.rand(h, w) < band_frac
    a[band] = rng.randint(1, 255, band.sum()).astype(np.uint8)
    return a


def _planes():
    rng = np.random.RandomState(0)
    soft = rng.uniform(-20.0, 280.0, (32, 64)).astype(np.float32)
    soft[rng.rand(32, 64) < 0.5] = 255.0
    return {
        "binary": (_mostly_binary_plane(rng, 64, 96), None),
        "float": (soft, 32 * 64),
        "zeros": (np.zeros((32, 64), np.uint8), None),
        "full": (np.full((32, 64), 255, np.uint8), None),
        "random_full_capacity": (
            rng.randint(0, 256, (32, 64)).astype(np.uint8), 32 * 64),
        "overflow": (rng.randint(1, 255, (16, 16)).astype(np.uint8), 8),
    }


@pytest.mark.parametrize("name", list(_planes()))
def test_pack_plane_bytes_equal_jax(name):
    plane, cap = _planes()[name]
    want = np.asarray(jw.pack_plane(jnp.asarray(plane), cap))
    got = tw.pack_plane(torch.from_numpy(plane), cap)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    h, w = plane.shape
    assert got.numel() == tw.packed_size(h, w, cap) == jw.packed_size(
        h, w, cap)


def test_overflow_keeps_count_and_drops_values():
    plane, cap = _planes()["overflow"]
    buf = tw.pack_plane(torch.from_numpy(plane), cap).numpy()
    assert int(buf[-4:].view("<u4")[0]) == plane.size
    # the first `cap` band values in raster order, the rest dropped
    np.testing.assert_array_equal(buf[64:64 + cap], plane.reshape(-1)[:cap])
    assert tw.unpack_plane(buf, 16, 16, cap) is None
    out = tw.unpack_planes(buf[None], 16, 16, cap, fallback=lambda i: plane)
    np.testing.assert_array_equal(out[0], plane)
    with pytest.raises(ValueError, match="overflowed"):
        tw.unpack_planes(buf[None], 16, 16, cap)


def test_batch_against_vmap_and_round_trip():
    rng = np.random.RandomState(3)
    planes = np.stack([_mostly_binary_plane(rng, 32, 32) for _ in range(3)])
    want = np.asarray(jax.vmap(jw.pack_plane)(jnp.asarray(planes)))
    got = tw.pack_plane(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tw.unpack_planes(got, 32, 32), planes)
    # the JAX package's unpack reads the port's bytes and back
    np.testing.assert_array_equal(jw.unpack_planes(got, 32, 32), planes)
    assert tw.default_capacity(32, 32) == jw.default_capacity(32, 32) == 64
    assert tw.packed_size(32, 32) == 32 * 32 // 4 + 64 + 4


def test_round_trip_float_and_extremes():
    for name in ("float", "zeros", "full", "random_full_capacity"):
        plane, cap = _planes()[name]
        buf = tw.pack_plane(torch.from_numpy(plane), cap).numpy()
        h, w = plane.shape
        want = np.clip(plane, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(tw.unpack_plane(buf, h, w, cap), want)
