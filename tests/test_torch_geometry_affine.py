"""The rest of `ops/geometry.py` in the port against the JAX package's:
`affine_warp` (a general 2x3 warp, bilinear, zero fill), the person-box
matrices of `get_affine_params` both ways, and the black-border helpers.

`affine_warp` is held to the JAX function run op by op
(`jax.disable_jit`), to 1e-6 (bit-equal here): that is
`map_coordinates(order=1, mode="constant")` as written. XLA's fused
program of it rounds the source coordinates in another order (1.1e-5 from
the op-by-op run on a rotation) and on 3 channels is not consistent with
its own per-channel warps (up to 0.8 at a few pixels), so it is no
reference; the port's warp also agrees with its own axis-aligned form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import tt
from video_unscreen_tpu.ops import geometry as jg
from video_unscreen_tpu_torch.ops import geometry as pg

MATRICES = {
    "rotation": [[np.cos(0.3), -np.sin(0.3), 5.0],
                 [np.sin(0.3), np.cos(0.3), -3.0]],
    "shear": [[1.0, 0.3, 0.0], [0.1, 1.0, 2.0]],
    "scale": [[1.7, 0.0, -4.0], [0.0, 0.6, 7.5]],
    "flip": [[-1.0, 0.0, 49.0], [0.0, 1.0, 0.0]],
}


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("shape", [(40, 50), (40, 50, 3)])
def test_affine_warp_matches_jax(kind, shape):
    rng = np.random.RandomState(len(kind) + len(shape))
    img = rng.rand(*shape).astype(np.float32)
    m = np.asarray(MATRICES[kind], np.float32)
    with jax.disable_jit():
        want = np.asarray(jg.affine_warp(jnp.asarray(img), jnp.asarray(m),
                                         (45, 38)))
    got = pg.affine_warp(tt(img), m, (45, 38))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_affine_warp_is_the_axis_aligned_warp():
    img = np.random.RandomState(1).rand(30, 40, 3).astype(np.float32)
    m = pg.get_affine_params((20.5, 14.0), (31.0, 22.0), (48, 64))
    got = pg.affine_warp(tt(img), m, (48, 64))
    want = pg.affine_warp_axis_aligned(tt(img), m, (48, 64))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("center,size,dst", [((100.5, 80.0), (64, 120),
                                              (473, 473)),
                                             ((3, 7), (10.5, 4), (48, 96))])
def test_get_affine_params_matches_jax(center, size, dst, inv):
    got = pg.get_affine_params(center, size, dst, inv=inv)
    want = jg.get_affine_params(center, size, dst, inv=inv)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    fwd = pg.get_affine_params(center, size, dst).astype(np.float64)
    bwd = pg.get_affine_params(center, size, dst, inv=True).astype(
        np.float64)
    both = np.vstack([fwd, [0, 0, 1]]) @ np.vstack([bwd, [0, 0, 1]])
    np.testing.assert_allclose(both, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("box", [(3, 5, 20, 31), (0, 0, 24, 32),
                                 (10, 0, 11, 32), None])
@pytest.mark.parametrize("channels", [0, 3])
def test_black_border_helpers_match_jax(box, channels):
    shape = (24, 32) + ((channels,) if channels else ())
    img = np.zeros(shape, np.uint8)
    if box is not None:
        t, left, b, r = box
        img[t:b, left:r] = np.random.RandomState(0).randint(
            1, 255, (b - t, r - left) + shape[2:])
    got, loc = pg.remove_blackborder(img)
    want, wloc = jg.remove_blackborder(img)
    assert loc == wloc
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pg.remove_blackborder(img, loc),
                                  jg.remove_blackborder(img, loc))
    back = pg.add_blackborder(got, img.shape[:2], loc)
    np.testing.assert_array_equal(back, jg.add_blackborder(want,
                                                           img.shape[:2],
                                                           wloc))
    np.testing.assert_array_equal(back, img)
