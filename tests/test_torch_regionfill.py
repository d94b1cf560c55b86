"""The port's CG regionfill against the JAX package's on seeded images and
holes: cold and warm starts, factor 1.0 and 0.5, an empty hole, and three
channels solved as one batch. Filled values are held to max |diff| <= 1e-2
on the 0..255 scale.

`jax.scipy.sparse.linalg.cg` does not report its iteration count, so the
count is taken from a copy of its loop (`_jax_cg`, the recurrence of
`jax._src.scipy.sparse.linalg._cg_solve` with a counter) on the JAX
package's own operator; the test first shows that the copy returns the
JAX solver's result, then that the port stops on the same iteration."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import nn_, tt

jrf = importlib.import_module("video_unscreen_tpu.ops.regionfill")
from video_unscreen_tpu.ops.morphology import (_morph, _se_offsets,  # noqa
                                               cross_kernel)
from video_unscreen_tpu_torch.ops import regionfill as trf  # noqa: E402

H, W = 96, 128


def _image(seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (np.sin(yy / (5.0 + seed)) * 60 + np.cos(xx / 9.0) * 50 + 120
           + rng.randn(H, W) * 8)
    return img.clip(0, 255).astype(np.float32)


def _hole(seed):
    rng = np.random.RandomState(100 + seed)
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = rng.randint(20, H - 20), rng.randint(25, W - 25)
    m = ((yy - cy) / rng.uniform(10, 30)) ** 2 + \
        ((xx - cx) / rng.uniform(10, 35)) ** 2 < 1
    m |= rng.rand(H, W) < 0.01                     # isolated hole pixels
    m[:3, :] |= rng.rand(3, W) < 0.5               # holes on the border
    return np.where(m, 255.0, 0.0).astype(np.float32)


def _jax_cg(img, hole, x0, tol, maxiter):
    """`jrf._fill_core`'s system solved by a copy of JAX's CG loop, with
    its iteration count."""
    hole = jnp.asarray(hole)
    dilated = _morph(hole.astype(jnp.float32), _se_offsets(cross_kernel(3)),
                     1, True)
    perimeter = (dilated > 0) & ~hole
    b = jnp.where(hole, jrf._neighbor_sum(jnp.where(perimeter, img, 0.0)),
                  0.0)
    nn = jnp.asarray(jrf._num_neighbors(*img.shape))

    def matvec(x):
        x_in = jnp.where(hole, x, 0.0)
        return jnp.where(hole, nn * x_in - jrf._neighbor_sum(x_in), x)

    def vdot(u, v):
        return jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST)

    x0 = jnp.zeros_like(img) if x0 is None else jnp.where(hole, x0, 0.0)
    atol2 = jnp.maximum(jnp.square(tol) * vdot(b, b), 0.0)

    def cond(val):
        _, _, gamma, _, k = val
        return (gamma > atol2) & (k < maxiter)

    def body(val):
        x, r, gamma, p, k = val
        ap = matvec(p)
        alpha = gamma / vdot(p, ap)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        gamma_ = vdot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        return x_, r_, gamma_, p_, k + 1

    r0 = b - matvec(x0)
    x, _, _, _, k = jax.lax.while_loop(cond, body,
                                       (x0, r0, vdot(r0, r0), r0, 0))
    return jnp.where(hole, x, img), int(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_fill_core_iterations(seed, warm):
    img, hole = _image(seed), _hole(seed) > 0
    x0 = _image(seed + 7) if warm else None
    want = np.asarray(jrf._fill_core(
        jnp.asarray(img), jnp.asarray(hole), 400, 1e-5,
        None if x0 is None else jnp.asarray(x0)))
    copy, k_jax = _jax_cg(jnp.asarray(img), hole,
                          None if x0 is None else jnp.asarray(x0), 1e-5, 400)
    np.testing.assert_allclose(np.asarray(copy), want, atol=1e-3)
    got, k = trf._fill_core(tt(img)[None], torch.from_numpy(hole), 400,
                            1e-5, None if x0 is None else tt(x0)[None])
    assert int(k[0]) == k_jax, (int(k[0]), k_jax)
    assert 0 < k_jax < 400
    assert np.abs(nn_(got[0]) - want).max() <= 1e-2


@pytest.mark.parametrize("factor", [1.0, 0.5])
@pytest.mark.parametrize("warm", [False, True])
def test_regionfill_with_state(factor, warm):
    img, mask = _image(3), _hole(3)
    sh, sw = trf.solve_shape(H, W, factor)
    assert (sh, sw) == jrf.solve_shape(H, W, factor)
    x0 = _image(9)[:sh, :sw] if warm else None
    want, want_sol = jrf.regionfill_with_state(
        jnp.asarray(img), jnp.asarray(mask), factor, 400, 1e-5,
        None if x0 is None else jnp.asarray(x0))
    got, sol = trf.regionfill_with_state(tt(img), tt(mask), factor, 400,
                                         1e-5, None if x0 is None
                                         else tt(x0))
    assert got.shape == (H, W) and sol.shape == (sh, sw)
    assert np.abs(nn_(got) - np.asarray(want)).max() <= 1e-2
    assert np.abs(nn_(sol) - np.asarray(want_sol)).max() <= 1e-2
    keep = mask == 0
    np.testing.assert_array_equal(nn_(got)[keep], img[keep])


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_regionfill_channels_and_empty_hole(factor):
    imgs = np.stack([_image(s) for s in (4, 5, 6)])
    mask = _hole(4)
    want = np.stack([np.asarray(jrf.regionfill(
        jnp.asarray(c), jnp.asarray(mask), factor)) for c in imgs])
    got = trf.regionfill(tt(imgs), tt(mask), factor)
    assert np.abs(nn_(got) - want).max() <= 1e-2
    empty = np.zeros((H, W), np.float32)
    np.testing.assert_array_equal(
        nn_(trf.regionfill(tt(imgs[0]), tt(empty), factor)), imgs[0])
    np.testing.assert_array_equal(
        np.asarray(jrf.regionfill(jnp.asarray(imgs[0]), jnp.asarray(empty),
                                  factor)), imgs[0])


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_regionfill_solve_holes_per_channel(factor):
    """The fused bg pipeline's batch: S x 3 channels, each segment with
    its own hole and warm start, in one `regionfill_solve`; each channel
    against its own JAX solve (`regionfill_with_state`), and each stops on
    the iteration its own copy of JAX's loop stops."""
    imgs = np.stack([_image(s) for s in (0, 1, 2, 3)])
    masks = np.stack([_hole(s) for s in (0, 0, 1, 2)])   # 0 shared twice
    sh, sw = trf.solve_shape(H, W, factor)
    x0 = np.stack([_image(s + 7)[:sh, :sw] for s in range(4)])
    got, sol, iters = trf.regionfill_solve(tt(imgs), tt(masks), factor, 400,
                                           1e-5, tt(x0))
    for c in range(4):
        want, want_sol = jrf.regionfill_with_state(
            jnp.asarray(imgs[c]), jnp.asarray(masks[c]), factor, 400, 1e-5,
            jnp.asarray(x0[c]))
        assert np.abs(nn_(got[c]) - np.asarray(want)).max() <= 1e-2
        assert np.abs(nn_(sol[c]) - np.asarray(want_sol)).max() <= 1e-2
        if factor == 1.0:
            _, k_jax = _jax_cg(jnp.asarray(imgs[c]), masks[c] > 0,
                               jnp.asarray(x0[c]), 1e-5, 400)
            assert int(iters[c]) == k_jax, (c, int(iters[c]), k_jax)
    assert len(set(iters.tolist())) > 1   # the channels stop apart
    assert trf.cg_syncs(iters) == -(-int(iters.max()) // 16)
