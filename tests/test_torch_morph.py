"""Morphology, trimap and chroma seed of the port against the JAX package.

The plain versions of kernels K1 and K2 (what a CPU tensor runs) must be
bit-exact: max/min and selects do no rounding. The trimap is held against
the Pallas kernel itself, run in interpret mode off-TPU."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import assert_close, assert_equal, soft_mask, tt
from video_unscreen_tpu.ops import morphology as jmorph
from video_unscreen_tpu.ops.chroma import chroma_segment as jchroma
from video_unscreen_tpu.ops.pallas.morph import pallas_trimap
from video_unscreen_tpu.ops.trimap import generate_trimap as jtrimap
from video_unscreen_tpu.ops.trimap import \
    generate_trimap_withbg as jtrimap_bg
from video_unscreen_tpu_torch.ops import morphology as tmorph
from video_unscreen_tpu_torch.ops.chroma import chroma_segment as tchroma
from video_unscreen_tpu_torch.ops.kernels import morph as kmorph
from video_unscreen_tpu_torch.ops.trimap import generate_trimap as ttrimap
from video_unscreen_tpu_torch.ops.trimap import \
    generate_trimap_withbg as ttrimap_bg


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7])
def test_se_offsets(k):
    np.testing.assert_array_equal(tmorph.ellipse_kernel(k),
                                  jmorph.ellipse_kernel(k))
    assert tmorph.ellipse_offsets(k) == \
        jmorph._se_offsets(jmorph.ellipse_kernel(k))


@pytest.mark.parametrize("k,iters", [(3, 2), (3, 5), (4, 2), (5, 1),
                                     (3, 20)])
@pytest.mark.parametrize("is_dilate", [True, False])
def test_dilate_erode_bit_exact(k, iters, is_dilate):
    a = soft_mask(37, 150, seed=k + iters)
    want = jmorph._morph(jnp.asarray(a), jmorph._se_offsets(
        jmorph.ellipse_kernel(k)), iters, is_dilate)
    fn = tmorph.dilate if is_dilate else tmorph.erode
    assert_equal(fn(tt(a), k, iters), want)


def test_plain_version_counts_no_launch():
    def seen():
        return [(c.calls, c.launches) for c in (kmorph.MORPH,
                                                kmorph.TRIMAP)]
    before = seen()
    tmorph.dilate(tt(soft_mask(16, 16)), 3, 2)
    ttrimap(tt(soft_mask(16, 16)), 3, 2)
    assert seen() == before


@pytest.mark.parametrize("shape,seed", [((40, 130), 7), ((33, 57), 8)])
def test_trimap_matches_pallas_kernel(shape, seed):
    a = soft_mask(*shape, seed=seed)
    want = pallas_trimap(jnp.asarray(a), 3, 5)
    assert_equal(ttrimap(tt(a), 3, 5), want)


@pytest.mark.parametrize("k,iters", [(3, 5), (4, 2)])
def test_batched_plain_versions_match_jax(k, iters):
    """morph_plain and trimap_plain on a (3, H, W) batch of different masks
    (soft, the 1-pixel edge lines, a checkerboard): each item as the JAX
    `_morph` (both directions) and the Pallas trimap (interpreted) give
    it alone."""
    from video_unscreen_tpu_torch.ops.kernels.morph_cases import \
        morph_hard_mask
    h, w = 19, 45
    items = [soft_mask(h, w, seed=k), morph_hard_mask("edges", h, w),
             morph_hard_mask("checkerboard", h, w)]
    x = tt(np.stack(items))
    offs = tmorph.ellipse_offsets(k)
    jax_offs = jmorph._se_offsets(jmorph.ellipse_kernel(k))
    for dil in (True, False):
        got = kmorph.morph_plain(x, offs, iters, dil)
        assert got.shape == x.shape
        for i, a in enumerate(items):
            assert_equal(got[i], jmorph._morph(jnp.asarray(a), jax_offs,
                                               iters, dil), f"item {i}")
    got = kmorph.trimap_plain(x, offs, iters)
    for i, a in enumerate(items):
        assert_equal(got[i], pallas_trimap(jnp.asarray(a), k, iters),
                     f"trimap item {i}")


def test_trimap_border_semantics():
    """A mask touching every border: the erosion sees +inf outside the
    image, so the border does not erode."""
    a = np.full((16, 40), 255.0, np.float32)
    assert_equal(ttrimap(tt(a), 3, 5),
                 jtrimap(jnp.asarray(a), 3, 5, use_pallas=False))
    assert float(ttrimap(tt(a), 3, 5).min()) == 255.0


def _frame_and_mask(seed):
    rng = np.random.RandomState(seed)
    h, w = 48, 64
    img = np.empty((h, w, 3), np.float32)
    img[...] = (40, 190, 50)
    mask = soft_mask(h, w, seed) > 100
    img[mask] = (150, 60, 170)
    # a rim of screen-colored pixels inside the mask makes them "fuzzy"
    img[mask & (rng.rand(h, w) < 0.05)] = (42, 188, 52)
    img += rng.randn(h, w, 3).astype(np.float32) * 3
    return img.clip(0, 255), mask.astype(np.float32) * 255.0


@pytest.mark.parametrize("seed", [0, 1])
def test_trimap_withbg(seed):
    img, mask = _frame_and_mask(seed)
    bg = np.array([40, 190, 50], np.float32)
    want = jtrimap_bg(jnp.asarray(mask), jnp.asarray(img), jnp.asarray(bg),
                      3, 3, (10, 100, 180))
    got = ttrimap_bg(tt(mask), tt(img), tt(bg), 3, 3, (10, 100, 180))
    assert_equal(got, want)
    empty = np.zeros_like(mask)
    assert_equal(ttrimap_bg(tt(empty), tt(img), tt(bg), 3, 3),
                 jtrimap_bg(jnp.asarray(empty), jnp.asarray(img),
                            jnp.asarray(bg), 3, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_chroma_segment(seed):
    img, _ = _frame_and_mask(seed)
    jmask, jhsv = jchroma(jnp.asarray(img))
    tmask, thsv = tchroma(tt(img))
    assert_close(thsv, jhsv, what="screen color")
    assert_equal(tmask, jmask, "mask")
