"""Connected components and object removal of the port against the JAX
package: labels bit-exact against `connected_components`, dense ids
bit-exact against the Pallas `connected_components_compact` (interpret
mode off-TPU), keep-masks of `remove_invalid_objects_ds` bit-exact, also
on the masks that break label schemes (`ops/kernels/cc_masks.py`). The
masks converge within the JAX flood's 64 sweeps."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_equal, blob_mask, tt
from video_unscreen_tpu.ops import connected as jcc
from video_unscreen_tpu.ops.pallas.flood import \
    connected_components_compact as pallas_cc
from video_unscreen_tpu_torch.ops import connected as tcc
from video_unscreen_tpu_torch.ops.kernels import connected as kcc
from video_unscreen_tpu_torch.ops.kernels.cc_masks import hard_mask


def _random_mask(h, w, seed, p):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w) < p).astype(np.float32) * 255.0


@pytest.mark.parametrize("seed,p", [(0, 0.3), (1, 0.45), (2, 0.05),
                                    (3, 0.6)])
def test_labels_bit_exact(seed, p):
    m = _random_mask(24, 136, seed, p)
    assert_equal(tcc.connected_components(tt(m)),
                 jcc.connected_components(jnp.asarray(m)))


@pytest.mark.parametrize("seed,p", [(0, 0.3), (4, 0.45)])
def test_compact_ids_match_pallas_kernel(seed, p):
    m = _random_mask(24, 136, seed, p)
    # the Pallas labels number pixels on its 128-lane padded grid; its
    # dense ids do not depend on the padding
    _, cid = pallas_cc(jnp.asarray(m))
    got_lbl, got_cid = kcc.connected_components_compact(tt(m))
    assert_equal(got_cid, cid, "compact")
    assert_equal(got_lbl, jcc.connected_components(jnp.asarray(m)), "labels")


def test_spiral_needs_many_steps():
    """A one-pixel-wide spiral: the longest path in the component is
    hundreds of pixels, so the plain version iterates past many
    convergence checks."""
    h = w = 31
    m = np.zeros((h, w), np.float32)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = 255
        m[top:bottom + 1, right] = 255
        m[bottom, left:right + 1] = 255
        m[top + 2:bottom + 1, left] = 255
        if top + 2 <= bottom:
            m[top + 2, left:right - 1] = 255
        top, left, bottom, right = top + 4, left + 2, bottom - 2, right - 2
        left += 2
    assert_equal(tcc.connected_components(tt(m)),
                 jcc.connected_components(jnp.asarray(m)))


def test_empty_and_full():
    for m in (np.zeros((16, 40), np.float32),
              np.full((16, 40), 255.0, np.float32)):
        lbl, cid = kcc.connected_components_compact(tt(m))
        assert int(cid.max()) == (0 if m.max() == 0 else 1)
        assert int(lbl.max()) == (0 if m.max() == 0 else m.size)


@pytest.mark.parametrize("name,h,w", [
    ("checkerboard", 40, 70),   # only diagonal contacts
    ("snake", 90, 140),         # one pixel wide, crosses every tile edge
    ("random", 1, 1000), ("random", 1000, 1), ("random", 33, 70),
    ("full", 40, 70), ("empty", 40, 70),
])
def test_hard_masks_match_jax(name, h, w):
    """cc_plain, the K3 wrapper (its plain version on the CPU) and the
    port's `connected_components` against the JAX labels and the Pallas
    kernel's dense ids, on the hard masks and odd shapes."""
    if name == "random":
        m = _random_mask(h, w, h + w, 0.5)
    else:
        m = hard_mask(name, h, w)
    want_lbl = jcc.connected_components(jnp.asarray(m))
    _, want_cid = pallas_cc(jnp.asarray(m))
    for got in (kcc.cc_plain(tt(m)), kcc.connected_components_compact(tt(m))):
        assert_equal(got[0], want_lbl, "labels")
        assert_equal(got[1], want_cid, "compact")
    assert_equal(tcc.connected_components(tt(m)), want_lbl, "labels")
    n = int(np.asarray(want_cid).max())
    want_n = {"checkerboard": (h * w + 1) // 2, "snake": 1, "full": 1,
              "empty": 0}.get(name, n)
    assert n == want_n


@pytest.mark.parametrize("h,w,center", [(96, 128, (0.5, 0.5)),
                                        (128, 96, (0.6, 0.5)),
                                        (33, 47, (0.3, 0.7))])
def test_score_map(h, w, center):
    np.testing.assert_array_equal(tcc.score_map(h, w, center),
                                  jcc.score_map(h, w, center))


@pytest.mark.parametrize("speckle,downscale", [(0.0, 2), (0.01, 2),
                                               (0.05, 2), (0.02, 1)])
def test_remove_invalid_objects_ds_keep_masks(speckle, downscale):
    rng = np.random.RandomState(5)
    h, w = 96, 128
    alpha = blob_mask(h, w, seed=6, speckle=speckle)
    alpha *= rng.uniform(0.5, 1.0, (h, w)).astype(np.float32)
    seg = alpha * (rng.rand(h, w) > 0.1)
    score = jcc.score_map(h, w)
    want = jcc.remove_invalid_objects_ds(
        jnp.asarray(alpha), jnp.asarray(seg), jnp.asarray(score), 0.005, 0.5,
        100, downscale)
    got = tcc.remove_invalid_objects_ds(tt(alpha), tt(seg), tt(score), 0.005,
                                        0.5, 100, downscale)
    assert_equal(got, want)
    # something was kept and something was dropped
    if speckle:
        kept = np.asarray(want) > 0
        assert kept.any() and (kept != (alpha > 0)).any()
