"""Color and geometry ops of the port against the JAX package, to about
1e-5 relative (float32 arithmetic in another order: XLA fuses and may
contract to FMA, torch does not)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, assert_equal, compare, tt
from video_unscreen_tpu.ops import color as jcolor
from video_unscreen_tpu.ops import geometry as jgeo
from video_unscreen_tpu_torch.ops import color as tcolor
from video_unscreen_tpu_torch.ops import geometry as tgeo


def _img(h, w, seed, c=3):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (h, w, c)).astype(np.float32)
    # exact ties and greys exercise the hue branch order and c == 0
    img[0, :, :] = 128.0
    img[1, :, 1] = img[1, :, 2]
    img[2, :, 0] = 0.0
    return img


@pytest.mark.parametrize("fn", ["bgr2hsv", "bgr2lab"])
def test_color_forward(fn):
    compare(getattr(jcolor, fn), getattr(tcolor, fn), _img(24, 40, 1),
            what=fn)


def test_hsv_round_trip():
    hsv = np.asarray(jcolor.bgr2hsv(jnp.asarray(_img(24, 40, 2))))
    compare(jcolor.hsv2bgr, tcolor.hsv2bgr, hsv, what="hsv2bgr")


@pytest.mark.parametrize("h,w,ls,div", [(96, 128, 128, 32), (1080, 1920, 960, 32),
                                        (1920, 1080, 960, 32), (97, 131, 64, 1)])
def test_get_target_size(h, w, ls, div):
    assert tgeo.get_target_size(h, w, ls, div) == \
        jgeo.get_target_size(h, w, ls, div)


@pytest.mark.parametrize("src,dst,method", [
    ((96, 128), (48, 64), "linear"),
    ((108, 192), (54, 96), "linear"),    # the 1080p -> 544x960 ratio, scaled
    ((40, 50), (97, 31), "linear"),
    ((96, 128), (48, 64), "nearest"),
    ((48, 64), (96, 128), "nearest"),
    ((37, 61), (18, 30), "nearest"),
])
def test_resize(src, dst, method):
    for c in (None, 3):
        img = _img(*src, seed=3)
        img = img[..., 0] if c is None else img
        jfn = lambda a: jgeo.resize(jnp.asarray(a), dst, method)  # noqa
        tfn = lambda a: tgeo.resize(a, dst, method)  # noqa
        compare(jfn, tfn, img, exact=(method == "nearest"),
                what=f"{method} {src}->{dst} c={c}")


@pytest.mark.parametrize("src,target", [((96, 128), (96, 128)),
                                        ((90, 128), (96, 128)),
                                        ((96, 120), (96, 128)),
                                        ((70, 100), (64, 96))])
def test_pad_resize_and_inverse(src, target):
    img = _img(*src, seed=4)
    compare(lambda a: jgeo.pad_resize(jnp.asarray(a), target),
            lambda a: tgeo.pad_resize(a, target), img, what="pad_resize")
    padded = np.asarray(jgeo.pad_resize(jnp.asarray(img), target))
    compare(lambda a: jgeo.inv_pad_resize(jnp.asarray(a), src),
            lambda a: tgeo.inv_pad_resize(a, src), padded,
            what="inv_pad_resize")


def test_symmetric_pad_repeats_the_edge():
    x = tt(np.arange(12, dtype=np.float32).reshape(3, 4))
    got = tgeo._pad_symmetric(x, 2, 3)
    want = np.pad(np.arange(12, dtype=np.float32).reshape(3, 4),
                  ((0, 2), (0, 3)), mode="symmetric")
    assert_equal(got, want)


def test_imnormalize():
    compare(jgeo.imnormalize, tgeo.imnormalize, _img(16, 24, 5),
            what="imnormalize")
    assert_close(tgeo.imnormalize(tt(_img(4, 4, 6))),
                 jgeo.imnormalize(jnp.asarray(_img(4, 4, 6))))
