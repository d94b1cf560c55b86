"""GMM banks, the color-filtering agent and the compositing ops of the port
against the JAX package, to about 1e-5 relative (sums over thousands of
samples in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_pipeline_green import make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, assert_equal, compare, tt
from video_unscreen_tpu.agents.colorfiltering import \
    ColorFilteringAgent as JCF
from video_unscreen_tpu.ops import compositing as jcomp
from video_unscreen_tpu.ops import gmm as jgmm
from video_unscreen_tpu_torch.agents.colorfiltering import \
    ColorFilteringAgent as TCF
from video_unscreen_tpu_torch.ops import compositing as tcomp
from video_unscreen_tpu_torch.ops import gmm as tgmm


def _bank(seed, m=3, k=5):
    rng = np.random.RandomState(seed)
    active = np.arange(k)[None, :] < rng.randint(2, k + 1, (m, 1))
    w = rng.rand(m, k).astype(np.float32) * active
    w /= w.sum(-1, keepdims=True)
    means = rng.uniform(0, 255, (m, k)).astype(np.float32)
    var = rng.uniform(20, 400, (m, k)).astype(np.float32)
    return active, (w, means, var)


def test_gmm_init():
    active = np.arange(10)[None, :] < np.array([[3], [5], [10]])
    j = jgmm.gmm_init(3, 10, jnp.asarray(active))
    t = tgmm.gmm_init(3, 10, tt(active))
    for a, b, name in zip(t, j, j._fields):
        assert_close(a, b, 1e-6, name)


def _cold_start_cases():
    """The samples of `tests/test_gmm.py`'s three cold-started fits: two
    clusters with 2 of 4 components live, 500 samples padded with 500
    zero-weight zeros, and six models of 3 and 10 components."""
    rng = np.random.RandomState(0)
    two = np.concatenate([rng.randn(600) * 5 + 50,
                          rng.randn(400) * 8 + 180])[None]
    act2 = np.zeros((1, 4), bool)
    act2[0, :2] = True
    padded = np.concatenate([rng.randn(500) + 100, np.zeros(500)])[None]
    pad_w = np.concatenate([np.ones(500), np.zeros(500)])[None]
    centers = np.linspace(40, 220, 6)
    six = np.stack([rng.randn(1000) * 6 + c for c in centers])
    act6 = np.zeros((6, 10), bool)
    act6[:3, :3] = True
    act6[3:] = True
    return {"two_clusters": (two, np.ones_like(two), act2),
            "padding": (padded, pad_w, np.ones((1, 2), bool)),
            "six_models": (six, np.ones_like(six), act6)}


@pytest.mark.parametrize("case", list(_cold_start_cases()))
def test_gmm_cold_start(case):
    """`gmm_cold_start` then 25 EM iterations against JAX's on the same
    samples: the quantile means equal, the fits to 1e-5."""
    x, w, active = _cold_start_cases()[case]
    x, w = x.astype(np.float32), w.astype(np.float32)
    m, k = active.shape
    jp = jgmm.gmm_cold_start(jnp.asarray(x), jnp.asarray(w),
                             jgmm.gmm_init(m, k, jnp.asarray(active)),
                             jnp.asarray(active))
    tp = tgmm.gmm_cold_start(tt(x), tt(w), tgmm.gmm_init(m, k, tt(active)),
                             tt(active))
    for a, b, name in zip(tp, jp, jp._fields):
        assert_equal(a, b, f"cold start {name}")
    jfit = jgmm.gmm_fit_em(jnp.asarray(x), jnp.asarray(w), jp,
                           jnp.asarray(active), iters=25)
    tfit = tgmm.gmm_fit_em(tt(x), tt(w), tp, tt(active), iters=25)
    for a, b, name in zip(tfit, jfit, jfit._fields):
        assert_close(a, b, 1e-5, f"fit {name}")


def test_gmm_pdf():
    _, params = _bank(0)
    x = np.random.RandomState(1).uniform(0, 255, (3, 500)).astype(np.float32)
    compare(lambda *a: jgmm.gmm_pdf(jgmm.GMMParams(*a[:3]), a[3]),
            lambda *a: tgmm.gmm_pdf(tgmm.GMMParams(*a[:3]), a[3]),
            *params, x, what="pdf")


@pytest.mark.parametrize("iters", [1, 12])
def test_gmm_fit_em(iters):
    active, params = _bank(2)
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.normal(60, 8, (3, 3000)),
                        rng.normal(180, 15, (3, 2000))], 1).astype(np.float32)
    sw = (rng.rand(3, 5000) > 0.3).astype(np.float32)
    want = jgmm.gmm_fit_em(jnp.asarray(x), jnp.asarray(sw),
                           jgmm.GMMParams(*map(jnp.asarray, params)),
                           jnp.asarray(active), iters)
    got = tgmm.gmm_fit_em(tt(x), tt(sw), tgmm.GMMParams(*map(tt, params)),
                          tt(active), iters)
    for a, b, name in zip(got, want, want._fields):
        assert_close(a, b, 1e-5, name)


@pytest.fixture(scope="module")
def cf_case():
    frames, gts = make_clip(n=2)
    img = frames[1].astype(np.float32)
    mask = (gts[0] >= 128).astype(np.float32) * 255
    kw = dict(input_long_side=128, bg_ncomp=(3, 5, 5), fg_ncomp=(10, 10, 10))
    jagent, tagent = JCF(**kw), TCF(**kw, device="cpu")
    jst = jagent.reset_gmms()
    jfit = jagent.device_forward_impl(jnp.asarray(img), jnp.asarray(mask), 2,
                                      jst)
    jpred = jagent.device_forward_impl(jnp.asarray(img), jnp.asarray(mask), 0,
                                       jfit[3])
    return img, mask, tagent, jfit, jpred


def _check_cf(got, want):
    alpha, bg_color, conf, state = got
    assert_close(alpha, want[0], 1e-5, "alpha")
    assert_close(bg_color, want[1], 1e-5, "bg_color")
    assert_close(conf, want[2], 1e-5, "confidence")
    for part in ("bg", "fg"):
        for a, b, name in zip(getattr(state, part), getattr(want[3], part),
                              ("weights", "means", "variances")):
            assert_close(a, b, 1e-5, f"{part}.{name}")
    assert bool(state.trained) == bool(want[3].trained)


def test_color_filter_fit(cf_case):
    img, mask, tagent, jfit, _ = cf_case
    got = tagent.device_forward_impl(tt(img), tt(mask), 2,
                                     tagent.reset_gmms())
    _check_cf(got, jfit)


def test_color_filter_predict(cf_case):
    img, mask, tagent, jfit, jpred = cf_case
    from video_unscreen_tpu_torch.agents.colorfiltering import CFState
    from video_unscreen_tpu_torch.ops.gmm import GMMParams
    st = jfit[3]
    state = CFState(GMMParams(*map(tt, st.bg)), GMMParams(*map(tt, st.fg)),
                    tt(np.asarray(st.trained)))
    _check_cf(tagent.device_forward_impl(tt(img), tt(mask), 0, state), jpred)


def test_color_filter_degenerate_mask(cf_case):
    img, _, tagent, _, _ = cf_case
    empty = np.zeros(img.shape[:2], np.float32)
    jagent = JCF(input_long_side=128)
    want = jagent.device_forward_impl(jnp.asarray(img), jnp.asarray(empty),
                                      2, jagent.reset_gmms())
    got = tagent.device_forward_impl(tt(img), tt(empty), 2,
                                     tagent.reset_gmms())
    _check_cf(got, want)
    assert float(got[1].abs().max()) == 0.0  # no fg: black bg color


def _frame(seed):
    frames, gts = make_clip(n=1, seed=seed)
    return frames[0].astype(np.float32), gts[0].astype(np.float32)


@pytest.mark.parametrize("winsize", [(10, 100, 180), (20, 20, 120)])
def test_is_pixel_inrange(winsize):
    img, _ = _frame(0)
    for bg in (np.array([40, 190, 50], np.float32), img[::-1].copy()):
        compare(lambda a, b: jcomp.is_pixel_inrange(a, b, winsize),
                lambda a, b: tcomp.is_pixel_inrange(a, b, winsize), img, bg,
                exact=True, what="inrange")


def test_get_fg():
    img, gt = _frame(1)
    alpha = gt * np.random.RandomState(2).uniform(0.3, 1, gt.shape)
    bg = np.broadcast_to(np.array([40, 190, 50], np.float32), img.shape)
    compare(jcomp.get_fg, tcomp.get_fg, img, alpha.astype(np.float32),
            np.ascontiguousarray(bg), what="get_fg")


@pytest.mark.parametrize("long_side", [128, 64])
def test_color_correct(long_side):
    img, gt = _frame(3)
    rng = np.random.RandomState(4)
    alpha = (gt * rng.uniform(0.5, 1.0, gt.shape)).astype(np.float32)
    bg = np.array([41, 189, 52], np.float32)
    compare(lambda a, b, c: jcomp.color_correct(a, b, c, long_side),
            lambda a, b, c: tcomp.color_correct(a, b, c, long_side),
            img, alpha, bg, what="color_correct")


def test_color_correct_empty_alpha():
    img, _ = _frame(5)
    zero = np.zeros(img.shape[:2], np.float32)
    bg = np.array([41, 189, 52], np.float32)
    assert_equal(tcomp.color_correct(tt(img), tt(zero), tt(bg), 64),
                 jcomp.color_correct(jnp.asarray(img), jnp.asarray(zero),
                                     jnp.asarray(bg), 64))


def test_exist_foreground():
    _, gt = _frame(0)
    for thr in (0.001, 0.2):
        assert bool(tcomp.exist_foreground(tt(gt), thr)) == \
            bool(jcomp.exist_foreground(jnp.asarray(gt), thr))
