"""The port's compositing helpers that no pipeline calls (`composite_fgbg`,
`get_mask`, `get_fgbox`, `get_fg_naive`, `get_fg_with_colorremove`) and
`utils/visualize.py` against the JAX package on the CPU, with the cases of
tests/test_compositing.py and tests/test_visualize.py.

Tolerances: float outputs to 1e-5 of their scale (the same float32
expressions), masks, boxes and every uint8 image exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import assert_close, assert_equal, tt
from video_unscreen_tpu.ops import compositing as jc
from video_unscreen_tpu.utils import visualize as jv
from video_unscreen_tpu_torch.ops import compositing as tc
from video_unscreen_tpu_torch.utils import visualize as tv
from video_unscreen_tpu_torch.utils.fileio import read_png


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,extend", [((40, 60), False), ((40, 60), True),
                                          ((61, 37), False),
                                          ((61, 37), True)])
def test_composite_fgbg_matches_jax(shape, extend):
    rng = np.random.RandomState(shape[0])
    fg = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    bg = rng.randint(0, 256, (30, 50, 3)).astype(np.float32)
    alpha = (rng.rand(*shape) * 255).astype(np.float32)
    want = jc.composite_fgbg(*_j(fg, alpha, bg), extend)
    got = tc.composite_fgbg(tt(fg), tt(alpha), tt(bg), extend)
    assert_close(got, want, 1e-5, "composite_fgbg")
    if not extend:  # tests/test_compositing.py: pure fg where alpha > 0.9
        hard = alpha / 255.0 > 0.9
        np.testing.assert_allclose(got.numpy()[hard], fg[hard], atol=1e-3)


def test_get_mask_and_fgbox_match_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.float32)
    img[rng.rand(24, 32) < 0.5] = 10.0
    for g, w in zip(tc.get_mask(tt(img)), jc.get_mask(jnp.asarray(img))):
        assert_equal(g, w, "get_mask")
    for m in (np.zeros((20, 30), np.float32), img[..., 0] > 200,
              np.pad(np.ones((2, 3), np.float32), ((4, 14), (25, 2)))):
        m = np.asarray(m, np.float32)
        got = [int(v) for v in tc.get_fgbox(tt(m))]
        want = [int(v) for v in jc.get_fgbox(jnp.asarray(m))]
        assert got == want


def test_fg_naive_and_colorremove_match_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (16, 24, 3)).astype(np.float32)
    img[:8] = (40, 200, 60)
    alpha = rng.randint(0, 256, (16, 24)).astype(np.float32)
    bg = np.tile(np.array([40, 200, 60], np.float32), (16, 24, 1))
    assert_close(tc.get_fg_naive(tt(img), tt(alpha)),
                 jc.get_fg_naive(*_j(img, alpha)), 1e-5, "get_fg_naive")
    assert_close(tc.get_fg_with_colorremove(tt(img), tt(alpha), tt(bg)),
                 jc.get_fg_with_colorremove(*_j(img, alpha, bg)), 1e-5,
                 "get_fg_with_colorremove")


def test_visualize_blends_match_jax():
    rng = np.random.RandomState(2)
    fg = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    bg = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    mask = rng.randint(0, 256, (12, 16)).astype(np.uint8)
    mask[:3] = 0
    assert_equal(tv.fuse_fgbg(fg, bg, mask), jv.fuse_fgbg(fg, bg, mask))
    assert_equal(tv.get_roi(fg, mask), jv.get_roi(fg, mask))
    assert_equal(tv.highlight_roi(fg, mask), jv.highlight_roi(fg, mask))
    assert_equal(tv.tocolor(mask), jv.tocolor(mask))
    assert_equal(tv.tocolor(fg), fg)
    # tests/test_visualize.py's endpoints
    out = tv.highlight_roi(np.full((2, 2, 3), 60, np.uint8),
                           np.array([[255, 0], [0, 0]], np.uint8))
    assert out[0, 0, 2] == np.uint8(0.5 * 60 + 0.5 * 255)
    assert out[0, 1, 2] == 60 and (out[..., :2] == 60).all()


def test_show_headless_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (30, 44, 3)).astype(np.uint8)
    for d in (1, 2, 3):
        got = tv.show(img, d, fallback_path=str(tmp_path / f"t{d}.png"))
        want = jv.show(img, d, fallback_path=str(tmp_path / f"j{d}.png"))
        import cv2
        assert_equal(read_png(got), cv2.imread(want, cv2.IMREAD_UNCHANGED))
    samples = np.concatenate([np.zeros(50), np.ones(50) * 0.95,
                              rng.rand(40)])
    got = tv.show_dist_hist(samples, num_hist=10,
                            fallback_path=str(tmp_path / "h.png"))
    want = jv.show_dist_hist(samples, num_hist=10,
                             fallback_path=str(tmp_path / "hj.png"))
    assert_equal(got, want)
    assert_equal(read_png(str(tmp_path / "h.png")), got)


def test_show_refuses_a_display(monkeypatch, tmp_path):
    monkeypatch.setenv("DISPLAY", ":0")
    with pytest.raises(RuntimeError, match="no window"):
        tv.show(np.zeros((4, 4), np.uint8),
                fallback_path=str(tmp_path / "x.png"))
