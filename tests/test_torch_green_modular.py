"""The port's modular green driver (`pipeline/green.py:run`) against the
JAX `pipeline/green.py:run` on the CPU, float32, on the JAX suite's
synthetic clip (`make_clip(n=4)`, chroma seed): alphas within the JAX
suite's bound (max |diff| <= 4, |diff| > 1 on under 0.1% of pixels,
tests/test_fused_green.py) and equal tracking counts; then `save=True`
writes `alphamask_` (gray), `fg_` and `bg_*.jpg` for every frame; and the
color filter's host API (`ColorFilteringAgent.forward`, `is_trained`)
against the JAX agent's on a refit and a predict."""
import glob
import os

import cv2
import numpy as np
import pytest

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu.agents.colorfiltering import \
    ColorFilteringAgent as JCF
from video_unscreen_tpu.pipeline import green as jgreen
from video_unscreen_tpu_torch.agents.colorfiltering import \
    ColorFilteringAgent as TCF
from video_unscreen_tpu_torch.pipeline import green as tgreen

N = 4


def _within_bound(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


@pytest.fixture(scope="module")
def runs():
    frames, _ = make_clip(n=N)
    want = jgreen.run(TEST_CFG, frames, save=False)
    got = tgreen.run(TEST_CFG, frames, save=False, device="cpu")
    return want, got


def test_alphas_against_jax(runs):
    want, got = runs
    assert got["numframes"] == want["numframes"] == N
    for i, (g, w) in enumerate(zip(got["alphas"], want["alphas"])):
        _within_bound(g, w, f"alpha {i}")
    assert (got["alphas"][0] >= 128).any()


def test_tracking_and_runtime(runs):
    want, got = runs
    assert got["tracking_count"] == want["tracking_count"] == N - 1
    assert set(got["runtime"]) == set(want["runtime"])


def test_save_writes_artifacts(tmp_path):
    frames, _ = make_clip(n=2)
    cfg = dict(TEST_CFG, data={"dst_img_dir": str(tmp_path)})
    out = tgreen.run(cfg, frames, save=True, device="cpu")
    for kind in ("alphamask", "fg", "bg"):
        paths = sorted(glob.glob(os.path.join(tmp_path, f"{kind}_*.jpg")))
        assert len(paths) == 2, kind
    mask = cv2.imread(str(tmp_path / "alphamask_000001.jpg"),
                      cv2.IMREAD_UNCHANGED)
    assert mask.shape == frames[0].shape[:2]
    assert np.abs(mask.astype(int) - out["alphas"][1].astype(int)
                  ).mean() < 8.0


def test_color_filter_host_api_against_jax():
    frames, gts = make_clip(n=2)
    kw = {k: v for k, v in TEST_CFG["colorfiltering"].items()}
    jcf, tcf = JCF(**kw), TCF(**kw, device="cpu")
    assert not tcf.is_trained() and not jcf.is_trained()
    for frame, iters in ((frames[0], 2), (frames[1], 0)):
        ja, jb, _ = jcf.forward(frame, gts[0], iters=iters)
        ta, tb, _ = tcf.forward(frame, gts[0], iters=iters)
        _within_bound(ta.numpy(), ja, f"alpha, {iters} iterations")
        np.testing.assert_array_equal(tb.numpy(), jb)
        assert tcf.is_trained() == jcf.is_trained()
    assert tcf.is_trained()
    # too few foreground pixels: the mask passes through unfiltered
    empty = np.zeros_like(gts[0])
    ta, tb, conf = tcf.forward(frames[0], empty)
    np.testing.assert_array_equal(ta.numpy(), empty)
    np.testing.assert_array_equal(tb.numpy(), frames[0])
    assert conf == 1.0
