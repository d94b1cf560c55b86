"""bg mode in the port against the JAX package on the CPU: its stages
(`get_bg`, `bgr2gray`, `TrimapAgent`, `ChromaSegAgent`, the config's object
removal, the per-frame background) and `pipeline/bg.py:run` end to end on
the JAX suite's synthetic clip with `tests/test_pipeline_bg.py:BG_TEST_CFG`.

Tolerances: integer and select outputs bit-exact; f32 maps 1e-5 of their
scale; the per-frame background (a CG solve, then a uint8 cast) within 1
level; uint8 alphas end to end within the JAX suite's own bound for
reassociated float math, max |diff| <= 4 and |diff| > 1 on < 0.1% of
pixels (tests/test_fused_green.py). The port also meets the JAX test's
quality bars: mIoU > 0.8 on frame 0 and > 0.75 on average."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_port_util import assert_close, assert_equal, nn_, tt
from video_unscreen_tpu.agents.binseg import ChromaSegAgent as JChroma
from video_unscreen_tpu.agents.trimap import TrimapAgent as JTrimap
from video_unscreen_tpu.ops import color as jcolor
from video_unscreen_tpu.ops import compositing as jcomp
from video_unscreen_tpu.ops import metrics as M
from video_unscreen_tpu.pipeline import bg as jbg
from video_unscreen_tpu.pipeline import common as jcommon
from video_unscreen_tpu.pipeline import run_bg
from video_unscreen_tpu_torch.agents.binseg import (ChromaSegAgent,
                                                    HumanSegAgent, SegAgent,
                                                    build_seg_agent)
from video_unscreen_tpu_torch.agents.stm import STMAgent
from video_unscreen_tpu_torch.agents.trimap import TrimapAgent
from video_unscreen_tpu_torch.ops import color, compositing
from video_unscreen_tpu_torch.pipeline import bg as tbg
from video_unscreen_tpu_torch.pipeline import common

N_FRAMES = 3


@pytest.fixture(scope="module")
def clip():
    return make_clip(n=N_FRAMES)


def _alpha(gt, seed):
    """A soft alpha around a binary mask: 0..255 with an uneven band."""
    rng = np.random.RandomState(seed)
    a = gt.astype(np.float32)
    a[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2]
                     + a[1:-1, 2:]) / 4.0
    return (a * rng.uniform(0.8, 1.0, a.shape)).astype(np.uint8)


def test_get_bg_and_bgr2gray(clip):
    frames, gts = clip
    img = frames[1].astype(np.float32)
    a = _alpha(gts[1], 0).astype(np.float32)
    assert_close(compositing.get_bg(tt(a), tt(img)),
                 jcomp.get_bg(jnp.asarray(a), jnp.asarray(img)), 1e-5)
    assert_close(color.bgr2gray(tt(img)),
                 jcolor.bgr2gray(jnp.asarray(img)), 1e-5)


@pytest.mark.parametrize("with_bg", [False, True])
def test_trimap_agent(clip, with_bg):
    frames, gts = clip
    cfg = dict(BG_TEST_CFG["trimap"], input_long_side=64)  # a real resize
    jagent, tagent = JTrimap(**cfg), TrimapAgent(**cfg, device="cpu")
    mask = _alpha(gts[0], 1)
    args = (mask,)
    if with_bg:
        args = (mask, frames[0], np.array([40, 190, 50], np.float32))
    want = jagent.forward(*args)
    got = tagent.forward(*args)
    assert got.dtype == torch.uint8
    assert_equal(got, want)
    assert set(np.unique(want)) >= {0, 128, 255}


def test_chroma_seg_agent(clip):
    frames, _ = clip
    cfg = BG_TEST_CFG["binseg"]
    tagent = build_seg_agent(cfg, device="cpu")
    assert isinstance(tagent, ChromaSegAgent)
    kw = {k: v for k, v in cfg.items() if k != "type"}
    for f in frames:
        assert_equal(tagent.forward(f), JChroma(**kw).forward(f))


@pytest.mark.parametrize("kind", ["human", "deeplab"])
def test_unported_seeds_raise(kind):
    """Both neural seeds are ported: SCHP ("human") builds a
    HumanSegAgent and DeepLab a SegAgent, and a configured weights file
    that is missing raises."""
    if kind == "human":
        agent = build_seg_agent({"type": kind, "crop_h": 64, "crop_w": 64,
                                 "layers": (1, 1, 1, 1)}, device="cpu")
        assert isinstance(agent, HumanSegAgent)
        assert agent.input_size == (64, 64)
    else:
        agent = build_seg_agent({"type": kind, "crop_h": 64, "crop_w": 64},
                                device="cpu")
        assert isinstance(agent, SegAgent) and agent.crop_h == 64
    with pytest.raises(FileNotFoundError):
        build_seg_agent({"type": kind, "model_path": "x"}, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_invalid_objects_cfg(clip, seed):
    _, gts = clip
    rng = np.random.RandomState(seed)
    alpha = _alpha(gts[seed], seed)
    alpha[rng.rand(*alpha.shape) < 0.01] = 200        # small blobs to drop
    alpha[5:9, 100:120] = 255                         # an off-center one
    seg = np.where(rng.rand(*alpha.shape) < 0.5, alpha, 0).astype(np.uint8)
    for segmask in (None, seg):
        want = jcommon.remove_invalid_objects_cfg(BG_TEST_CFG, alpha,
                                                  segmask)
        got = common.remove_invalid_objects_cfg(
            BG_TEST_CFG, torch.from_numpy(alpha),
            None if segmask is None else torch.from_numpy(segmask))
        assert_equal(got, want)
        assert (want > 0).sum() < (alpha > 0).sum()


def test_per_frame_background(clip):
    frames, gts = clip
    alpha = _alpha(gts[2], 2)
    want = jbg._per_frame_background(frames[2], alpha)
    got = tbg._per_frame_background(tt(frames[2]).to(torch.float32),
                                    torch.from_numpy(alpha))
    assert got.dtype == torch.uint8
    d = np.abs(nn_(got).astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()


@pytest.fixture(scope="module")
def runs(clip):
    frames, _ = clip
    calls = []
    forward = STMAgent.forward

    def counted(self, *a):
        calls.append(1)
        return forward(self, *a)

    STMAgent.forward = counted
    try:
        port = tbg.run(BG_TEST_CFG, frames, save=False, device="cpu")
    finally:
        STMAgent.forward = forward
    return port, run_bg(BG_TEST_CFG, frames=frames, save=False), len(calls)


def test_run_matches_jax(clip, runs):
    _, gts = clip
    port, ref, stm_calls = runs
    assert port["numframes"] == ref["numframes"] == N_FRAMES
    # frame 0 seeds; the later frames go through the STM tracker
    assert stm_calls == N_FRAMES - 1
    for i, (got, want) in enumerate(zip(port["alphas"], ref["alphas"])):
        assert got.shape == want.shape == gts[i].shape
        assert got.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 4, (i, d.max())
        assert (d > 1).mean() < 1e-3, (i, (d > 1).mean())
    for fg in port["fgs"]:
        assert fg.shape == gts[0].shape + (3,) and fg.dtype == np.uint8


def test_run_quality(clip, runs):
    _, gts = clip
    port, _, _ = runs
    mious = [float(M.miou(jnp.asarray(gt, jnp.float32),
                          jnp.asarray(a, jnp.float32)))
             for a, gt in zip(port["alphas"], gts)]
    assert mious[0] > 0.8, mious
    assert np.mean(mious) > 0.75, mious


def test_run_refuses_unported_options(tmp_path):
    """Reading the clip from disk and saving the artifacts are ported
    (tests/test_torch_fileio.py); the driver refuses a clip directory
    without frames, and a frame file its JPEG codec cannot read."""
    data = {"src_img_dir": str(tmp_path), "src_img_tmpl": "*.*",
            "dst_img_dir": str(tmp_path / "out"), "range": None}
    cfg = dict(BG_TEST_CFG, data=data)
    with pytest.raises(FileNotFoundError):
        tbg.run(cfg, None, save=True, device="cpu")
    (tmp_path / "frame_000000.png").write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match="PNG"):
        tbg.run(cfg, None, save=True, device="cpu")
    assert not (tmp_path / "out").exists()
