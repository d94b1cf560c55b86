"""Segment batching and bfloat16 of the port's green pipeline on the CPU.

`run_segmented` (S clip segments in lockstep) against the JAX
`run_segmented` (fg on the device, frames resized on the device:
`host_downscale=False`), float32 and the chroma seed, on the JAX suite's
synthetic clip; segment 0 against the port's own sequential run; a clip
whose segments desync, so that one step refits some segments only and one
segment's motion sets the shared band tier. uint8 outputs are held to the
JAX suite's bound, max |diff| <= 4 and |diff| > 1 on < 0.1% of pixels
(tests/test_fused_green.py). bfloat16 is compared with nothing on the CPU
(it is held to float32 on the card): its dtypes, finite outputs and the
defaults are checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_port_util import tt
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.agents.binseg import SegAgent
from video_unscreen_tpu_torch.agents.vmatting import VMattingAgent
from video_unscreen_tpu_torch.pipeline import fused_green as tfg

HW = (96, 128)


def _within_bound(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipe(TEST_CFG, HW, work_long_side=128, fetch_fg="device",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32)
    tpipe = tfg.FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                                   matting_dtype=torch.float32,
                                   seg_dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _desync_clip():
    """Two segments of 3 frames. Segment 0's second frame jumps 10 px
    (past the 2 x iters = 6 px of band tier 1); segment 1's second frame
    is bare screen, so it loses tracking and re-seeds and refits on the
    third step while segment 0 only predicts."""
    frames, _ = make_clip(n=6)
    rng = np.random.RandomState(7)
    screen = np.full(HW + (3,), (40, 190, 50), np.float32)
    screen = (screen + rng.randn(*screen.shape) * 5).clip(0, 255)
    return [frames[0], np.roll(frames[0], 10, axis=1), frames[2],
            frames[3], screen.astype(np.uint8), frames[5]]


@pytest.mark.parametrize("clip", ["steady", "desync"])
def test_run_segmented_against_jax(pipes, clip):
    jpipe, tpipe = pipes
    frames = make_clip(n=6)[0] if clip == "steady" else _desync_clip()
    want = jpipe.run_segmented(frames, n_segments=2, chunk_size=3,
                               host_downscale=False)
    got = tpipe.run_segmented(frames, n_segments=2, chunk_size=3,
                              host_downscale=False)
    for name, g, w in zip(("alpha", "fg", "bg"), got, want):
        assert g.shape[0] == 6
        _within_bound(g, w, f"{clip} {name}")
    stats = tpipe.stats
    assert stats["steps"] == 3 and stats["refit_all"] >= 1
    # one sync for the flags and one for the band tier a step, one fetch
    assert stats["syncs"] == 2 * 3 + 1
    if clip == "desync":
        assert tpipe.step_tracking == [(False, False), (True, True),
                                       (True, False)]
        assert stats["refit_some"] == 1, stats
        assert stats["tier_1"] + stats["tier_2"] + stats["tier_3"] >= 1, \
            stats
        assert stats["seed_steps"] == 2 and stats["seeded_frames"] == 3


def test_segment0_matches_sequential(pipes):
    _, tpipe = pipes
    frames, _ = make_clip(n=6)
    a_seq, f_seq, b_seq = tpipe.run(frames, chunk_size=3)
    a_seg, f_seg, b_seg = tpipe.run_segmented(frames, n_segments=2,
                                              chunk_size=3)
    assert a_seg.shape == a_seq.shape == (6,) + HW
    assert f_seg.shape == b_seg.shape == (6,) + HW + (3,)
    for name, g, w in (("alpha", a_seg, a_seq), ("fg", f_seg, f_seq),
                       ("bg", b_seg, b_seq)):
        _within_bound(g[:3], w[:3], f"segment 0 {name}")


def test_tail_padding(pipes):
    """5 frames in 2 segments of 3: the tail is padded with the last frame,
    then trimmed."""
    _, tpipe = pipes
    frames, _ = make_clip(n=5)
    alphas, fgs, bgs = tpipe.run_segmented(frames, n_segments=2,
                                           chunk_size=2)
    assert alphas.shape == (5,) + HW and fgs.shape == bgs.shape == (
        5,) + HW + (3,)
    assert tpipe.stats["steps"] == 3 and tpipe.stats["syncs"] == 2 * 3 + 2


def test_bf16_convolutions_and_outputs():
    """bfloat16 matting and seed: the convolutions run in bfloat16, the
    alpha and the score map come out float32 and finite."""
    seen = {}

    def hook(name):
        def f(_mod, _inp, out):
            seen[name] = out.dtype
        return f

    vmat = VMattingAgent("weights/matting_unet.msgpack", 128, device="cpu",
                         dtype=torch.bfloat16)
    vmat.model.enc_conv1.register_forward_hook(hook("unet"))
    seg = SegAgent(crop_h=64, crop_w=64, device="cpu", dtype=torch.bfloat16)
    seg.model.cls_conv.register_forward_hook(hook("deeplab"))
    frames, gts = make_clip(n=1)
    img = tt(frames[0].astype(np.float32))
    tri = tt(np.where(gts[0] > 0, 255.0, 0.0).astype(np.float32))
    with torch.no_grad():
        alpha = vmat.device_forward_impl(img, tri, tri, HW)
        score = seg.predict_scores(img)
    assert seen == {"unet": torch.bfloat16, "deeplab": torch.bfloat16}
    assert alpha.dtype == score.dtype == torch.float32
    assert torch.isfinite(alpha).all() and torch.isfinite(score).all()
    assert score.shape == HW + (2,)


def test_pipeline_defaults_are_bf16():
    """As in the JAX pipeline, matting and seed default to bfloat16; a
    run with the (seeded) DeepLab seed gives uint8 outputs."""
    cfg = dict(TEST_CFG, binseg={"type": "deeplab", "crop_h": 64,
                                 "crop_w": 64})
    pipe = tfg.FusedGreenPipeline(cfg, HW, work_long_side=128, device="cpu")
    assert pipe.vmat.model.enc_conv1.weight.dtype == torch.bfloat16
    assert pipe.vmat.model.enc_bn1.weight.dtype == torch.float32
    assert pipe.seg.model.cls_out.weight.dtype == torch.bfloat16
    frames, _ = make_clip(n=2)
    alphas, fgs, _ = pipe.run_segmented(frames, n_segments=2, chunk_size=1)
    assert alphas.shape == (2,) + HW and alphas.dtype == np.uint8
    assert pipe.seg.forwards == 1 and pipe.seg.frames == 2
