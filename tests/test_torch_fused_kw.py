"""The port's fused pipelines take the JAX constructors' parameters.

`FusedGreenPipeline(cfg, frame_hw, work_long_side, fetch_fg,
matting_dtype, seg_dtype, wire, cc_downscale, pack_d2h)` and
`FusedBgPipeline(cfg, frame_hw, work_long_side, use_stm_tracking,
matting_dtype, stm_dtype, seg_dtype, wire, fetch, bg_downscale,
pass1_downscale, pack_d2h)`, JAX's order and defaults, then `device`:
the keyword sets the JAX tests and tools pass, the same by position, and
the host fetch and the packed download raising the error that names
ROADMAP.md's item 12. `cc_downscale` 1 and 4 (color_correct's distance
map at the work resolution and at a quarter of it) against the JAX
`run(host_downscale=False)` with the same value, float32 and the chroma
seed: alpha, fg and bg within the JAX suite's bound (max |diff| <= 4,
|diff| > 1 on < 0.1% of pixels: `torch_port_util.within_jax_bound`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_port_util import within_jax_bound
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
from video_unscreen_tpu_torch.pipeline.fused_green import \
    FusedGreenPipeline

HW = (96, 128)
F32 = dict(matting_dtype=torch.float32, seg_dtype=torch.float32)


@pytest.mark.parametrize("kw", [
    dict(fetch_fg="device", pack_d2h=False),   # tests/test_fused_green.py
    dict(fetch_fg="device"),                   # __graft_entry__.py
    dict(fetch_fg="auto"),
    dict(fetch_fg="device", cc_downscale=4, pack_d2h="auto")])
def test_green_takes_jax_keywords(kw):
    pipe = FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                              device="cpu", **kw)
    assert pipe.cc_long_side == 128 // kw.get("cc_downscale", 2)
    assert pipe.vmat.model.enc_conv1.weight.dtype == torch.bfloat16


def test_green_parameters_in_jax_order():
    pipe = FusedGreenPipeline(TEST_CFG, HW, 128, "device", torch.float32,
                              torch.float32, "yuv420", 1, False,
                              device="cpu")
    assert pipe.wire == "yuv420" and pipe.cc_long_side == 128
    assert pipe.vmat.model.enc_conv1.weight.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(fetch="device", pack_d2h=False, bg_downscale=2),
    dict(fetch="auto", bg_downscale=4, pass1_downscale=1)])
def test_bg_takes_jax_keywords(kw):
    pipe = FusedBgPipeline(BG_TEST_CFG, HW, work_long_side=128,
                           use_stm_tracking=False, device="cpu", **kw)
    assert pipe.bg_downscale == kw["bg_downscale"]
    assert pipe.pass1_downscale == kw.get("pass1_downscale", 2)


def test_bg_parameters_in_jax_order():
    f32 = torch.float32
    pipe = FusedBgPipeline(BG_TEST_CFG, HW, 128, False, f32, f32, f32,
                           "bgr", "device", 3, 1, False, device="cpu")
    assert (pipe.bg_downscale, pipe.pass1_downscale) == (3, 1)
    assert pipe.pass1_hw == pipe.work_hw
    with pytest.raises(ValueError, match="bg_downscale"):
        FusedBgPipeline(BG_TEST_CFG, HW, 128, False, bg_downscale=0,
                        device="cpu")


@pytest.mark.parametrize("kw", [dict(fetch_fg="host"),
                                dict(pack_d2h=True),
                                dict(fetch_fg="device", pack_d2h=True)])
def test_green_host_fetch_and_packing_raise(kw):
    with pytest.raises(NotImplementedError, match="item 12"):
        FusedGreenPipeline(TEST_CFG, HW, work_long_side=128, device="cpu",
                           **kw)


@pytest.mark.parametrize("cc_downscale", [1, 4])
def test_cc_downscale_against_jax(cc_downscale):
    frames, _ = make_clip(n=3)
    jpipe = JPipe(TEST_CFG, HW, work_long_side=128, fetch_fg="device",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32, cc_downscale=cc_downscale)
    want = jpipe.run(frames, chunk_size=3, host_downscale=False)
    tpipe = FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                               fetch_fg="device", pack_d2h=False,
                               cc_downscale=cc_downscale, device="cpu",
                               **F32)
    assert tpipe.cc_long_side == jpipe.cc_long_side
    got = tpipe.run(frames, chunk_size=3, host_downscale=False)
    for name, g, w in zip(("alpha", "fg", "bg"), got, want):
        within_jax_bound(g, np.asarray(w), f"cc_downscale {cc_downscale} "
                         f"{name}")
