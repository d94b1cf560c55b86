"""The port's fused pipelines take the JAX constructors' parameters.

`FusedGreenPipeline(cfg, frame_hw, work_long_side, fetch_fg,
matting_dtype, seg_dtype, wire, cc_downscale, pack_d2h)` and
`FusedBgPipeline(cfg, frame_hw, work_long_side, use_stm_tracking,
matting_dtype, stm_dtype, seg_dtype, wire, fetch, bg_downscale,
pass1_downscale, pack_d2h)`, JAX's order and defaults, then `device`:
the keyword sets the JAX tests and tools pass, the same by position, and
the fetch keywords resolved as JAX's constructors resolve them ("auto"
excepted, as ROADMAP.md records). `cc_downscale` 1 and 4 (color_correct's distance
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
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import within_jax_bound
from video_unscreen_tpu.pipeline.fused_bg import \
    FusedBgPipeline as JBgPipe
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


@pytest.mark.parametrize("kind", ["green", "bg"])
@pytest.mark.parametrize("fetch, pack", [
    ("device", False), ("device", True), ("device", "auto"),
    ("host", False), ("host", True), ("host", "auto"), ("auto", False)])
def test_keyword_resolution_against_jax(kind, fetch, pack):
    """(fetch_fg or fetch, pack_d2h) -> (self.fetch_fg or self.fetch,
    self.pack_d2h) as JAX's constructors resolve them: packing only with
    the host fetch. "auto" is the recorded exception: the port takes the
    device fetch where JAX takes the host one when its JPEG runtime
    builds, so it is held to "device" and JAX is not asked."""
    if kind == "green":
        args = (TEST_CFG, HW)
        kw = dict(work_long_side=128, fetch_fg=fetch, pack_d2h=pack)
        tpipe = FusedGreenPipeline(*args, device="cpu", **kw)
        got = (tpipe.fetch_fg, tpipe.pack_d2h)
    else:
        args = (BG_TEST_CFG, HW)
        kw = dict(work_long_side=128, use_stm_tracking=False, fetch=fetch,
                  pack_d2h=pack)
        tpipe = FusedBgPipeline(*args, device="cpu", **kw)
        got = (tpipe.fetch, tpipe.pack_d2h)
    if fetch == "auto":
        assert got == ("device", False)
        return
    jcls = JPipe if kind == "green" else JBgPipe
    jpipe = jcls(*args, **kw)
    want = (jpipe.fetch_fg if kind == "green" else jpipe.fetch,
            jpipe.pack_d2h)
    assert got == want


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
