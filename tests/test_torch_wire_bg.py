"""The port's fused bg pipeline with the I420 wire and the host resize
against the JAX `FusedBgPipeline(wire="yuv420", fetch="device",
pack_d2h=False)` on the CPU, float32 on both sides (`host_downscale=True`
on both, JAX's default), on 192x256 frames at work size 96x128 with
`tests/test_pipeline_bg.py:BG_TEST_CFG` (chroma seed, the real STM and
matting weights) and `memory_step` 1, so that STM tracks and the ring bank
fills and rolls within the 4 frames. alpha, fg and bg are held to the JAX
suite's bound (max |diff| <= 4, |diff| > 1 on under 0.1% of pixels,
tests/test_fused_green.py); the seed's segmask exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu.pipeline.fused_bg import FusedBgPipeline as JPipe
from video_unscreen_tpu_torch.pipeline.fused_bg import \
    FusedBgPipeline as TPipe

FULL = (192, 256)
WORK = (96, 128)
N = 4
CFG_ON = dict(BG_TEST_CFG, stm=dict(BG_TEST_CFG["stm"], memory_step=1))


def _within_bound(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


@pytest.fixture(scope="module")
def runs():
    frames, _ = make_clip(n=N, h=FULL[0], w=FULL[1])
    jpipe = JPipe(CFG_ON, FULL, work_long_side=128, fetch="device",
                  pack_d2h=False, wire="yuv420", matting_dtype=jnp.float32,
                  stm_dtype=jnp.float32, seg_dtype=jnp.float32)
    tpipe = TPipe(CFG_ON, FULL, work_long_side=128, wire="yuv420",
                  matting_dtype=torch.float32, stm_dtype=torch.float32,
                  seg_dtype=torch.float32, device="cpu")
    assert tpipe.work_hw == WORK
    return jpipe.run(frames, chunk_size=2), tpipe.run(frames, chunk_size=2), \
        tpipe


@pytest.mark.parametrize("index,name", [(0, "alpha"), (2, "fg"), (3, "bg")])
def test_wire_run_against_jax(runs, index, name):
    want, got, _ = runs
    assert got[index].shape[:3] == (N,) + WORK
    _within_bound(got[index], want[index], name)


def test_wire_run_tracks(runs):
    """Frame 0 takes the seed (its segmask exactly JAX's), the rest track
    through the STM read."""
    want, got, tpipe = runs
    np.testing.assert_array_equal(got[1][0], want[1][0])
    assert tpipe.step_tracking == [(False,), (True,), (True,), (True,)]
    assert tpipe.stats["stm_steps"] == N - 1
    assert (got[0] >= 128).any() and (got[0] < 128).any()
