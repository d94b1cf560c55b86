"""The fused pipelines' chunk entry points within the port (their JAX
comparisons are in `tests/test_torch_fetch_{green,bg}.py`), on the JAX
suite's synthetic clip, float32 (bg with STM tracking off):

- `process_chunk` on the clip as one chunk from a fresh carry, against
  `run` on the same frames: the outputs equal to what `run` downloads, and
  the carry equal to the carry `run` ends with, bit for bit;
- `process_chunk_segments` on 2 segments against `run_segmented`;
- I420 input, (N, H * 3 / 2, W) uint8, against `run` over the I420 wire;
- every frame given runs: `stats["steps"]` counts them.
Both sides run the same torch ops on the same CPU, so bit-equality
holds."""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from video_unscreen_tpu_torch import runtime
from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
from video_unscreen_tpu_torch.pipeline.fused_green import \
    FusedGreenPipeline

HW = (96, 128)
N = 4


def _pipe(kind, wire="bgr"):
    if kind == "green":
        return FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                                  matting_dtype=torch.float32,
                                  seg_dtype=torch.float32, wire=wire,
                                  device="cpu")
    return FusedBgPipeline(BG_TEST_CFG, HW, work_long_side=128,
                           use_stm_tracking=False,
                           matting_dtype=torch.float32,
                           stm_dtype=torch.float32, seg_dtype=torch.float32,
                           wire=wire, device="cpu")


def _artifacts(kind, outs):
    """`run`'s artifacts of one segment's outputs: alpha and fg (and
    segmask and bg for bg mode)."""
    p = outs[0].numpy()
    if kind == "green":
        return p[..., 0], p[..., 1:4]
    return p[..., 0], p[..., 1], p[..., 2:5], p[..., 5:8]


def _carry_equal(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def clip():
    frames, _ = make_clip(n=N)
    return frames


@pytest.mark.parametrize("wire", ["bgr", "yuv420"])
@pytest.mark.parametrize("kind", ["green", "bg"])
def test_process_chunk_equals_run(clip, kind, wire):
    ref = _pipe(kind, wire)
    want = ref.run(clip, chunk_size=N)
    pipe = _pipe(kind)
    x = np.stack(clip)
    if wire == "yuv420":
        x = runtime.bgr_to_i420_batch(clip)
        assert x.shape == (N, HW[0] * 3 // 2, HW[1])
    carry, outs = pipe.process_chunk(pipe.init_carry(), x)
    assert pipe.stats["steps"] == N
    assert all(o.shape[0] == N for o in outs)
    for g, w in zip(_artifacts(kind, outs), want):
        np.testing.assert_array_equal(g, w)
    if kind == "green":
        _carry_equal(carry, ref.carries[0])
    else:
        _carry_equal(carry, ref.carries)


@pytest.mark.parametrize("kind", ["green", "bg"])
def test_process_chunk_segments_equals_run_segmented(clip, kind):
    ref = _pipe(kind)
    want = ref.run_segmented(clip, 2, 2)
    pipe = _pipe(kind)
    x = np.stack(clip)
    carries, outs = pipe.process_chunk_segments(
        pipe.init_carries(2), x.reshape((2, 2) + x.shape[1:]))
    assert outs[0].shape[:2] == (2, 2)
    flat = tuple(o.reshape((N,) + o.shape[2:]) for o in outs)
    for g, w in zip(_artifacts(kind, flat), want):
        np.testing.assert_array_equal(g, w)
    if kind == "green":
        assert len(carries) == 2
        for c, r in zip(carries, ref.carries):
            _carry_equal(c, r)
    else:
        _carry_equal(carries, ref.carries)
