"""The I420 wire, the host resize and the pinned double-buffered upload of
the port's green pipeline on the CPU.

- `ops/color.py:yuv420_to_bgr` against the JAX function to 1e-5.
- `FusedGreenPipeline(wire="yuv420")` with `host_downscale=True` against
  the JAX `FusedGreenPipeline(wire="yuv420", fetch_fg="device",
  pack_d2h=False)`, float32, on 192x256 frames at work size 96x128, so
  the host resize runs: `run` and `run_segmented` (S = 2), alpha, fg and
  bg within the JAX suite's bound (max |diff| <= 4, |diff| > 1 on under
  0.1% of pixels, tests/test_fused_green.py). The host's resize and I420
  are bit-equal to cv2's (tests/test_torch_runtime.py), so the device
  sees the JAX device's bytes.
- The streamer (`parallel/streaming.py:ChunkStream`, `run_segments`) on
  the CPU: chunk and step order, the clip's tail padded with its last
  frame, a chunk never refilled while the caller reads it (under a short
  thread switch interval), and an exception raised in the worker reaching
  the caller.
"""
import collections
import sys
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close
from video_unscreen_tpu.ops.color import yuv420_to_bgr as j_yuv420_to_bgr
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.ops.color import yuv420_to_bgr
from video_unscreen_tpu_torch.parallel.streaming import ChunkStream
from video_unscreen_tpu_torch.pipeline import fused_green as tfg
from video_unscreen_tpu_torch.pipeline.common import prep_frames, run_segments

FULL = (192, 256)
WORK = (96, 128)


def _within_bound(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


@pytest.mark.parametrize("hw", [(96, 128), (544, 960)])
def test_yuv420_to_bgr_against_jax(hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)
    want = np.asarray(j_yuv420_to_bgr(jnp.asarray(yuv)))
    got = yuv420_to_bgr(torch.from_numpy(yuv))
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-5, "yuv420_to_bgr")
    batch = yuv420_to_bgr(torch.from_numpy(np.stack([yuv, yuv])))
    assert_close(batch[1], want, 1e-5, "batched yuv420_to_bgr")


def test_prep_frames_decodes_then_resizes():
    """A full-size I420 step (host_downscale off) is decoded, then resized
    on the device; a work-size one is only decoded."""
    frames, _ = make_clip(n=2, h=FULL[0], w=FULL[1])
    yuv = torch.from_numpy(np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
                                     for f in frames]))
    full = prep_frames(yuv, WORK)
    assert full.shape == (2,) + WORK + (3,)
    small = np.stack([cv2.cvtColor(cv2.resize(f, WORK[::-1]),
                                   cv2.COLOR_BGR2YUV_I420) for f in frames])
    assert_close(prep_frames(torch.from_numpy(small), WORK),
                 yuv420_to_bgr(torch.from_numpy(small)), 0.0)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipe(TEST_CFG, FULL, work_long_side=128, fetch_fg="device",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32, wire="yuv420")
    tpipe = tfg.FusedGreenPipeline(TEST_CFG, FULL, work_long_side=128,
                                   matting_dtype=torch.float32,
                                   seg_dtype=torch.float32, wire="yuv420",
                                   device="cpu")
    assert tpipe.work_hw == WORK
    return jpipe, tpipe


@pytest.mark.parametrize("segments", [1, 2])
def test_wire_run_against_jax(pipes, segments):
    jpipe, tpipe = pipes
    frames, _ = make_clip(n=4, h=FULL[0], w=FULL[1])
    if segments == 1:
        want = jpipe.run(frames, chunk_size=4)
        got = tpipe.run(frames)
    else:
        want = jpipe.run_segmented(frames, n_segments=2, chunk_size=2)
        got = tpipe.run_segmented(frames, n_segments=2, chunk_size=2)
    for name, g, w in zip(("alpha", "fg", "bg"), got, want):
        assert g.shape[:3] == (4,) + WORK
        _within_bound(g, w, f"S={segments} {name}")
    assert (got[0] >= 128).any() and (got[0] < 128).any()
    assert tpipe.stats["steps"] == 4 // segments


def _identity_run(frames, n_segments, chunk_size):
    seen = []

    def step(carry, batch):
        seen.append(batch.clone())
        return carry + 1, (batch.clone(),)

    stats = collections.Counter()
    out, _ = run_segments(step, 0, frames, n_segments, chunk_size,
                          torch.device("cpu"), stats, frames[0].shape[:2])
    return out, seen, stats


def test_run_segments_order_and_tail_pad():
    """7 frames in 3 segments of 3 (the tail padded with the last frame
    twice), chunks of 2 steps: the steps see each segment's frames in
    order, the outputs come back in clip order, trimmed to 7."""
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 256, (4, 6, 3)).astype(np.uint8)
              for _ in range(7)]
    out, seen, stats = _identity_run(frames, 3, 2)
    np.testing.assert_array_equal(out, np.stack(frames))
    assert len(seen) == 3 and stats["syncs"] == 2
    padded = frames + [frames[-1]] * 2
    for t, batch in enumerate(seen):
        for s in range(3):
            np.testing.assert_array_equal(batch[s].numpy(),
                                          padded[s * 3 + t])


def test_stream_never_refills_a_chunk_in_use():
    """Many chunks, a worker racing a slow reader: each chunk the caller
    holds keeps its own index until the caller moves on."""
    n_chunks = 60

    def fill(i, out):
        out[...] = i % 251
        return out.shape[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = time.time()
        for i, (chunk, n_valid) in enumerate(
                ChunkStream(fill, n_chunks, (3, 5), torch.device("cpu"))):
            assert n_valid == 3 and bool((chunk == i % 251).all())
            time.sleep(0.001)
            assert bool((chunk == i % 251).all()), f"chunk {i} refilled"
        assert i == n_chunks - 1 and time.time() - start < 60
    finally:
        sys.setswitchinterval(old)
    assert not [t for t in threading.enumerate()
                if t.name == "chunk-stream"]


def test_worker_exception_reaches_the_caller():
    def fill(i, out):
        if i == 2:
            raise ValueError("chunk 2 failed to build")
        out[...] = i
        return out.shape[0]

    got = []
    with pytest.raises(ValueError, match="chunk 2 failed to build"):
        for chunk, _ in ChunkStream(fill, 5, (2, 2), torch.device("cpu")):
            got.append(int(chunk[0, 0]))
    assert got == [0, 1]
