"""Green's host fetch and packed download (`fetch_fg="host"`, `pack_d2h`)
and its chunk entry points, against the JAX `FusedGreenPipeline(
fetch_fg="host", pack_d2h=False)` on the JAX suite's synthetic clip,
float32 matting and seed on both sides (one JAX compile of each entry
point):

- `process_chunk` (4 frames) and `process_chunk_segments` (2 segments x 2
  frames) from fresh carries against JAX's: the downloaded alphas within
  the end-to-end bound (max |diff| <= 4, > 1 on < 0.1%:
  `torch_port_util.within_jax_bound`), the screen colors to 1e-3 of 255;
- the host artifacts of `run` against JAX's `run`, within that bound;
- `runtime.get_fg_batch` on JAX's fetched alphas and colors, bit-equal to
  the JAX package's native `get_fg_batch`;
- within the port: the host fetch against the packed one through `run` and
  `run_segmented`, every artifact bit-equal, at the default band budget,
  at a budget that holds every band, and at one that overflows on every
  frame (the device fallback fetches each plane); host against device
  fetch, alphas and bg bit-equal and fg within the bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, within_jax_bound
from video_unscreen_tpu import runtime as jruntime
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch import runtime
from video_unscreen_tpu_torch.pipeline.fused_green import \
    FusedGreenPipeline

HW = (96, 128)
N = 4
F32 = dict(matting_dtype=torch.float32, seg_dtype=torch.float32)


def _pipe(**kw):
    return FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                              device="cpu", **F32, **kw)


@pytest.fixture(scope="module")
def clip():
    frames, _ = make_clip(n=N)
    return frames


@pytest.fixture(scope="module")
def jax_side(clip):
    jpipe = JPipe(TEST_CFG, HW, work_long_side=128, fetch_fg="host",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32)
    x = np.stack(clip)
    _, chunk = jpipe.process_chunk(jpipe.init_carry(), jnp.asarray(x))
    _, segs = jpipe.process_chunk_segments(
        jpipe.init_carries(2), jnp.asarray(x.reshape((2, 2) + x.shape[1:])))
    return dict(chunk=[np.asarray(o) for o in chunk],
                segs=[np.asarray(o) for o in segs],
                run=jpipe.run(clip, chunk_size=N))


@pytest.fixture(scope="module")
def host_run(clip):
    pipe = _pipe(fetch_fg="host", pack_d2h=False)
    return pipe.run(clip), pipe.stats


@pytest.fixture(scope="module")
def host_seg_run(clip):
    return _pipe(fetch_fg="host", pack_d2h=False).run_segmented(clip, 2, 1)


def test_process_chunk_against_jax(clip, jax_side):
    pipe = _pipe(fetch_fg="host", pack_d2h=False)
    _, outs = pipe.process_chunk(pipe.init_carry(), np.stack(clip))
    want = jax_side["chunk"]
    assert len(outs) == len(want) == 2
    assert outs[0].shape == want[0].shape == (N,) + HW + (1,)
    within_jax_bound(outs[0], want[0], "process_chunk alpha")
    assert_close(outs[1], want[1], 1e-3, "process_chunk screen color")


def test_process_chunk_segments_against_jax(clip, jax_side):
    pipe = _pipe(fetch_fg="host", pack_d2h=False)
    x = np.stack(clip)
    _, outs = pipe.process_chunk_segments(
        pipe.init_carries(2), x.reshape((2, 2) + x.shape[1:]))
    want = jax_side["segs"]
    assert outs[0].shape == want[0].shape == (2, 2) + HW + (1,)
    within_jax_bound(outs[0], want[0], "segments alpha")
    assert_close(outs[1], want[1], 1e-3, "segments screen color")


def test_host_artifacts_against_jax(host_run, jax_side):
    got, stats = host_run
    for name, g, w in zip(("alpha", "fg", "bg"), got, jax_side["run"]):
        assert g.shape == w.shape and g.dtype == np.uint8
        within_jax_bound(g, w, f"host fetch {name}")
    # one fetch of alpha and color: no fg crosses
    assert stats["d2h_bytes"] == N * (HW[0] * HW[1] + 3 * 4)


def test_get_fg_batch_equals_jax_runtime(clip, jax_side):
    alphas = jax_side["chunk"][0][..., 0]
    colors = jax_side["chunk"][1]
    frames = np.stack(clip)
    want = jruntime.get_fg_batch(frames, alphas, colors)
    np.testing.assert_array_equal(
        runtime.get_fg_batch(frames, alphas, colors), want)


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("capacity", ["default", "whole", "overflow"])
def test_packed_equals_unpacked(clip, host_run, host_seg_run, segments,
                                capacity):
    """At 96x128 the synthetic clip's band may exceed the default budget of
    n / 16; "whole" holds every band, "overflow" (8 values) none."""
    n_px = HW[0] * HW[1]
    pipe = _pipe(fetch_fg="host")
    assert pipe.pack_d2h is True
    pipe._pack_capacity = {"default": None, "whole": n_px,
                           "overflow": 8}[capacity]
    if segments == 1:
        got, want = pipe.run(clip), host_run[0]
    else:
        got, want = pipe.run_segmented(clip, 2, 1), host_seg_run
    for name, g, w in zip(("alpha", "fg", "bg"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"packed {name}")
    if capacity == "whole":
        assert pipe.stats["fallbacks"] == 0
    if capacity == "overflow":
        assert pipe.stats["fallbacks"] == N


def test_host_fetch_against_device_fetch(clip, host_run):
    (ha, hf, hb), _ = host_run
    pipe = _pipe(fetch_fg="device")
    da, df, db = pipe.run(clip)
    np.testing.assert_array_equal(ha, da)
    np.testing.assert_array_equal(hb, db)
    within_jax_bound(hf, df, "host fg against device fg")
    assert pipe.stats["d2h_bytes"] == N * (4 * HW[0] * HW[1] + 3 * 4)
