"""Fused bg's host fetch and packed download (`fetch="host"`, `pack_d2h`)
and its chunk entry points, against the JAX `FusedBgPipeline(fetch="host",
pack_d2h=False)` on the JAX suite's synthetic clip (STM tracking off as
the JAX suite's own fetch tests run it, float32; one JAX compile of each
entry point):

- the host reconstruction's cv2 pieces, bit-equal to the cv2 the JAX
  package runs: `runtime.bgr_to_hsv` over all 2^24 BGR triples and
  `runtime.hsv_to_bgr` over every HSV triple with H < 180, each at a row
  width whose pixels all take cv2's vector loop and at two whose rows end
  in its scalar tail; the 3x3-ellipse dilation against `cv2.dilate`;
- the port's `_assemble_outputs` on JAX's own fetched payload (its
  `process_chunk`'s planes and `bg_small`), bit-equal to JAX's;
- `process_chunk` (4 frames) and `process_chunk_segments` (2 x 2) from
  fresh carries against JAX's: alpha and segmask planes and `bg_small`
  within the end-to-end bound (max |diff| <= 4, > 1 on < 0.1%);
- the host artifacts of `run` against JAX's `run`: alphas and segmasks
  within that bound, fg and bg by mean |diff| < 6, the bound the JAX
  suite holds its host fetch to against its device fetch
  (tests/test_fused_bg.py:42-57);
- within the port: host against device fetch, alphas and segmasks
  bit-equal, fg and bg mean |diff| < 6; packed against unpacked, every
  artifact bit-equal (tests/test_fused_bg.py:99-112), at the default band
  budget and at one that overflows on every frame."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_port_util import within_jax_bound
from video_unscreen_tpu.pipeline.fused_bg import FusedBgPipeline as JPipe
from video_unscreen_tpu_torch import runtime
from video_unscreen_tpu_torch.pipeline.fused_bg import (FusedBgPipeline,
                                                        _dilate_cross)

HW = (96, 128)
N = 4
T32 = dict(matting_dtype=torch.float32, stm_dtype=torch.float32,
           seg_dtype=torch.float32, device="cpu")


def _pipe(**kw):
    return FusedBgPipeline(BG_TEST_CFG, HW, work_long_side=128,
                           use_stm_tracking=False, **T32, **kw)


def _mean_diff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).mean())


@pytest.fixture(scope="module")
def clip():
    frames, _ = make_clip(n=N)
    return frames


@pytest.fixture(scope="module")
def jax_side(clip):
    jpipe = JPipe(BG_TEST_CFG, HW, work_long_side=128,
                  use_stm_tracking=False, matting_dtype=jnp.float32,
                  stm_dtype=jnp.float32, seg_dtype=jnp.float32,
                  fetch="host", pack_d2h=False)
    x = np.stack(clip)
    _, chunk = jpipe.process_chunk(jpipe.init_carry(), jnp.asarray(x))
    _, segs = jpipe.process_chunk_segments(
        jpipe.init_carries(2), jnp.asarray(x.reshape((2, 2) + x.shape[1:])))
    return dict(pipe=jpipe, chunk=[np.asarray(o) for o in chunk],
                segs=[np.asarray(o) for o in segs],
                run=jpipe.run(clip, chunk_size=N))


@pytest.fixture(scope="module")
def host_run(clip):
    return _pipe(fetch="host", pack_d2h=False).run(clip, chunk_size=2)


def _all_bgr():
    x = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([x & 255, (x >> 8) & 255, x >> 16],
                    -1).astype(np.uint8)


def _all_hsv():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)


@pytest.mark.parametrize("width", [4096, 1000, 31])
@pytest.mark.parametrize("kind", ["bgr2hsv", "hsv2bgr"])
def test_hsv_conversions_bit_equal_to_cv2(kind, width):
    px = _all_bgr() if kind == "bgr2hsv" else _all_hsv()
    img = np.concatenate([px, px[:(-len(px)) % width]]).reshape(-1, width, 3)
    fn, code = ((runtime.bgr_to_hsv, cv2.COLOR_BGR2HSV) if kind == "bgr2hsv"
                else (runtime.hsv_to_bgr, cv2.COLOR_HSV2BGR))
    got = fn(img)
    want = cv2.cvtColor(img, code)
    bad = int((got != want).any(-1).sum())
    assert bad == 0, f"{kind} at width {width}: {bad} pixels differ"


def test_dilate_cross_equals_cv2():
    rng = np.random.RandomState(0)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    masks = rng.rand(3, 37, 53) < 0.02
    masks[0, 0, 0] = masks[1, -1, -1] = masks[2, 0, -1] = True
    got = _dilate_cross(masks, 2)
    for m, g in zip(masks, got):
        want = cv2.dilate(m.astype(np.uint8), kernel, iterations=2)
        np.testing.assert_array_equal(g, want > 0)


def test_assemble_outputs_on_jax_payload(clip, jax_side):
    jpipe = jax_side["pipe"]
    planes, bg_small = jax_side["chunk"]
    want = jpipe._assemble_outputs(clip, planes, bg_small)
    got = _pipe(fetch="host")._assemble_outputs(clip, planes, bg_small)
    for name, g, w in zip(("alpha", "segmask", "fg", "bg"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("entry", ["chunk", "segs"])
def test_chunk_entry_points_against_jax(clip, jax_side, entry):
    pipe = _pipe(fetch="host", pack_d2h=False)
    x = np.stack(clip)
    if entry == "chunk":
        _, outs = pipe.process_chunk(pipe.init_carry(), x)
    else:
        _, outs = pipe.process_chunk_segments(
            pipe.init_carries(2), x.reshape((2, 2) + x.shape[1:]))
    want = jax_side[entry]
    assert len(outs) == len(want) == 2
    for name, g, w in zip(("planes", "bg_small"), outs, want):
        assert g.shape == w.shape, name
        within_jax_bound(g, w, f"{entry} {name}")
    assert want[1].shape[-3:] == (HW[0] // 2, HW[1] // 2, 3)


def test_host_artifacts_against_jax(host_run, jax_side):
    for i, name in enumerate(("alpha", "segmask", "fg", "bg")):
        g, w = host_run[i], jax_side["run"][i]
        assert g.shape == w.shape and g.dtype == np.uint8, name
        if i < 2:
            within_jax_bound(g, w, f"host fetch {name}")
        else:
            assert _mean_diff(g, w) < 6.0, name


def test_host_fetch_against_device_fetch(clip, host_run):
    dev = _pipe(fetch="device")
    want = dev.run(clip, chunk_size=2)
    np.testing.assert_array_equal(host_run[0], want[0])
    np.testing.assert_array_equal(host_run[1], want[1])
    for i, name in ((2, "fg"), (3, "bg")):
        assert _mean_diff(host_run[i], want[i]) < 6.0, name
    assert dev.stats["d2h_bytes"] == N * 8 * HW[0] * HW[1]


@pytest.mark.parametrize("capacity", ["default", "overflow"])
def test_packed_equals_unpacked(clip, host_run, capacity):
    pipe = _pipe(fetch="host")
    assert pipe.pack_d2h is True
    pipe._pack_capacity = None if capacity == "default" else 8
    got = pipe.run(clip, chunk_size=2)
    for name, g, w in zip(("alpha", "segmask", "fg", "bg"), got, host_run):
        np.testing.assert_array_equal(g, w, err_msg=f"packed {name}")
    if capacity == "overflow":
        assert pipe.stats["fallbacks"] == N
