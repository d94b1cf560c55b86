"""The port's green `process_segments` over 4 ranks on the CPU.

The cases of `tests/test_fused_green_sharded.py` for the port: S = 4
segments of 2 frames of the JAX suite's synthetic clip, float32 and the
chroma seed, on a (data 2, model 2) mesh of 4 `gloo` ranks spawned once
for the file (`parallel/launch.py`; what they run is
`tests/torch_rank_cases.py:green_segments`). Every rank returns the whole
(S, L, ...) output:

- bit-equal on every rank to this process running the same two blocks of
  2 segments from `init_carries(2)` through `_step_batched`;
- held to the JAX `process_segments` on `make_mesh(4)`, which is (data 2,
  model 2) on the suite's 8 CPU devices, so both sides share one band tier
  per block of 2 segments: alpha and fg within the bound
  `tests/test_torch_fused_green_seg.py` holds `run_segmented` to
  (`torch_port_util.within_jax_bound`: max |diff| <= 4, |diff| > 1 on
  < 0.1% of pixels), the screen colors to JAX's own atol of 1e-2;
- S = 3 on the data axis of 2 raises ValueError("... not divisible ...").
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_rank_cases as cases
from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_equal, within_jax_bound
from video_unscreen_tpu.parallel import make_mesh as jax_make_mesh
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.parallel.launch import run_ranks

HW = (96, 128)
S, L = 4, 2


@pytest.fixture(scope="module")
def segments():
    frames, _ = make_clip(n=S * L)
    return np.stack(frames).reshape(S, L, *HW, 3)


@pytest.fixture(scope="module")
def ranks(segments):
    return run_ranks(cases.green_segments, 4, (segments, TEST_CFG),
                     timeout=240)


@pytest.fixture(scope="module")
def jax_outs(segments):
    pipe = JPipe(TEST_CFG, HW, work_long_side=128, fetch_fg="device",
                 pack_d2h=False, matting_dtype=jnp.float32,
                 seg_dtype=jnp.float32)
    packed, bg_colors = pipe.process_segments(jax_make_mesh(4),
                                              jnp.asarray(segments))
    return np.asarray(packed), np.asarray(bg_colors)


def test_mesh_over_four_ranks(ranks):
    for rank, r in enumerate(ranks):
        assert r["mesh"] == ({"data": 2, "model": 2},
                             {"data": rank // 2, "model": rank % 2})


def test_segments_equal_one_process(ranks, segments):
    pipe = cases.green_pipe(TEST_CFG, HW)
    want = cases.one_process(cases.green_step(pipe), pipe.init_carries,
                             segments)
    assert want[0].shape == (S, L) + HW + (4,)
    assert want[1].shape == (S, L, 3)
    for rank, r in enumerate(ranks):
        for name, g, w in zip(("packed", "bg_colors"), r["outs"], want):
            assert_equal(g, w, f"rank {rank} {name}")
        # L steps, each one flag read (with the model axis' reduction) and
        # one band-tier read; the seed on both segments of the first step
        assert r["stats"]["steps"] == L and r["stats"]["syncs"] == 2 * L
        assert r["tracking"][0] == (False, False)


def test_segments_against_jax(ranks, jax_outs):
    packed, bg_colors = ranks[0]["outs"]
    want_packed, want_bg = jax_outs
    assert want_packed.shape == packed.shape
    within_jax_bound(packed[..., 0], want_packed[..., 0], "alpha")
    within_jax_bound(packed[..., 1:], want_packed[..., 1:], "fg")
    np.testing.assert_allclose(bg_colors, want_bg, atol=1e-2)


def test_indivisible_segments_raise(ranks):
    for r in ranks:
        assert r["indivisible"] is not None
        assert "not divisible" in r["indivisible"]
