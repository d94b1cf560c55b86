"""The port's fused bg `process_segments` over 4 ranks on the CPU.

`tests/test_fused_green_sharded.py:test_bg_segments_match_sequential` for
the port: S = 4 segments of 2 frames of the JAX suite's synthetic clip,
`BG_TEST_CFG` (chroma seed), float32, STM tracking off, on a (data 2,
model 2) mesh of 4 `gloo` ranks spawned once for the file
(`tests/torch_rank_cases.py:bg_segments`). Every rank returns the whole
output:

- bit-equal on every rank to this process running the same two blocks of
  2 segments from `init_carries(2)` through `_step_batched`;
- held to the JAX `process_segments` on `make_mesh(4)` (data 2, model 2)
  within the bound `tests/test_torch_fused_bg_seg.py:_within_bound` holds
  this pipeline's `run_segmented` to (`torch_port_util.within_jax_bound`:
  max |diff| <= 4, |diff| > 1 on < 0.1% of pixels), on all 8 channels
  (alpha, segmask, fg, bg); bg_small is JAX's `fetch="device"`
  placeholder, (S, L, 1, 1, 3) zeros;
- S = 3 on the data axis of 2 raises ValueError("... not divisible ...").
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_rank_cases as cases
from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_equal, within_jax_bound
from video_unscreen_tpu.parallel import make_mesh as jax_make_mesh
from video_unscreen_tpu.pipeline.fused_bg import FusedBgPipeline as JPipe
from video_unscreen_tpu_torch.parallel.launch import run_ranks

HW = (96, 128)
S, L = 4, 2


@pytest.fixture(scope="module")
def segments():
    frames, _ = make_clip(n=S * L)
    return np.stack(frames).reshape(S, L, *HW, 3)


@pytest.fixture(scope="module")
def ranks(segments):
    return run_ranks(cases.bg_segments, 4, (segments, BG_TEST_CFG),
                     timeout=240)


@pytest.fixture(scope="module")
def jax_outs(segments):
    pipe = JPipe(BG_TEST_CFG, HW, work_long_side=128,
                 use_stm_tracking=False, fetch="device", pack_d2h=False,
                 matting_dtype=jnp.float32, stm_dtype=jnp.float32,
                 seg_dtype=jnp.float32)
    packed, bg_small = pipe.process_segments(jax_make_mesh(4),
                                             jnp.asarray(segments))
    return np.asarray(packed), np.asarray(bg_small)


def test_bg_segments_equal_one_process(ranks, segments):
    pipe = cases.bg_pipe(BG_TEST_CFG, HW)
    want, = cases.one_process(cases.bg_step(pipe), pipe.init_carries,
                              segments)
    assert want.shape == (S, L) + HW + (8,)
    for rank, r in enumerate(ranks):
        assert r["mesh"][0] == {"data": 2, "model": 2}
        packed, bg_small = r["outs"]
        assert_equal(packed, want, f"rank {rank} packed")
        assert_equal(bg_small, np.zeros((S, L, 1, 1, 3), np.uint8),
                     f"rank {rank} bg_small")
        # the seed on both segments of the first step, none tracked by the
        # STM (off); each step's flag read, its model-axis reduction and
        # the CG checks are host syncs
        assert r["tracking"] == [(False, False), (True, True)]
        assert r["stats"]["steps"] == L and r["stats"]["seed_steps"] == 1
        assert r["stats"]["syncs"] == 2 * L + r["stats"]["cg_syncs"]


def test_bg_segments_against_jax(ranks, jax_outs):
    packed, bg_small = ranks[0]["outs"]
    want_packed, want_small = jax_outs
    assert bg_small.shape == want_small.shape
    for c, name in ((slice(0, 1), "alpha"), (slice(1, 2), "segmask"),
                    (slice(2, 5), "fg"), (slice(5, 8), "bg")):
        within_jax_bound(packed[..., c], want_packed[..., c], name)


def test_bg_indivisible_segments_raise(ranks):
    for r in ranks:
        assert r["indivisible"] is not None
        assert "not divisible" in r["indivisible"]
