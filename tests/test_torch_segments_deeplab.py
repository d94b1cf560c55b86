"""The DeepLab seed's crops over the model axis of 4 ranks on the CPU.

`tests/test_fused_green_sharded.py:test_model_axis_tta_matches_sequential`
for the port, with the shipped `weights/deeplab_binseg.msgpack`, float32,
on a (data 2, model 2) mesh of 4 `gloo` ranks spawned once for the file
(`tests/torch_rank_cases.py:deeplab_cases`). The crop grid (96 x 96
crops at stride 24 over a 96 x 128 frame, no flip) has 3 crops, which the
model axis of 2 does not divide: rank (d, 0) forwards crops 0 and 1, rank
(d, 1) crop 2 and a pad crop of weight 0.

- `_tta_scores_sharded` (through `predict_scores(frames, model_axis)`)
  matches the unsharded scores to 1e-5 (the order of the float sums
  differs);
- `process_segments` of S = 4 segments of 2 frames matches this process
  running the same two blocks without a model axis within JAX's
  `assert_artifacts_close` (< 0.1% of pixels off by more than 2): not bit
  for bit, since the seed's sums are added in another order;
- the ranks of a model axis decide the seed together: when rank (d, 1)
  says segment 0 tracks and rank (d, 0) says it does not, both seed both
  segments (the OR of their flags), and both forward their crops.
"""
import numpy as np
import pytest

from tests import torch_rank_cases as cases
from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, assert_equal
from video_unscreen_tpu_torch.agents.binseg import _crop_grid
from video_unscreen_tpu_torch.parallel.launch import run_ranks

HW = (96, 128)
S, L = 4, 2
CFG = dict(TEST_CFG, binseg={
    "type": "deeplab", "model_path": "weights/deeplab_binseg.msgpack",
    "input_long_side": 128, "crop_h": 96, "crop_w": 96,
    "stride_ratio": 0.25, "flip": False})


def assert_artifacts_close(par, seq, max_bad_frac=1e-3):
    """`tests/test_fused_green_sharded.py:assert_artifacts_close`."""
    diff = np.abs(np.asarray(par, np.int32) - np.asarray(seq, np.int32))
    bad = (diff > 2).mean()
    assert bad < max_bad_frac, (bad, diff.max())


@pytest.fixture(scope="module")
def segments():
    frames, _ = make_clip(n=S * L)
    return np.stack(frames).reshape(S, L, *HW, 3)


@pytest.fixture(scope="module")
def ranks(segments):
    return run_ranks(cases.deeplab_cases, 4, (segments, CFG), timeout=240)


def test_crop_count_is_not_divisible_by_the_model_axis():
    b = CFG["binseg"]
    locs = _crop_grid(*HW, b["crop_h"], b["crop_w"], b["stride_ratio"],
                      b["flip"])
    assert len(locs) == 3


@pytest.mark.parametrize("rank", range(4))
def test_sharded_scores_match_unsharded(ranks, rank):
    r = ranks[rank]
    assert r["sharded"].shape == (2,) + HW + (2,)
    assert_close(r["sharded"], r["whole"], rtol=1e-5,
                 what=f"rank {rank} scores")
    # the seed sees both classes: the masks are not trivially equal
    fg = r["whole"][..., 1] > r["whole"][..., 0]
    assert 0.0 < fg.mean() < 1.0


def test_pipeline_matches_one_process(ranks, segments):
    pipe = cases.green_pipe(CFG, HW)
    packed, bg_colors = cases.one_process(cases.green_step(pipe),
                                          pipe.init_carries, segments)
    for rank, r in enumerate(ranks):
        assert_equal(r["packed"], ranks[0]["packed"], f"rank {rank}")
        for s in range(S):
            assert_artifacts_close(r["packed"][s], packed[s])
        np.testing.assert_allclose(r["bg_colors"], bg_colors, atol=1e-2)


def test_model_axis_decides_the_seed_together(ranks):
    for r in ranks:
        assert r["disagree_tracking"] == (False, False)
        assert r["disagree_forwards"] == 1
