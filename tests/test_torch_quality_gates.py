"""The JAX suite's four `slow` quality gates, held on the port with the
shipped weights on the CPU: each gate runs the port's counterpart at the
JAX test's own clip, seed, size, configuration and floor (the
configurations, weight paths and the STM clip maker are imported from the
JAX tests, so the two cannot drift apart).

- `tests/test_bg_occluder.py`: fused bg on the `natural_occl` clip
  (seed 41, 162x288), mean MIOU > 0.78;
- `tests/test_green_mblur.py`: fused green on `green_mblur` (seed 23) >
  0.85 and on the plain clip (seed 4) > 0.93, the adaptive band on;
- `tests/test_stm_trained.py`: the trained STM over a 14-frame clip,
  frame 7 and the last frame > 0.8;
- `tests/test_seg_tta_consistency.py`: the DeepLab seed's 513 grid
  against whole-image TTA at the 962 operating point, and whole-image
  quality at 256.

Tier-1 skips them (`-m 'not slow'`); run them with
`python -m pytest -m slow tests/test_torch_quality_gates.py`.
"""
import os.path as osp

import numpy as np
import pytest
import torch

from tests.test_bg_occluder import HUMAN_W, OCCL_CFG
from tests.test_green_mblur import MBLUR_CFG, W as MBLUR_W
from tests.test_seg_tta_consistency import WEIGHTS as SEG_WEIGHTS
from tests.test_stm_trained import _drifting_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu_torch.ops import metrics as M
from video_unscreen_tpu_torch.ops.geometry import resize
from video_unscreen_tpu_torch.parallel.data_synth import make_eval_clip

CPU = "cpu"


def _miou(gt, pred) -> float:
    """`ops/metrics.py:miou` of a GT and a prediction (any array-like),
    the GT resized to the prediction's shape as the JAX gates do."""
    pred = torch.as_tensor(np.asarray(pred), dtype=torch.float32)
    gt = torch.as_tensor(np.asarray(gt), dtype=torch.float32)
    if gt.shape != pred.shape:
        gt = resize(gt, tuple(pred.shape))
    return float(M.miou(gt, pred))


def _mean_miou(alphas, gts) -> float:
    return float(np.mean([_miou(g, a) for a, g in zip(alphas, gts)]))


@pytest.mark.slow
@pytest.mark.skipif(not osp.exists(HUMAN_W),
                    reason="trained SCHP weights not shipped yet")
def test_bg_mode_occluder_gate():
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    frames, gts = make_eval_clip("natural", n=12, h=162, w=288, seed=41,
                                 variant="occluder")
    h, w = frames[0].shape[:2]
    pipe = FusedBgPipeline(OCCL_CFG, (h, w), work_long_side=288,
                           device=CPU)
    assert pipe.bank_cap >= 2 and pipe.balloon_ratio > 0
    alphas = pipe.run(frames, chunk_size=4)[0]
    mious = [_miou(g, a) for a, g in zip(alphas, gts)]
    assert np.mean(mious) > 0.78, mious


def _green_clip_miou(seed, variant):
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline
    frames, gts = make_eval_clip("green", n=8, h=162, w=288, seed=seed,
                                 variant=variant)
    h, w = frames[0].shape[:2]
    pipe = FusedGreenPipeline(MBLUR_CFG, (h, w), work_long_side=MBLUR_W,
                              device=CPU)
    assert pipe.tri_adaptive
    alphas = pipe.run(frames, chunk_size=4)[0]
    return _mean_miou(alphas, gts)


@pytest.mark.slow
@pytest.mark.parametrize("seed,variant,floor", [
    (23, "motion_blur", 0.85),   # tests/test_green_mblur.py's gate
    (4, "plain", 0.93),          # and its plain-clip bound
])
def test_green_motion_blur_gate(seed, variant, floor):
    m = _green_clip_miou(seed, variant)
    assert m > floor, m


@pytest.mark.slow
def test_trained_stm_long_clip_propagation():
    from video_unscreen_tpu_torch.agents.stm import STMAgent
    frames, gt_masks = _drifting_clip(n=14)
    agent = STMAgent(model_path="weights/stm.msgpack", input_long_side=128,
                     memory_step=2, memory_capacity=10, device=CPU)
    preds = agent.forward(frames, gt_masks[0])
    assert len(preds) == len(frames)
    mid = _miou(gt_masks[7], preds[7].cpu())
    last = _miou(gt_masks[-1], preds[-1].cpu())
    assert mid > 0.8, f"frame 7 MIOU {mid:.3f}"
    assert last > 0.8, f"last-frame MIOU {last:.3f}"


def _seg_miou(agent, frames, gts):
    return _mean_miou([agent.forward(f).cpu() for f in frames], gts)


@pytest.mark.slow
def test_grid_tta_matches_whole_image():
    from video_unscreen_tpu_torch.agents.binseg import SegAgent
    whole = SegAgent(model_path=SEG_WEIGHTS, input_long_side=962,
                     crop_h=962, crop_w=962, flip=True, device=CPU)
    grid = SegAgent(model_path=SEG_WEIGHTS, input_long_side=962,
                    crop_h=513, crop_w=513, stride_ratio=0.5, flip=True,
                    device=CPU)
    gaps = []
    for seed in (4, 11):
        frames, gts = make_eval_clip("green", n=1, h=192, w=256, seed=seed)
        m_whole = _seg_miou(whole, frames, gts)
        m_grid = _seg_miou(grid, frames, gts)
        assert m_whole > 0.8, (seed, m_whole)
        gaps.append(m_whole - m_grid)
        assert m_grid > m_whole - 0.02, (seed, m_grid, m_whole)
    assert np.mean(gaps) < 0.01, gaps


@pytest.mark.slow
def test_whole_image_quality_small_geometry():
    from video_unscreen_tpu_torch.agents.binseg import SegAgent
    frames, gts = make_eval_clip("green", n=2, h=192, w=256, seed=4)
    whole = SegAgent(model_path=SEG_WEIGHTS, input_long_side=256,
                     crop_h=256, crop_w=256, flip=True, device=CPU)
    assert _seg_miou(whole, frames, gts) > 0.9
