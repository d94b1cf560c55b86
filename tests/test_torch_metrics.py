"""The evaluation protocol of the port against the JAX package on the CPU:
each metric of `ops/metrics.py` on seeded blurred blobs at 96x128, the
masks that test CONN's labelling (two components of equal area, a snake
across the mask, the empty and the full mask), `roi_sad`, and
`pipeline/evaluate.py:run` against the JAX `run_eval` on a small set on
disk (2 clips x 3 frames, PNG GTs, gray JPEG predictions written by the
port's codec, one of another size), down to the `results/*.txt` lines.

Tolerance: every score to 1e-5 relative (`miou`, `sad`, `mse` and `roi_sad`
are sums of identical float32 terms in another order; `grad` a float32
correlation in another order, measured 3.5e-7; `conn` the same labels and
float32 thresholds bit for bit, its sum in another order, measured 5.8e-7).
"""
import os
import os.path as osp

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_util import tt
from video_unscreen_tpu.ops import metrics as jm
from video_unscreen_tpu.pipeline import run_eval as j_run_eval
from video_unscreen_tpu_torch.ops import metrics as tm
from video_unscreen_tpu_torch.ops.kernels.cc_masks import hard_mask
from video_unscreen_tpu_torch.pipeline import evaluate
from video_unscreen_tpu_torch.utils.fileio import save_img, write_png

HW = (96, 128)
METRICS = ("miou", "sad", "roi_sad", "mse", "gradient_error",
           "connectivity_error")
RTOL = 1e-5


def _blobs(seed, h=HW[0], w=HW[1]):
    """(gt, pred) float32 0..255: blurred ellipses and a bar, and a
    prediction shifted, noised and with one blob dropped."""
    rng = np.random.RandomState(seed)
    a = np.zeros((h, w), np.float32)
    for _ in range(3):
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4,
                                                              3 * w // 4)
        ay, ax = rng.randint(h // 10, h // 4), rng.randint(w // 10, w // 4)
        cv2.ellipse(a, (cx, cy), (ax, ay), int(rng.randint(180)), 0, 360,
                    255.0, -1)
    a[5:h - 5, 3:6] = 255.0
    gt = cv2.GaussianBlur(a, (0, 0), 2.0 + seed)
    pred = np.roll(gt, (seed + 1, 2), (0, 1))
    pred = pred + rng.randn(h, w).astype(np.float32) * 12.0
    pred[:, w - w // 5:] = 0.0
    return (np.round(gt).astype(np.float32),
            np.clip(np.round(pred), 0, 255).astype(np.float32))


def _check(name, gt, pred):
    want = float(getattr(jm, name)(jnp.asarray(gt), jnp.asarray(pred)))
    got = float(getattr(tm, name)(tt(gt), tt(pred)))
    assert abs(got - want) <= RTOL * max(abs(want), 1e-12), (name, got,
                                                             want)
    return got


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_matches_jax(name, seed):
    _check(name, *_blobs(seed))


def test_thresholds_bit_for_bit():
    want = np.asarray(jnp.arange(1, 12) * 0.1)
    np.testing.assert_array_equal(tm.thresholds(0.1), want)
    np.testing.assert_array_equal(
        tm.thresholds(0.1) - np.float32(0.1),
        np.asarray(jnp.arange(1, 12) * 0.1 - 0.1))


def test_conn_equal_area_tie():
    """Two components of 100 pixels each. B, a 10x10 square, ends (its
    last pixel in raster order) before A, a 2x50 bar that starts above
    it, so B has the smaller label and wins the tie at every threshold
    up to 0.3, where A's prediction (100) falls off: A's pixels then get
    round_down 0 and cost |a - p| / 1000 = 0.061, B's nothing. Had A
    won, the error would be 0.07."""
    gt = np.zeros(HW, np.float32)
    gt[0:50, 5:7] = 255.0          # A
    gt[10:20, 60:70] = 255.0       # B
    pred = gt.copy()
    pred[0:50, 5:7] = 100.0
    got = _check("connectivity_error", gt, pred)
    b_wins = 100 * (1.0 - 100.0 / 255.0) / 1000.0
    a_wins = 100 * (1.0 - 0.3) / 1000.0
    assert abs(got - b_wins) < 1e-5 and abs(got - a_wins) > 5e-3


@pytest.mark.parametrize("case", ["snake", "empty", "full", "empty_gt"])
def test_conn_hard_masks(case):
    """A one-pixel snake across every 32-pixel tile edge (one component
    threaded through the whole frame) against a prediction broken into
    pieces; the empty mask (no component at any threshold), the full
    mask, and an empty GT under a full prediction."""
    if case == "snake":
        gt = hard_mask("snake", *HW) * (200.0 / 255.0)
        pred = gt.copy()
        pred[:, ::17] = 0.0
        pred[30:40] *= 0.5
    elif case == "empty":
        gt = pred = np.zeros(HW, np.float32)
    elif case == "full":
        gt = np.full(HW, 255.0, np.float32)
        pred = np.full(HW, 180.0, np.float32)
    else:
        gt, pred = np.zeros(HW, np.float32), np.full(HW, 255.0, np.float32)
    for name in ("connectivity_error", "miou", "roi_sad"):
        _check(name, np.round(gt), np.round(pred))


def _write_set(root):
    """2 clips x 3 frames: PNG GTs (one 3-channel), gray JPEG predictions
    written by the port's codec, one of them at 72x96."""
    os.makedirs(osp.join(root, "meta"))
    vids = ("clip_a", "clip_b")
    with open(osp.join(root, "meta", "vid_list2.txt"), "w") as f:
        f.write("\n".join(vids) + "\n")
    for v, vid in enumerate(vids):
        for i in range(3):
            gt, pred = _blobs(3 * v + i)
            gt, pred = gt.astype(np.uint8), pred.astype(np.uint8)
            gt_path = osp.join(root, "alpha_img", vid, f"frame_{i:06d}.png")
            os.makedirs(osp.dirname(gt_path), exist_ok=True)
            write_png(gt_path, np.repeat(gt[..., None], 3, -1)
                      if (v, i) == (1, 0) else gt)
            if (v, i) == (0, 1):
                pred = cv2.resize(pred, (96, 72))
            save_img(osp.join(root, "exp_img", vid, f"alphamask_{i:06d}.jpg"),
                     pred)
    return vids


def _cfg(root, out):
    return {"data": {
        "range": None, "meta_fn": osp.join(root, "meta", "vid_list2.txt"),
        "gt_data_dir": osp.join(root, "alpha_img"), "gt_data_tmpl": "*.*",
        "pred_data_dir": osp.join(root, "exp_img"),
        "pred_data_tmpl": "alphamask_*.*",
        "save_data_fn": osp.join(root, "results", out)}}


def _parse(path):
    rows = []
    for line in open(path).read().splitlines():
        words = line.split()
        rows.append((words[0], [float(words[i].rstrip("'"))
                                for i in range(2, len(words), 2)]))
    return rows


def test_run_matches_jax_run_eval(tmp_path):
    root = str(tmp_path)
    vids = _write_set(root)
    want = j_run_eval(_cfg(root, "jax.txt"))
    got = evaluate.run(_cfg(root, "torch.txt"), device="cpu")
    assert list(got) == list(want) == list(vids) + ["ALL"]
    for vid in want:
        for k in evaluate.KEYS:
            assert abs(got[vid][k] - want[vid][k]) <= \
                RTOL * max(abs(want[vid][k]), 1e-12), (vid, k)
    rows_j = _parse(osp.join(root, "results", "jax.txt"))
    rows_t = _parse(osp.join(root, "results", "torch.txt"))
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    for (_, vals_t), (_, vals_j) in zip(rows_t, rows_j):
        np.testing.assert_allclose(vals_t, vals_j, rtol=2 * RTOL)
    # each line in the JAX format: the five labels and the closing quote
    line = open(osp.join(root, "results", "torch.txt")).read().splitlines()[0]
    assert line.startswith("clip_a MIOU: ") and line.endswith("'")
    assert [w for w in line.split() if w.endswith(":")] == [
        "MIOU:", "SAD:", "MSE:", "GRAD:", "CONN:"]


def test_read_gray_matches_cv2(tmp_path):
    """The readers of the evaluation give what cv2.imread's
    IMREAD_GRAYSCALE gives: gray and colour JPEGs of the port's codec (a
    colour file's luma plane), gray and colour PNGs (libpng's truncating
    rgb-to-gray, every mixed triple of a random image)."""
    from video_unscreen_tpu_torch.utils.fileio import read_gray
    rng = np.random.RandomState(0)
    img = cv2.GaussianBlur(rng.randint(0, 256, (61, 83, 3)).astype(np.uint8),
                           (7, 7), 2)
    big = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    big[0, :, :] = np.arange(256)[:, None]   # B = G = R
    for name, im in (("g.jpg", img[..., 1].copy()), ("c.jpg", img),
                     ("g.png", img[..., 0].copy()), ("c.png", big)):
        p = str(tmp_path / name)
        save_img(p, im)
        np.testing.assert_array_equal(read_gray(p),
                                      cv2.imread(p, cv2.IMREAD_GRAYSCALE),
                                      err_msg=name)


def test_evaluate_pair_resizes_as_cv2():
    gt, pred = _blobs(4)
    gt, pred = gt.astype(np.uint8), pred.astype(np.uint8)
    small = cv2.resize(pred, (96, 72))
    got = evaluate.evaluate_pair(gt, small, device="cpu")
    want = evaluate.evaluate_pair(gt, cv2.resize(small, (128, 96)),
                                  device="cpu")
    assert got == want
