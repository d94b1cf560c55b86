"""Evaluation harness: MIOU / SAD / MSE / GRAD / CONN scoring.

Port of `video_unscreen_tpu/pipeline/evaluate.py`. Each GT/prediction
pair is scored by one chain of device calls (`score_pair`: the five
metrics of `ops/metrics.py`, stacked) and fetched once. The report lines
and the `results/<exp>.txt` artifact keep the JAX package's format
(`_fmt`, the trailing `'` included).

Files are read as cv2.imread(..., IMREAD_GRAYSCALE) reads them
(`utils/fileio.py:read_gray`): PNGs by the port's PNG codec, JPEGs by the
port's own JPEG codec (bit-equal to libjpeg's; `evaluate_pair` runs the
same device work on in-memory arrays). A prediction of
another shape than its GT is resized to it with `runtime.resize_batch`,
bit-equal to cv2.resize's INTER_LINEAR.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import runtime
from ..ops import metrics as M
from ..utils.device import as_float, resolve_device
from ..utils.fileio import read_gray, read_txt_list, write_txt_list

KEYS = ("miou", "sad", "mse", "grad", "conn")


def score_pair(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(5,) float32 (miou, sad, mse, grad, conn) of two (H, W) float32
    alphas on one device, left there."""
    return torch.stack([M.miou(gt, pred), M.sad(gt, pred), M.mse(gt, pred),
                        M.gradient_error(gt, pred),
                        M.connectivity_error(gt, pred)])


def evaluate_pair(gt_img: np.ndarray, pred_img: np.ndarray,
                  device="cuda") -> Tuple[float, ...]:
    """Score one (H, W) uint8 GT/prediction pair: (miou, sad, mse, grad,
    conn)."""
    dev = resolve_device(device)
    if pred_img.shape != gt_img.shape:
        pred_img = runtime.resize_batch([np.ascontiguousarray(pred_img)],
                                        gt_img.shape[:2])[0]
    out = score_pair(as_float(gt_img, dev), as_float(pred_img, dev))
    return tuple(float(v) for v in out.cpu().numpy())


def evaluate_video(gt_paths: List[str], pred_paths: List[str],
                   device="cuda") -> Dict[str, List[float]]:
    """Per-frame scores of the pairs (gt_paths[i], pred_paths[i])."""
    dev = resolve_device(device)
    results = {k: [] for k in KEYS}
    for gt_path, pred_path in zip(gt_paths, pred_paths):
        scores = evaluate_pair(read_gray(gt_path), read_gray(pred_path), dev)
        for k, v in zip(KEYS, scores):
            results[k].append(v)
    return results


def _fmt(key: str, vals: Dict[str, float]) -> str:
    return ("{} MIOU: {:.06g} SAD: {:.06g} MSE: {:.06g} GRAD: {:.06g} "
            "CONN: {:.06g}'".format(key, vals["miou"], vals["sad"],
                                    vals["mse"], vals["grad"], vals["conn"]))


def run(cfg: dict, device="cuda") -> Dict[str, Dict[str, float]]:
    """Score every video of the meta list: per-video means, then "ALL",
    the mean over the videos; printed, and written to
    `cfg["data"]["save_data_fn"]` when it is set."""
    dev = resolve_device(device)
    data = cfg["data"]
    vid_list = read_txt_list(data["meta_fn"])
    per_video: Dict[str, Dict[str, float]] = {}
    save_list = []
    print("-" * 50)
    for vid in vid_list:
        gt_paths = sorted(glob(osp.join(data["gt_data_dir"], vid,
                                        data["gt_data_tmpl"])))
        pred_paths = sorted(glob(osp.join(data["pred_data_dir"], vid,
                                          data["pred_data_tmpl"])))
        res = evaluate_video(gt_paths, pred_paths, dev)
        per_video[vid] = {k: float(np.mean(v)) for k, v in res.items()}
        line = _fmt(vid, per_video[vid])
        print(line)
        save_list.append(line)
    print("-" * 50)
    overall = {k: float(np.mean([v[k] for v in per_video.values()]))
               for k in KEYS}
    line = _fmt("ALL", overall)
    print(line)
    save_list.append(line)
    print("-" * 50)
    if data.get("save_data_fn"):
        os.makedirs(osp.dirname(data["save_data_fn"]), exist_ok=True)
        write_txt_list(data["save_data_fn"], save_list)
    per_video["ALL"] = overall
    return per_video
