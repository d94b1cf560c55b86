"""Green mode, the modular driver: chroma-key unscreen frame by frame.

Port of `video_unscreen_tpu/pipeline/green.py:run` (what
`tools/unscreen/green.py` runs without `--fused`). Per frame:

    segmentation (the seed, or the previous alpha while tracking) ->
    color filtering (GMM refit every `colorfiltering_update_duration`-th
    frame, after a tracking loss or while untrained; else predict) ->
    object removal -> trimap + matting -> color correction ->
    foreground un-blend

at the frame's own resolution, with the agents' host API. Every stage runs
on the agents' device and hands uint8 tensors to the next, as the JAX
driver hands numpy arrays; each stage's wall time ends with a device sync,
so the per-stage runtime includes the stage's device work, as the JAX
driver's numpy hand-offs make it do. Artifacts: `alphamask_` (gray),
`fg_` and `bg_*.jpg`.
"""

from __future__ import annotations

import time

import torch

from ..agents.binseg import build_seg_agent
from ..agents.colorfiltering import ColorFilteringAgent
from ..agents.trimap import TrimapAgent
from ..agents.vmatting import VMattingAgent
from ..ops.compositing import color_correct, get_fg
from ..utils.device import resolve_device
from ..utils.fileio import save_img
from .common import (artifact_path, exist_foreground_np, print_statistic,
                     read_frames, remove_invalid_objects_cfg)

STAGES = ("seg", "color_filter", "object_removal", "matting",
          "color_correct", "getfg")


@torch.inference_mode()
def run(cfg: dict, frames=None, save: bool = True, device="cuda") -> dict:
    """Run green-mode unscreen over `frames` (BGR uint8 (H, W, 3) arrays;
    default: the clip of `cfg["data"]` read from disk). Returns
    {"alphas": [uint8 (H, W) numpy], "runtime": {stage: seconds},
    "tracking_count": frames that took the tracking shortcut,
    "numframes": N}."""
    dev = resolve_device(device)
    data = cfg.get("data", {})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    st = time.time()
    segagent = build_seg_agent(cfg["binseg"], dev)
    trimapagent = TrimapAgent(**cfg["trimap"], device=dev)
    vmatagent = VMattingAgent(**cfg["vmatting"], device=dev)
    cfagent = ColorFilteringAgent(**cfg["colorfiltering"], device=dev)
    print(f"Building Agents Done! {time.time() - st:.2f}s")

    st = time.time()
    frame_list = list(frames) if frames is not None else read_frames(cfg)
    numframes = len(frame_list)
    h, w, _ = frame_list[0].shape
    print(f"{numframes} frames. Reading Data Done! {time.time() - st:.2f}s")

    thr = cfg["fg_exist_thr"]
    tracking_count = 0
    runtime = {k: 0.0 for k in STAGES}
    cfagent.reset_gmms()
    tracking = False
    alpha_pre = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    alphas = []

    for fid, host_frame in enumerate(frame_list):
        frame = torch.as_tensor(host_frame).to(dev)
        # 1. segmentation, or the tracking shortcut
        st = time.time()
        if tracking:
            segmask = alpha_pre
            tracking_count += 1
        else:
            segmask = segagent.forward(frame)
        sync()
        runtime["seg"] += time.time() - st

        if not exist_foreground_np(segmask, thr):
            alpha = torch.zeros_like(segmask)
            fg = torch.zeros_like(frame)
            bgimg = frame
        else:
            # the color filter's refit schedule
            if (fid % cfg["colorfiltering_update_duration"] == 0
                    or not tracking or not cfagent.is_trained()):
                cf_iters = cfg["colorfiltering_train_iters"]
            else:
                cf_iters = 0

            # 2. color filtering
            st = time.time()
            alphacf, bgimg, _ = cfagent.forward(frame, segmask,
                                                iters=cf_iters)
            bg_color = bgimg[0, 0]
            sync()
            runtime["color_filter"] += time.time() - st

            # 3. invalid-object removal (segmask consensus unless tracking)
            st = time.time()
            alphaor = remove_invalid_objects_cfg(
                cfg, alphacf, None if tracking else segmask)
            sync()
            runtime["object_removal"] += time.time() - st

            # 4. trimap + matting
            st = time.time()
            trimap = trimapagent.forward(alphaor, frame, bg_color)
            alpha = vmatagent.forward(frame, alpha_pre, trimap)
            sync()
            runtime["matting"] += time.time() - st

            # 5. color correction
            st = time.time()
            frame_f = frame.to(torch.float32)
            alpha = color_correct(frame_f, alpha.to(torch.float32),
                                  bg_color.to(torch.float32)).clamp(
                                      0, 255).to(torch.uint8)
            sync()
            runtime["color_correct"] += time.time() - st

            # 6. foreground un-blend against bg = alpha < 128 ? frame :
            # the screen color
            st = time.time()
            bgimg = torch.where((alpha < 128)[..., None], frame, bgimg)
            fg = get_fg(frame_f, alpha.to(torch.float32),
                        bgimg.to(torch.float32)).clamp(0, 255).to(
                            torch.uint8)
            sync()
            runtime["getfg"] += time.time() - st

        if save:
            dst = data["dst_img_dir"]
            save_img(artifact_path(dst, "fg", fid), fg.cpu().numpy())
            save_img(artifact_path(dst, "alphamask", fid),
                     alpha.cpu().numpy())
            save_img(artifact_path(dst, "bg", fid), bgimg.cpu().numpy())
        alphas.append(alpha)

        tracking = exist_foreground_np(alpha, thr)
        alpha_pre = alpha

    print_statistic(runtime, tracking_count, numframes)
    return {"alphas": [a.cpu().numpy() for a in alphas], "runtime": runtime,
            "tracking_count": tracking_count, "numframes": numframes}
