"""bg_offline mode: offline global-background unscreen in three
restartable stages.

Port of `video_unscreen_tpu/pipeline/bg_offline.py`:

  stage 1: per frame, the segmask (the seed, or STM tracking of the
           previous alpha), a matte and the per-frame regionfill
           background; `segmask_` and `bg_*.jpg`;
  stage 2: the temporal mean of the frames where the dilated segmask is
           not saturated, and the membrane inpaint of the region that was
           never background (`cnt <= 10`); `always_bg.jpg`;
  stage 3: the per-frame background beta-fused with the global one, the
           background-difference mask, a second matte and the fg
           un-blend; `alphamask_` and `fg_*.jpg`.

`fused=True` (the default) runs stages 1 and 3 through
`FusedBgPipeline.process_chunk_stage{1,3}` at work resolution, and stage 1
also writes the always-bg EMA pair `ema_bg.png` and `ema_seen.png`
(lossless, so that stage 3's `seen > 0` gate survives the store); stage 3
prefers the EMA to the stage-2 mean wherever a pixel was seen as
background. `fused=False` runs the per-frame agents at full resolution.
A stage that runs without the stages before it reads their artifacts
back from `cfg["data"]["dst_img_dir"]` (the artifact-store resume).

Stage 2 runs on the device in chunks of 32 frames: one K2 launch dilates
a chunk's 32 x 3 mask planes, and one batched CG solve fills the three
channels of the 1080p hole.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from glob import glob

import numpy as np
import torch

from .. import runtime
from ..agents.trimap import TrimapAgent
from ..agents.vmatting import VMattingAgent
from ..ops.color import bgr2gray
from ..ops.compositing import get_fg
from ..ops.morphology import dilate
from ..ops.regionfill import regionfill_solve
from ..utils.device import resolve_device
from ..utils.fileio import parallel_read_img, read_png, save_img, save_video
from . import fused_bg
from .bg import _per_frame_background, build_bg_agents
from .common import (artifact_path, exist_foreground_np, host_frames,
                     read_frames, remove_invalid_objects_cfg)
from .fused_green import save_artifacts


def _upload(img, dev) -> torch.Tensor:
    """A uint8 host image as a tensor on `dev` (copied: the caller's array
    may be read-only)."""
    return torch.tensor(np.asarray(img, np.uint8), device=dev)


def _load_artifacts(dst_dir: str, kind: str):
    paths = sorted(glob(osp.join(dst_dir, f"{kind}_*.jpg")))
    return parallel_read_img(paths)


def _stage1(cfg, frame_list, dst_dir, save, device="cuda"):
    """Stage 1 with the per-frame agents at full resolution. Returns
    (segmasks as uint8 (h, w, 3), backgrounds uint8 (h, w, 3))."""
    dev = resolve_device(device)
    segagent, stmagent, trimapagent, vmatagent = build_bg_agents(cfg, dev)
    thr = cfg["fg_exist_thr"]
    h, w = frame_list[0].shape[:2]
    tracking = False
    alpha_pre = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    prev = None
    mask_list, bg_list = [], []
    for fid, host_frame in enumerate(frame_list):
        frame = _upload(host_frame, dev)
        if tracking and fid > 0:
            segmask = torch.where(alpha_pre >= 128, 255, alpha_pre).to(
                torch.uint8)
            segmask = stmagent.forward([prev, frame], segmask)[-1]
        else:
            segmask = segagent.forward(frame)
        seg_np = segmask.cpu().numpy()
        mask_list.append(np.stack([seg_np] * 3, axis=2))
        if save:
            save_img(artifact_path(dst_dir, "segmask", fid), seg_np)
        if not exist_foreground_np(segmask, thr):
            alpha = torch.zeros_like(segmask)
            bg_list.append(np.asarray(host_frame, np.uint8))
        else:
            frame_f = frame.to(torch.float32)
            trimap = trimapagent.forward(
                remove_invalid_objects_cfg(cfg, segmask))
            alpha = vmatagent.forward(frame_f, alpha_pre, trimap)
            bgimg = _per_frame_background(frame_f, alpha).cpu().numpy()
            bg_list.append(bgimg)
            if save:
                save_img(artifact_path(dst_dir, "bg", fid), bgimg)
        alpha_pre = alpha
        prev = frame
        tracking = exist_foreground_np(alpha, thr)
    return mask_list, bg_list


def _stage2_accum(acc, cnt, frames_u8, masks_u8):
    """Fold a chunk of N frames into the masked temporal sums: each
    frame's (3-channel) segmask dilated (K2 k3 it2, the chunk's N x 3
    planes in one launch), the frame added where the dilated mask is not
    exactly 255 (`// 255` keeps only saturated pixels out) and counted
    where it is below 250. `acc`, `cnt` float32 (H, W, 3); `frames_u8`,
    `masks_u8` uint8 (N, H, W, 3) on the same device.

    The JAX package adds frame after frame in a scan; here the chunk is
    summed at once. Every term `frame * bg_weight` is a whole number below
    256, so every partial sum, and `cnt`, is a whole number below 2^24
    for fewer than 65,793 frames: float32 holds them exactly, and any
    order of the additions gives the same bits."""
    n, h, w, _ = masks_u8.shape
    planes = masks_u8.permute(0, 3, 1, 2).contiguous().reshape(n * 3, h, w)
    m = dilate(planes.to(torch.float32), 3, 2)
    m = m.reshape(n, 3, h, w).permute(0, 2, 3, 1)
    bg_weight = 1.0 - torch.floor(m.clamp(0.0, 255.0) / 255.0)
    acc = acc + (frames_u8.to(torch.float32) * bg_weight).sum(0)
    cnt = cnt + (m < 250).to(torch.float32).sum(0)
    return acc, cnt


def _stage2_finalize(acc, cnt):
    """The mean background, zero where a pixel was background in 10
    frames or fewer, and that hole (dilated, K2 k3 it2 on one plane)
    filled by the CG membrane, the three channels in one batched solve.
    Returns (uint8 (H, W, 3), the CG iterations of each channel)."""
    mask_always = (cnt <= 10).to(torch.float32) * 255.0
    bg_always = torch.floor(torch.clamp(acc / cnt.clamp_min(1.0), 0.0,
                                        255.0))
    bg_always = torch.where(mask_always == 255.0, 0.0, bg_always)
    hole = dilate(mask_always[..., 0].contiguous(), 3, 2)
    filled, _, iters = regionfill_solve(
        bg_always.permute(2, 0, 1).contiguous(), hole)
    return (filled.permute(1, 2, 0).clamp(0.0, 255.0).to(torch.uint8),
            iters)


def _stage2(cfg, frame_list, mask_list, bg_always_path, save,
            chunk_size: int = 32, device="cuda"):
    """Stage 2 over chunks of `chunk_size` frames, the segmasks resized to
    the frames' size as cv2.resize does (`runtime.resize_batch`). Returns
    (the global background, uint8 (H, W, 3) numpy; the CG iterations of
    its three channels)."""
    dev = resolve_device(device)
    h, w = frame_list[0].shape[:2]
    acc = torch.zeros((h, w, 3), device=dev)
    cnt = torch.zeros((h, w, 3), device=dev)
    n = len(frame_list)
    for c0 in range(0, n, chunk_size):
        cn = min(chunk_size, n - c0)
        frames = np.stack([np.asarray(f, np.uint8)
                           for f in frame_list[c0:c0 + cn]])
        masks = runtime.resize_batch(
            [np.ascontiguousarray(m, np.uint8)
             for m in mask_list[c0:c0 + cn]], (h, w))
        acc, cnt = _stage2_accum(acc, cnt, torch.from_numpy(frames).to(dev),
                                 torch.from_numpy(masks).to(dev))
    bg_img, iters = _stage2_finalize(acc, cnt)
    bg_img = bg_img.cpu().numpy()
    if save:
        save_img(bg_always_path, bg_img)
    return bg_img, [int(i) for i in iters.cpu()]


def _stage3(cfg, frame_list, mask_list, bg_list, bg_always, dst_dir, save,
            device="cuda"):
    """Stage 3 with the per-frame agents at full resolution. Returns (the
    uint8 (h, w) alphas, the uint8 (h, w, 3) fgs).

    The JAX package's modular stage 3 cannot run: its module never imports
    the `TrimapAgent` and `VMattingAgent` it calls. This is what it means
    to compute, with the port's agents."""
    dev = resolve_device(device)
    trimapagent = TrimapAgent(**cfg["trimap"], device=dev)
    vmatagent = VMattingAgent(**cfg["vmatting"], device=dev)
    beta = cfg["bg_mask"]["fusion_weight"]
    thr = cfg["bg_mask"]["thr"]
    always = _upload(bg_always, dev).to(torch.float32)
    alpha_pre = None
    alphas, fgs = [], []
    for fid, host_frame in enumerate(frame_list):
        frame = _upload(host_frame, dev)
        frame_f = frame.to(torch.float32)
        bgimg = _upload(bg_list[fid], dev)
        bgimg = (bgimg.to(torch.float32) * beta
                 + (1 - beta) * always).to(torch.uint8)
        alpha = _upload(runtime.bgr_to_gray(np.asarray(mask_list[fid],
                                                       np.uint8)), dev)
        alphabg = bgr2gray((frame_f - bgimg.to(torch.float32)).abs())
        alphabg = torch.where(alphabg > thr, 255.0, alphabg)
        alphabg = dilate(alphabg.clamp(0, 255), 4, 2)
        keep = alphabg.to(torch.uint8) // 255
        alpha = (alpha.to(torch.float32) * keep).to(torch.uint8)
        if alpha_pre is None:
            alpha_pre = alpha
        trimap = trimapagent.forward(remove_invalid_objects_cfg(cfg, alpha))
        alpha = vmatagent.forward(frame_f, alpha_pre, trimap)
        alphas.append(alpha.cpu().numpy())
        if save:
            save_img(artifact_path(dst_dir, "alphamask", fid), alphas[-1])
        bgimg = torch.where((alpha == 0)[..., None], frame, bgimg)
        fg = get_fg(frame_f, alpha.to(torch.float32),
                    bgimg.to(torch.float32)).clamp(0, 255).to(torch.uint8)
        fgs.append(fg.cpu().numpy())
        if save:
            save_img(artifact_path(dst_dir, "fg", fid), fgs[-1])
        alpha_pre = alpha
    return alphas, fgs


def _chunked_scan(process_chunk, init_carry, arrays, chunk_size=4,
                  replay_tail=False):
    """Drive a stage scan over host arrays in chunks of `chunk_size`
    frames; returns (final carry, the packed outputs of the N frames,
    (N, ...) uint8 numpy, one fetch a chunk).

    `replay_tail` pads the last chunk by replaying its last frame, as the
    JAX package's scan does, and keeps the carry after those steps. Stage
    1 needs it: the always-bg EMA that stage 1 leaves in the carry blends
    (1 - r) * ema + r * frame, which is not idempotent on a repeated
    frame, so the EMA artifacts (and through them stage 3) depend on the
    replayed steps whenever N is not a multiple of `chunk_size`. Stage 3
    reads only the outputs, whose padded rows are dropped, so it runs no
    padded step."""
    n = arrays[0].shape[0]
    carry = init_carry
    outs = []
    for c0 in range(0, n, chunk_size):
        cn = min(chunk_size, n - c0)
        chunk = [arr[c0:c0 + cn] for arr in arrays]
        if replay_tail and cn < chunk_size:
            chunk = [np.concatenate([part] + [part[-1:]] * (chunk_size - cn))
                     for part in chunk]
        carry, packed = process_chunk(carry, *chunk)
        outs.append(packed[:cn].cpu().numpy())
    return carry, np.concatenate(outs)


def _make_pipe(cfg, frame_hw, work_long_side, use_stm_tracking, device):
    # looked up at call time, as the JAX package imports it
    return fused_bg.FusedBgPipeline(
        cfg, frame_hw, work_long_side=work_long_side,
        use_stm_tracking=use_stm_tracking, device=device)


def _stage1_fused(cfg, frame_list, dst_dir, save, work_long_side,
                  chunk_size=4, use_stm_tracking=True, device="cuda"):
    """Stage 1 through `FusedBgPipeline.process_chunk_stage1` at work
    resolution (the frames resized on the host as cv2.resize does), plus
    the always-bg EMA pair of the final carry. Returns (segmasks uint8
    (h, w, 3), backgrounds uint8 (h, w, 3), the pipeline, (ema_bg uint8
    (h, w, 3), ema_seen uint8 (h, w)))."""
    pipe = _make_pipe(cfg, frame_list[0].shape[:2], work_long_side,
                      use_stm_tracking, device)
    frames_w = host_frames(frame_list, pipe.work_hw)
    pipe.reset_stats()
    carry, packed = _chunked_scan(pipe.process_chunk_stage1,
                                  pipe.init_carry(), [frames_w], chunk_size,
                                  replay_tail=True)
    pipe.count_cg()
    ema_bg = carry.bg_model[0].clamp(0, 255).to(torch.uint8).cpu().numpy()
    ema_seen = ((carry.bg_seen[0] > 0).to(torch.uint8) * 255).cpu().numpy()
    segmasks = np.ascontiguousarray(packed[..., 0])
    bgs = np.ascontiguousarray(packed[..., 1:4])
    mask_list = [np.stack([m] * 3, axis=2) for m in segmasks]
    bg_list = list(bgs)
    if save:
        save_artifacts(dst_dir, (("segmask", segmasks), ("bg", bgs)))
        save_img(osp.join(dst_dir, "ema_bg.png"), ema_bg)
        save_img(osp.join(dst_dir, "ema_seen.png"), ema_seen)
    return mask_list, bg_list, pipe, (ema_bg, ema_seen)


def _stage3_fused(cfg, frame_list, mask_list, bg_list, bg_always, dst_dir,
                  save, work_long_side, pipe=None, chunk_size=4,
                  use_stm_tracking=True, ema=None, device="cuda"):
    """Stage 3 through `FusedBgPipeline.process_chunk_stage3`; the host
    beta-fuses each per-frame background with the global one, which is
    the stage-1 EMA where `ema_seen` is set, else the stage-2 mean.
    Returns (the uint8 (h, w) alphas, the uint8 (h, w, 3) fgs) at work
    resolution."""
    if pipe is None:
        pipe = _make_pipe(cfg, frame_list[0].shape[:2], work_long_side,
                          use_stm_tracking, device)
    hw = pipe.work_hw

    def to_work(img):
        return host_frames([img], hw)[0]

    frames_w = host_frames(frame_list, hw)
    beta = float(cfg["bg_mask"]["fusion_weight"])
    global_bg = to_work(bg_always).astype(np.float32)
    if ema is not None:
        ema_bg, ema_seen = ema
        seen = (to_work(ema_seen) > 127)[..., None]
        global_bg = np.where(seen, to_work(ema_bg).astype(np.float32),
                             global_bg)
    bgs_fused = (host_frames(bg_list, hw).astype(np.float32) * beta
                 + (1.0 - beta) * global_bg).astype(np.uint8)
    segmasks = runtime.bgr_to_gray(host_frames(mask_list, hw))
    _, packed = _chunked_scan(pipe.process_chunk_stage3, pipe.init_carry(),
                              [frames_w, bgs_fused, segmasks], chunk_size)
    alphas = np.ascontiguousarray(packed[..., 0])
    fgs = np.ascontiguousarray(packed[..., 1:4])
    if save:
        save_artifacts(dst_dir, (("alphamask", alphas), ("fg", fgs)))
    return list(alphas), list(fgs)


def _read_ema(dst_dir: str):
    """The stage-1 EMA pair from the store, as (BGR, gray), or None when
    either file is missing."""
    paths = [osp.join(dst_dir, f"ema_{k}.png") for k in ("bg", "seen")]
    if not all(osp.exists(p) for p in paths):
        return None
    ema_bg, ema_seen = (read_png(p) for p in paths)
    if ema_bg.ndim == 2:
        ema_bg = np.repeat(ema_bg[..., None], 3, axis=2)
    if ema_seen.ndim == 3:
        ema_seen = runtime.bgr_to_gray(ema_seen)
    return ema_bg, ema_seen


def run(cfg: dict, frames=None, save: bool = True, stages=(1, 2, 3),
        fused: bool = True, work_long_side: int = 960, chunk_size: int = 4,
        use_stm_tracking: bool = True, device="cuda") -> dict:
    """bg_offline over `frames` (uint8 BGR (H, W, 3) arrays;
    default: the clip of `cfg["data"]` read from disk), running `stages`
    with the artifact-store resume. Returns {"alphas": uint8 alphas and
    "fgs": uint8 fgs (work resolution when fused, else the frames'),
    "numframes": N, "seconds": {stage: host wall seconds}, "always_bg":
    stage 2's global background and "stage2_cg_iters": the CG iterations
    of its three channels (None without stage 2), "ema": stage 1's
    (ema_bg, ema_seen) (fused; None without it)}."""
    dev = resolve_device(device)
    data = cfg["data"]
    dst_dir = data["dst_img_dir"]
    if save:
        os.makedirs(dst_dir, exist_ok=True)
    bg_always_path = osp.join(dst_dir, "always_bg.jpg")

    frame_list = list(frames) if frames is not None else read_frames(cfg)
    mask_list, bg_list, bg_always, alphas, fgs = [], [], None, [], []
    pipe, ema, cg2 = None, None, None
    seconds = {}

    if 1 in stages:
        t0 = time.perf_counter()
        if fused:
            mask_list, bg_list, pipe, ema = _stage1_fused(
                cfg, frame_list, dst_dir, save, work_long_side, chunk_size,
                use_stm_tracking=use_stm_tracking, device=dev)
        else:
            mask_list, bg_list = _stage1(cfg, frame_list, dst_dir, save, dev)
        seconds["stage1"] = time.perf_counter() - t0
    if 2 in stages:
        t0 = time.perf_counter()
        if not mask_list:
            mask_list = _load_artifacts(dst_dir, "segmask")
        bg_always, cg2 = _stage2(cfg, frame_list, mask_list, bg_always_path,
                                 save, device=dev)
        seconds["stage2"] = time.perf_counter() - t0
    stage1_ema = ema
    if 3 in stages:
        t0 = time.perf_counter()
        if not mask_list:
            mask_list = _load_artifacts(dst_dir, "segmask")
        if not bg_list:
            bg_list = _load_artifacts(dst_dir, "bg")
        if bg_always is None:
            bg_always = parallel_read_img([bg_always_path])[0]
        if ema is None:
            ema = _read_ema(dst_dir)
        if fused:
            alphas, fgs = _stage3_fused(cfg, frame_list, mask_list, bg_list,
                                   bg_always, dst_dir, save, work_long_side,
                                   pipe, chunk_size,
                                   use_stm_tracking=use_stm_tracking,
                                   ema=ema, device=dev)
        else:
            alphas, fgs = _stage3(cfg, frame_list, mask_list, bg_list,
                                  bg_always, dst_dir, save, dev)
        seconds["stage3"] = time.perf_counter() - t0
        if save:
            try:
                save_video(dst_dir, osp.join(data["dst_vid_dir"],
                                             f"{data['video_id']}_fg.mp4"))
            except Exception as e:  # the JAX package's best-effort mux
                print(f"save_video skipped: {e}")
    return {"alphas": alphas, "fgs": fgs, "numframes": len(frame_list),
            "seconds": seconds, "always_bg": bg_always if 2 in stages
            else None, "stage2_cg_iters": cg2, "ema": stage1_ema}
