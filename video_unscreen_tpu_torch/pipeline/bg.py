"""bg mode: online background-estimation unscreen, the modular pipeline.

Port of `video_unscreen_tpu/pipeline/bg.py:run`. Per frame:

    seed (chroma) on frame 0 and after a tracking loss, else STM tracking
    from the previous alpha over the frames [fid - 1, fid] ->
    object removal -> trimap -> matting pass 1 ->
    per-frame background: (1 - a) * frame, regionfill of each BGR channel
    behind the binarized, dilated alpha ->
    background-difference mask: gray(|frame - bg|) > bg_mask.thr, dilated
    -> object removal -> trimap -> matting pass 2 on alpha * bgmask ->
    foreground un-blend.

Every stage runs on the agents' device; frames go up once each and the
stages hand uint8 tensors to each other, with the JAX run's numpy
truncations (`clip(0, 255).astype(uint8)`, `// 255`) as tensor casts. The
host reads two flags per frame (the foreground gates) and the regionfill's
convergence check. The clip comes from disk unless frames are passed;
`save` writes `segmask_`, `bg_`, `alphamask_` and `fg_*.jpg` (gray masks)
as the JAX driver does.
"""

from __future__ import annotations

import time

import torch

from ..agents.binseg import build_seg_agent
from ..agents.stm import STMAgent
from ..agents.trimap import TrimapAgent
from ..agents.vmatting import VMattingAgent
from ..ops.color import bgr2gray
from ..ops.compositing import get_bg, get_fg
from ..ops.morphology import dilate
from ..ops.regionfill import regionfill_solve
from ..utils.device import resolve_device
from ..utils.fileio import save_img
from .common import (artifact_path, exist_foreground_np, read_frames,
                     remove_invalid_objects_cfg)

# Config keys of the `stm` section that only the fused bg pipeline reads;
# STMAgent does not take them, so the modular pipeline drops them.
FUSED_ONLY_STM_KEYS = ("fused_bank_capacity", "balloon_ratio")


def build_bg_agents(cfg: dict, device="cuda"):
    """(seed segmenter, STM, trimap, matting) agents from a config dict."""
    seg_cfg = dict(cfg["binseg"])
    seg_cfg.setdefault("type", "human")
    stm_kw = {k: v for k, v in cfg["stm"].items()
              if k not in FUSED_ONLY_STM_KEYS}
    return (build_seg_agent(seg_cfg, device=device),
            STMAgent(**stm_kw, device=device),
            TrimapAgent(**cfg["trimap"], device=device),
            VMattingAgent(**cfg["vmatting"], device=device))


def _per_frame_background(frame: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """bg = (1 - a) * frame, then regionfill of each BGR channel behind the
    dilated binarized alpha. `frame` (H, W, 3) float, `alpha` (H, W)
    uint8; returns the uint8 (H, W, 3) background."""
    a = alpha.to(torch.float32)
    bg = get_bg(a, frame)
    alpha_bin = dilate(torch.where(a > 128, 255.0, 0.0), 3, 2)
    filled, _, _ = regionfill_solve(bg.permute(2, 0, 1).contiguous(),
                                    alpha_bin)
    return filled.permute(1, 2, 0).clamp(0, 255).to(torch.uint8)


@torch.inference_mode()
def run(cfg: dict, frames=None, save: bool = False, device="cuda") -> dict:
    """bg mode over `frames` (a list of BGR uint8 (H, W, 3) arrays; default:
    the clip of `cfg["data"]` read from disk); `save` writes the artifacts
    into `cfg["data"]["dst_img_dir"]`. Returns {"alphas": [uint8 (H, W)
    numpy], "fgs": [uint8 (H, W, 3) numpy], "numframes": N,
    "frame_seconds": [host wall seconds of each frame, from its upload to
    the read of its foreground gate]}."""
    dev = resolve_device(device)
    if frames is None:
        frames = read_frames(cfg)
    dst = cfg["data"]["dst_img_dir"] if save else None

    def write(kind, fid, img):
        if save:
            save_img(artifact_path(dst, kind, fid), img.cpu().numpy())

    segagent, stmagent, trimapagent, vmatagent = build_bg_agents(cfg, dev)
    thr = cfg["fg_exist_thr"]
    h, w = frames[0].shape[:2]
    tracking = False
    alpha_pre = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    prev = None
    alphas, fgs, seconds = [], [], []
    for fid, host_frame in enumerate(frames):
        t0 = time.perf_counter()
        frame = torch.as_tensor(host_frame).to(dev)
        if tracking and fid > 0:
            segmask = torch.where(alpha_pre >= 128, 255, alpha_pre).to(
                torch.uint8)
            segmask = stmagent.forward([prev, frame], segmask)[-1]
        else:
            segmask = segagent.forward(frame)
        write("segmask", fid, segmask)

        if not exist_foreground_np(segmask, thr):
            fg = torch.zeros_like(frame)
            alpha = torch.zeros_like(segmask)
        else:
            frame_f = frame.to(torch.float32)
            # matting pass 1
            trimap = trimapagent.forward(
                remove_invalid_objects_cfg(cfg, segmask))
            alpha = vmatagent.forward(frame_f, alpha_pre, trimap)
            bgimg = _per_frame_background(frame_f, alpha)
            write("bg", fid, bgimg)
            # background-difference mask
            alphabg = bgr2gray((frame_f - bgimg.to(torch.float32)).abs())
            alphabg = torch.where(alphabg > cfg["bg_mask"]["thr"], 255.0,
                                  alphabg)
            alphabg = dilate(alphabg.clamp(0, 255), 4, 2)
            # matting pass 2 on alpha * bgmask
            keep = alphabg.to(torch.uint8) // 255
            alpha_ensm = (alpha.to(torch.float32)
                          * keep.to(torch.float32)).to(torch.uint8)
            trimap = trimapagent.forward(
                remove_invalid_objects_cfg(cfg, alpha_ensm))
            alpha = vmatagent.forward(frame_f, alpha_pre, trimap)
            write("alphamask", fid, alpha)
            # foreground
            bgimg = torch.where((alpha == 0)[..., None], frame, bgimg)
            fg = get_fg(frame_f, alpha.to(torch.float32),
                        bgimg.to(torch.float32)).clamp(0, 255).to(
                            torch.uint8)
            write("fg", fid, fg)
        alphas.append(alpha)
        fgs.append(fg)
        alpha_pre = alpha
        prev = frame
        tracking = exist_foreground_np(alpha, thr)
        seconds.append(time.perf_counter() - t0)
    return {"alphas": [a.cpu().numpy() for a in alphas],
            "fgs": [f.cpu().numpy() for f in fgs],
            "numframes": len(frames), "frame_seconds": seconds}
