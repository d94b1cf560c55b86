"""Fused green mode: the whole per-frame stage chain on the device.

Port of `video_unscreen_tpu/pipeline/fused_green.py` for one clip segment
(S=1) with the weights-free chroma seed:

    host:   upload each uint8 frame
    device: resize to work resolution ->
            seg (tracking shortcut | chroma seed) ->
            color filter (refit every `colorfiltering_update_duration`-th
            frame, after a tracking loss, or while untrained; else predict)
            -> object removal -> trimap (displacement-adaptive band) ->
            matting UNet -> color correct -> fg un-blend
    host:   fetch uint8 alpha, fg, bg at work resolution

The JAX package compiles one `lax.scan` whose gates are `lax.cond`s. Here
torch runs eagerly and the gates are host branches: each frame reads two
device scalars (the tracking and refit flags, then the band tier), so only
the taken branch runs, as with `lax.cond`. Data-dependent selects inside a
stage stay `torch.where`.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..agents.colorfiltering import CFState, ColorFilteringAgent
from ..agents.vmatting import VMattingAgent
from ..ops.chroma import chroma_segment
from ..ops.compositing import color_correct, get_fg, is_pixel_inrange
from ..ops.connected import remove_invalid_objects_ds
from ..ops.geometry import get_target_size, resize
from ..ops.morphology import dilate
from ..ops.trimap import generate_trimap_withbg
from ..utils.device import resolve_device
from .common import build_score_map


class GreenCarry(NamedTuple):
    alpha_pre: torch.Tensor  # (H, W) work-res alpha of the previous frame
    tracking: torch.Tensor   # 0-d bool
    cf_state: CFState
    fid: torch.Tensor        # 0-d int32


def _build_seed_segmenter(cfg_binseg: dict):
    """None for the chroma seed, the only seed ported so far. `type`
    defaults to "deeplab" when a model_path is configured, as in the JAX
    package."""
    kind = cfg_binseg.get("type")
    if kind is None:
        kind = "deeplab" if cfg_binseg.get("model_path") else "chroma"
    if kind != "chroma":
        raise NotImplementedError(
            f"binseg type {kind!r}: the DeepLab and SCHP seeds are not "
            "ported yet; set binseg to {'type': 'chroma'}")
    return None


def seed_mask(seg, frame: torch.Tensor) -> torch.Tensor:
    """Non-tracking seed mask (the chroma prior)."""
    return chroma_segment(frame)[0]


class FusedGreenPipeline:
    """Green-mode runner for one clip geometry."""

    def __init__(self, cfg: dict, frame_hw: Tuple[int, int],
                 work_long_side: int = 960, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seg = _build_seed_segmenter(cfg.get("binseg", {}))
        self.ori_hw = tuple(frame_hw)
        self.work_hw = get_target_size(frame_hw[0], frame_hw[1],
                                       work_long_side, division=32)
        self.cf = ColorFilteringAgent(**{
            k: v for k, v in cfg["colorfiltering"].items()
            if k != "input_long_side"}, input_long_side=work_long_side,
            device=self.device)
        self.vmat = VMattingAgent(
            model_path=cfg["vmatting"].get("model_path"),
            input_long_side=work_long_side, device=self.device)
        self.score_map = torch.from_numpy(np.array(build_score_map(
            self.work_hw[0], self.work_hw[1], cfg))).to(self.device)
        self.fg_exist_thr = float(cfg["fg_exist_thr"])
        self.cf_duration = int(cfg["colorfiltering_update_duration"])
        self.cf_train_iters = int(cfg["colorfiltering_train_iters"])
        self.saliency_thr = float(cfg["objectremoval"]["saliency_thr"])
        self.consensus_thr = float(cfg["objectremoval"]["consensus_thr"])
        self.or_downscale = int(cfg["objectremoval"].get("downscale", 2))
        # color_correct's distance map at half the work resolution, as the
        # JAX pipeline's default cc_downscale=2
        self.cc_long_side = max(self.work_hw) // 2
        tri = cfg["trimap"]
        self.tri_kernel = int(tri["kernelsize"])
        self.tri_iters = int(tri["iters"])
        self.tri_winsize = tuple(int(v) for v in tri["color_winsize"])
        # displacement-adaptive outward band: 2x/4x/8x the dilate width
        # when the mask centroid moved > 2/4/5 x iters px since last frame
        self.tri_adaptive = bool(tri.get("adaptive_band", True))
        self.tri_tiers = (1, 2, 4, 8)

    def init_carry(self) -> GreenCarry:
        h, w = self.work_hw
        dev = self.device
        return GreenCarry(
            alpha_pre=torch.zeros((h, w), dtype=torch.float32, device=dev),
            tracking=torch.tensor(False, device=dev),
            cf_state=self.cf.reset_gmms(),
            fid=torch.tensor(0, dtype=torch.int32, device=dev))

    # -- per-frame step ------------------------------------------------------
    def _prep_frame(self, frame_full: torch.Tensor) -> torch.Tensor:
        """uint8 (H, W, 3) on the device -> float32 at work resolution."""
        return resize(frame_full.to(torch.float32), self.work_hw)

    def _step(self, carry: GreenCarry, frame_full: torch.Tensor):
        frame = self._prep_frame(frame_full)
        tracking, refit = torch.stack(
            [carry.tracking, self._cf_refit_flag(carry)]).tolist()
        # the seed runs only on frames that lost tracking
        segmask = carry.alpha_pre if tracking else seed_mask(self.seg, frame)
        return self._post_seg(carry, frame, segmask, refit)

    def _cf_refit_flag(self, carry: GreenCarry) -> torch.Tensor:
        """Refit schedule: every `cf_duration`-th frame, after a tracking
        loss, or while the GMMs are untrained."""
        return ((carry.fid % self.cf_duration == 0)
                | ~carry.tracking | ~carry.cf_state.trained)

    def _band_tier(self, alpha_pre: torch.Tensor,
                   alpha_now: torch.Tensor) -> torch.Tensor:
        """Band-width tier 0..3 from the mask-centroid displacement between
        the previous matte and the current chroma alpha."""
        if not self.tri_adaptive:
            return torch.tensor(0, device=self.device)
        h, w = self.work_hw
        ys = torch.arange(h, dtype=torch.float32, device=self.device)
        xs = torch.arange(w, dtype=torch.float32, device=self.device)

        def centroid(m):
            wgt = (m >= 128).to(torch.float32)
            tot = wgt.sum()
            cy = (wgt.sum(dim=1) * ys).sum() / tot.clamp_min(1.0)
            cx = (wgt.sum(dim=0) * xs).sum() / tot.clamp_min(1.0)
            return cy, cx, tot

        cy0, cx0, t0 = centroid(alpha_pre)
        cy1, cx1, t1 = centroid(alpha_now)
        disp = torch.sqrt((cy1 - cy0) ** 2 + (cx1 - cx0) ** 2)
        it = float(self.tri_iters)
        tier = torch.where(disp > 5.0 * it, 3,
                           torch.where(disp > 4.0 * it, 2,
                                       torch.where(disp > 2.0 * it, 1, 0)))
        return torch.where((t0 > 0) & (t1 > 0), tier, 0)

    def _gen_trimap(self, alphaor: torch.Tensor, frame: torch.Tensor,
                    bg_color: torch.Tensor, tier: int) -> torch.Tensor:
        """Trimap with a tier-selected OUTWARD band widening: in a ring of
        `dilate(mask, k, iters * {2, 4, 8})`, background pixels become
        unknown unless the chroma window confirms them as screen color."""
        base = generate_trimap_withbg(alphaor, frame, bg_color,
                                      self.tri_kernel, self.tri_iters,
                                      self.tri_winsize)
        if not self.tri_adaptive or tier == 0:
            return base
        wide = dilate(alphaor, self.tri_kernel,
                      self.tri_iters * self.tri_tiers[tier])
        bg_like = is_pixel_inrange(frame, bg_color, self.tri_winsize)
        return torch.where((base == 0.0) & (wide >= 128.0) & ~bg_like, 128.0,
                           base)

    def _post_seg(self, carry: GreenCarry, frame: torch.Tensor,
                  segmask: torch.Tensor, refit: bool):
        """Color filter (refit or predict), then everything after."""
        alphacf, bg_color, _, cf_state = self.cf.device_forward_impl(
            frame, segmask, self.cf_train_iters if refit else 0,
            carry.cf_state)
        tier = int(self._band_tier(carry.alpha_pre, alphacf))
        return self._post_cf(carry, frame, segmask, alphacf, bg_color,
                             cf_state, tier)

    def _post_cf(self, carry: GreenCarry, frame: torch.Tensor,
                 segmask: torch.Tensor, alphacf: torch.Tensor,
                 bg_color: torch.Tensor, cf_state: CFState, tier: int):
        """Object removal -> trimap -> matting -> color correct -> fg.

        Returns (new carry, (alpha, fg, bg) uint8 at work resolution)."""
        h, w = self.work_hw
        fg_exists = (segmask >= 128).sum() > self.fg_exist_thr * h * w

        # invalid-object removal (segmask consensus unless tracking),
        # labeled at 1/or_downscale resolution
        consensus_ref = torch.where(carry.tracking, alphacf, segmask)
        alphaor = remove_invalid_objects_ds(
            alphacf, consensus_ref, self.score_map,
            saliency_thr=self.saliency_thr,
            consensus_thr=self.consensus_thr, downscale=self.or_downscale)

        trimap = self._gen_trimap(alphaor, frame, bg_color, tier)
        alpha = self.vmat.device_forward_impl(frame, carry.alpha_pre, trimap,
                                              self.work_hw)
        alpha = color_correct(frame, alpha, bg_color,
                              target_long_side=self.cc_long_side)

        bg_img = torch.where((alpha < 128)[..., None], frame,
                             bg_color.expand(frame.shape))
        fg = get_fg(frame, alpha, bg_img)

        # no-foreground gate
        alpha = torch.where(fg_exists, alpha, 0.0)
        fg = torch.where(fg_exists, fg, 0.0)

        tracking = (alpha >= 128).sum() > self.fg_exist_thr * h * w
        new_carry = GreenCarry(alpha_pre=alpha, tracking=tracking,
                               cf_state=cf_state, fid=carry.fid + 1)
        alpha_u8 = alpha.clamp(0.0, 255.0).to(torch.uint8)
        # bg = alpha < 128 ? the work-res frame : the screen color
        frame_u8 = frame.round().clamp(0.0, 255.0).to(torch.uint8)
        bg_u8 = torch.where((alpha_u8 < 128)[..., None], frame_u8,
                            bg_color.clamp(0.0, 255.0).to(torch.uint8))
        return new_carry, (alpha_u8, fg.clamp(0.0, 255.0).to(torch.uint8),
                           bg_u8)

    # -- host loop -----------------------------------------------------------
    @torch.inference_mode()
    def run(self, frames):
        """Run a clip of uint8 (H, W, 3) BGR frames.

        Returns (alphas (N, h, w), fgs (N, h, w, 3), bgs (N, h, w, 3)) as
        uint8 numpy arrays at work resolution."""
        carry = self.init_carry()
        alphas, fgs, bgs = [], [], []
        for f in frames:
            x = torch.from_numpy(np.ascontiguousarray(f, np.uint8))
            carry, (a, fg, bg) = self._step(carry, x.to(self.device))
            packed = torch.cat([a[..., None], fg, bg], dim=-1).cpu().numpy()
            alphas.append(packed[..., 0])
            fgs.append(packed[..., 1:4])
            bgs.append(packed[..., 4:7])
        return np.stack(alphas), np.stack(fgs), np.stack(bgs)


def run_fused(cfg: dict, frames=None, save: bool = False,
              work_long_side: int = 960, device="cuda") -> dict:
    """Green-mode runner on the fused path over in-memory frames.

    `save=True` (the JPEG artifacts) and reading the clip from disk need an
    image codec the port does not carry yet."""
    if save:
        raise NotImplementedError(
            "save=True (alphamask/fg/bg JPEG artifacts) is not ported yet")
    if frames is None:
        raise NotImplementedError(
            "reading frames from disk is not ported yet; pass `frames`")
    frame_list = list(frames)
    h, w, _ = frame_list[0].shape
    print(f"{len(frame_list)} frames.")
    pipe = FusedGreenPipeline(cfg, (h, w), work_long_side=work_long_side,
                              device=device)
    st = time.time()
    alphas, _, _ = pipe.run(frame_list)
    elapsed = time.time() - st
    print(f"fused green: {len(frame_list)} frames in {elapsed:.2f}s "
          f"({len(frame_list) / elapsed:.2f} fps)")
    return {"alphas": list(alphas), "numframes": len(frame_list),
            "fps": len(frame_list) / elapsed}
