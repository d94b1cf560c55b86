"""Fused bg mode: background-estimation unscreen with the whole per-frame
stage chain on the device.

Port of `video_unscreen_tpu/pipeline/fused_bg.py` (`BgCarry`,
`FusedBgPipeline`: `run`, `run_segmented`, `_step_batched`, bg_offline's
stage scans `process_chunk_stage1` and `process_chunk_stage3`;
`run_fused`),
with the artifacts computed on the device: the JAX package's
`fetch="device"`, `pack_d2h=False`; and `process_segments`, the segments
over the ranks of a mesh (`parallel/mesh.py`). The host builds each
chunk, the frames resized to work resolution (`host_downscale`, the
default) and packed as BGR or I420 (`wire`), and uploads it through
pinned memory behind the device's work (`pipeline/common.py:
run_segments`). Per frame:

    seg: STM tracking of the previous alpha over the ring bank | the seed
         (SCHP, DeepLab or chroma) on frame 0, after a tracking loss, and
         where the tracked mask ballooned ->
    object removal -> trimap -> matting pass 1 (the UNet at `pass1_hw`) ->
    per-frame background: (1 - a) * frame darkened in HSV, CG regionfill
         at half resolution behind the dilated hole, warm-started from the
         previous frame's solution ->
    background-difference mask against the per-frame estimate beta-fused
         with the streaming always-bg EMA -> dilate ->
    object removal -> trimap -> matting pass 2 on alpha * bgmask ->
    no-foreground gate -> fg un-blend

The carry holds a ring bank of `stm.fused_bank_capacity` committed STM
memories (in the STM's dtype): a tracking frame commits its previous
frame's memory every `memory_step`-th frame, FIFO, and the read attends
over the committed slots plus the previous frame (kernel K4).

A run advances S independent clip segments in lockstep (`run` is S = 1),
as the JAX `_step_batched` does; the carry is one `BgCarry` whose fields
have a leading S axis. The JAX package compiles one `lax.scan` whose
gates are `lax.cond`s; here the gates are host branches, each read in one
sync and counted in `stats`:

- the step's tracking flags: the STM runs (one batch, the read one K4
  call) only on the segments that track, and only when one does;
- the balloon flags of the tracked masks: the seed runs once a step, as
  one batch, on the segments that did not track or whose tracked mask
  ballooned, and only when there is one;
- the regionfill's stopping rule, every 16 CG iterations (`ops/
  regionfill.py`: each of the S x 3 channels stops on its own iteration).

The trimaps (K1) and dilations (K2) run on the (S, H, W) batch in one
launch each, the UNet with batch S; object removal (K3 and its sums)
takes one frame, so it loops over the segments.
"""

from __future__ import annotations

import collections
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..agents.stm import STMAgent
from ..agents.vmatting import VMattingAgent
from ..ops.color import bgr2gray, bgr2hsv, hsv2bgr
from ..ops.compositing import get_fg
from ..ops.connected import remove_invalid_objects_ds
from ..ops.geometry import get_target_size, imnormalize
from ..ops.morphology import dilate
from ..ops.regionfill import cg_syncs, regionfill_solve, solve_shape
from ..ops.trimap import generate_trimap
from ..parallel.mesh import axis_any
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer, maybe_trace
from .common import (build_score_map, check_wire, prep_frames, read_frames,
                     run_segments, segment_blocks, unported)
from .fused_green import _build_seed_segmenter, save_artifacts, seed_mask


class BgCarry(NamedTuple):
    """Per-segment state; every field has a leading segment axis S."""
    alpha_pre: torch.Tensor   # (S, H, W) work-res alpha of the last frame
    tracking: torch.Tensor    # (S,) bool
    frame_prev: torch.Tensor  # (S, H, W, 3) normalized previous frame
    fid: torch.Tensor         # (S,) int32
    bg_prev: torch.Tensor     # (S, sh, sw, 3) regionfill warm start
    bank_k: torch.Tensor      # (S, cap, hm, wm, 128) STM ring-bank keys
    bank_v: torch.Tensor      # (S, cap, hm, wm, 512) STM ring-bank values
    bank_n: torch.Tensor      # (S,) int32 committed slots
    bg_model: torch.Tensor    # (S, H, W, 3) temporal background EMA
    bg_seen: torch.Tensor     # (S, H, W) observed-as-background weight


class FusedBgPipeline:
    """bg-mode runner for one clip geometry.

    `matting_dtype`, `stm_dtype` and `seg_dtype` are the MattingUNet's,
    the STM's and the seed's (`models/precision.py`); bfloat16 by default,
    as in the JAX pipeline. `stats` counts, for the last run, the steps,
    host syncs (the flag reads, the CG stopping checks and the fetches),
    the STM steps and tracked frames, the ballooned frames, the seed steps
    and seeded frames, and the CG iterations; `step_tracking` holds each
    step's tracking flags and `step_seeded` the segments the seed ran on.
    `wire` is the upload's format, as `FusedGreenPipeline`'s.
    `process_chunk_stage1` and `process_chunk_stage3` are bg_offline's
    stage scans (`pipeline/bg_offline.py`), `process_segments` the
    segments over the ranks of a mesh. The parameters are the JAX
    pipeline's, in its order, then `device`. The JAX pipeline's host fetch
    (`fetch="host"`, with the background at 1/`bg_downscale`, and
    `pack_d2h`) is not ported: asking for it raises."""

    def __init__(self, cfg: dict, frame_hw: Tuple[int, int],
                 work_long_side: int = 960, use_stm_tracking: bool = True,
                 matting_dtype: torch.dtype = torch.bfloat16,
                 stm_dtype: torch.dtype = torch.bfloat16,
                 seg_dtype: torch.dtype = torch.bfloat16, wire: str = "bgr",
                 fetch: str = "auto", bg_downscale: int = 2,
                 pass1_downscale: int = 2, pack_d2h="auto", device="cuda"):
        if fetch not in ("auto", "device"):
            raise unported(f"fetch={fetch!r} (host-side fg and bg)", "12")
        if pack_d2h not in ("auto", False):
            raise unported("pack_d2h (the bit-packed download)", "12")
        if int(bg_downscale) != bg_downscale or bg_downscale < 1:
            raise ValueError(f"bg_downscale={bg_downscale!r}: a whole "
                             f"number >= 1")
        # shapes only the host fetch's background (item 12)
        self.bg_downscale = int(bg_downscale)
        self.device = resolve_device(device)
        self.wire = check_wire(wire)
        self.cfg = cfg
        self.ori_hw = tuple(frame_hw)
        # one work resolution, divisible by 32 (matting) and 16 (STM)
        self.work_hw = get_target_size(frame_hw[0], frame_hw[1],
                                       work_long_side, division=32)
        self.vmat = VMattingAgent(
            model_path=cfg["vmatting"].get("model_path"),
            input_long_side=work_long_side, device=self.device,
            dtype=matting_dtype)
        # matting pass 1 runs the UNet at 1/pass1_downscale resolution;
        # its long side is itself rounded up to a multiple of 32
        self.pass1_downscale = max(int(
            cfg["vmatting"].get("pass1_downscale", pass1_downscale)), 1)
        p1_long = -(-(max(self.work_hw) // self.pass1_downscale) // 32) * 32
        self.pass1_hw = get_target_size(
            self.work_hw[0] // self.pass1_downscale,
            self.work_hw[1] // self.pass1_downscale, p1_long, division=32)
        self.use_stm = bool(use_stm_tracking)
        self.stm_dtype = stm_dtype
        stm_cfg = cfg.get("stm", {})
        self.bank_cap = (int(stm_cfg.get("fused_bank_capacity", 2))
                         if self.use_stm else 0)
        self.memory_step = int(stm_cfg.get("memory_step", 2))
        # a tracked mask whose area jumps past balloon_ratio x the previous
        # alpha's (STM latched onto a distractor) takes the seed instead
        self.balloon_ratio = float(stm_cfg.get("balloon_ratio", 1.6))
        if self.use_stm:
            self.stm = STMAgent(model_path=stm_cfg.get("model_path"),
                                input_long_side=work_long_side,
                                device=self.device, dtype=stm_dtype)
        self.seg = _build_seed_segmenter(cfg.get("binseg", {}), seg_dtype,
                                         self.device)
        self.score_map = torch.from_numpy(np.array(build_score_map(
            self.work_hw[0], self.work_hw[1], cfg))).to(self.device)
        self.fg_exist_thr = float(cfg["fg_exist_thr"])
        bg_mask = cfg["bg_mask"]
        self.bg_mask_thr = float(bg_mask["thr"])
        # the streaming always-bg EMA and its beta-fusion into the
        # background-difference reference (`_bg_model_update`)
        self.bg_fusion_beta = float(bg_mask.get("fusion_weight", 0.1))
        self.bg_temporal = bool(bg_mask.get("temporal", True))
        self.bg_ema_rate = float(bg_mask.get("ema_rate", 0.3))
        self.bg_recover_rate = float(bg_mask.get("recover_rate", 0.25))
        self.saliency_thr = float(cfg["objectremoval"]["saliency_thr"])
        self.consensus_thr = float(cfg["objectremoval"]["consensus_thr"])
        self.or_downscale = int(cfg["objectremoval"].get("downscale", 2))
        tri = cfg["trimap"]
        self.tri_kernel = int(tri["kernelsize"])
        self.tri_iters = int(tri["iters"])
        self.stats = collections.Counter()
        self.step_tracking: List[Tuple[bool, ...]] = []
        self.step_seeded: List[Tuple[bool, ...]] = []
        self._cg_iters: List[torch.Tensor] = []

    def reset_stats(self) -> None:
        """Empty `stats`, the per-step flags and the pending CG counts."""
        self.stats = collections.Counter()
        self.step_tracking, self.step_seeded, self._cg_iters = [], [], []

    def count_cg(self) -> None:
        """Add the CG iterations and stopping checks of the steps run since
        the last call to `stats` (one read of the counts)."""
        if not self._cg_iters:
            return
        iters = torch.stack(self._cg_iters).cpu()
        self._cg_iters = []
        checks = sum(cg_syncs(i) for i in iters)
        self.stats["cg_iters"] += int(iters.sum())
        self.stats["cg_syncs"] += checks
        self.stats["syncs"] += checks

    def init_carries(self, n_segments: int) -> BgCarry:
        """Fresh state for `n_segments` segments."""
        s = n_segments
        h, w = self.work_hw
        sh, sw = solve_shape(h, w, 0.5)
        hm, wm = h // 16, w // 16
        cap = self.bank_cap
        z = dict(device=self.device)
        return BgCarry(
            alpha_pre=torch.zeros((s, h, w), **z),
            tracking=torch.zeros(s, dtype=torch.bool, **z),
            frame_prev=torch.zeros((s, h, w, 3), **z),
            fid=torch.zeros(s, dtype=torch.int32, **z),
            bg_prev=torch.zeros((s, sh, sw, 3), **z),
            bank_k=torch.zeros((s, cap, hm, wm, 128), dtype=self.stm_dtype,
                               **z),
            bank_v=torch.zeros((s, cap, hm, wm, 512), dtype=self.stm_dtype,
                               **z),
            bank_n=torch.zeros(s, dtype=torch.int32, **z),
            bg_model=torch.zeros((s, h, w, 3), **z),
            bg_seen=torch.zeros((s, h, w), **z))

    def init_carry(self) -> BgCarry:
        """Fresh state for one segment (S = 1)."""
        return self.init_carries(1)

    # -- sub-stages ----------------------------------------------------------
    def _ballooned(self, tracked: torch.Tensor,
                   alpha_pre: torch.Tensor) -> torch.Tensor:
        """True where the tracked mask's area exceeds `balloon_ratio` x the
        previous alpha's: (H, W) masks, or (S, H, W) -> (S,)."""
        if self.balloon_ratio <= 0:
            return torch.zeros(tracked.shape[:-2], dtype=torch.bool,
                               device=tracked.device)
        ta = (tracked >= 128).sum(dim=(-2, -1)).to(torch.float32)
        pa = (alpha_pre >= 128).sum(dim=(-2, -1)).clamp_min(1)
        return ta > self.balloon_ratio * pa.to(torch.float32)

    def _bg_model_update(self, carry: BgCarry, frame: torch.Tensor,
                         alpha: torch.Tensor, segmask: torch.Tensor,
                         bgimg: torch.Tensor):
        """Fold the pixels the matte calls background (alpha == 0) and the
        segmask does not call foreground into the always-bg EMA (the first
        observation takes the frame); where the seed disputes a seen EMA
        pixel while nothing was tracked, blend the EMA toward the per-frame
        estimate at `recover_rate`. Per segment over (S, ...) batches.
        Returns (bg_model, bg_seen)."""
        if not self.bg_temporal:
            return carry.bg_model, carry.bg_seen
        seg_fg = segmask >= 128
        is_bg = (alpha == 0) & ~seg_fg
        r = self.bg_ema_rate
        first = is_bg & (carry.bg_seen == 0)
        ema = (1.0 - r) * carry.bg_model + r * frame
        upd = torch.where(first[..., None], frame, ema)
        bg_model = torch.where(is_bg[..., None], upd, carry.bg_model)
        tracking = carry.tracking.reshape(-1, *(1,) * (alpha.dim() - 1))
        recover = ((alpha == 0) & seg_fg & (carry.bg_seen > 0) & ~tracking)
        rr = self.bg_recover_rate
        bg_model = torch.where(recover[..., None],
                               (1.0 - rr) * bg_model + rr * bgimg, bg_model)
        bg_seen = torch.where(is_bg, (carry.bg_seen + 1.0).clamp_max(255.0),
                              carry.bg_seen)
        return bg_model, bg_seen

    def _bank_update(self, carry: BgCarry, k: torch.Tensor, v: torch.Tensor,
                     did_track: torch.Tensor):
        """FIFO-commit each tracking segment's previous-frame memory (k, v)
        on every `memory_step`-th frame; a full bank rolls by one slot
        first. Returns (bank_k, bank_v, bank_n)."""
        cap = self.bank_cap
        if cap == 0:
            return carry.bank_k, carry.bank_v, carry.bank_n
        commit = did_track & (carry.fid % self.memory_step == 0)
        full = (carry.bank_n >= cap).reshape(-1, 1, 1, 1, 1)
        idx = carry.bank_n.clamp_max(cap - 1).to(torch.int64)
        rows = torch.arange(k.shape[0], device=k.device)
        banks = []
        for bank, new in ((carry.bank_k, k), (carry.bank_v, v)):
            rolled = torch.where(full, bank.roll(-1, dims=1), bank)
            rolled[rows, idx] = new.to(bank.dtype)
            banks.append(torch.where(commit.reshape(-1, 1, 1, 1, 1), rolled,
                                     bank))
        bank_n = torch.where(commit, (carry.bank_n + 1).clamp_max(cap),
                             carry.bank_n)
        return banks[0], banks[1], bank_n

    def _stm_track_mask(self, alpha_pre, frame_prev, norm, bank_k, bank_v,
                        bank_n):
        """Propagate the previous alpha through the STM over (T, ...)
        batches: memorize the previous frame, read the committed slots
        (slot < bank_n) plus that memory, argmax. Returns (mask {0, 255},
        k, v) with (k, v) the previous frame's memory for the bank."""
        model = self.stm.model
        mask_prev = (alpha_pre >= 128).to(torch.float32)
        k, v = model.memorize(frame_prev.permute(0, 3, 1, 2), mask_prev,
                              1.0 - mask_prev)
        cap = self.bank_cap
        eff_k = torch.cat([bank_k.to(k.dtype), k[:, None]], dim=1)
        eff_v = torch.cat([bank_v.to(v.dtype), v[:, None]], dim=1)
        slot = torch.arange(cap + 1, device=k.device)[None]
        valid = (slot < bank_n[:, None]) | (slot == cap)
        logits = model.segment(norm.permute(0, 3, 1, 2), eff_k, eff_v, valid)
        mask = torch.argmax(logits, dim=1).to(torch.float32) * 255.0
        return mask, k, v

    def _matting_pass(self, frames, alpha_pre, mask, coarse: bool = False):
        """object removal -> trimap (K1, one launch for S) -> matting on
        (S, ...) batches; `coarse` runs the UNet at `pass1_hw` (the
        full-resolution trimap's hard reset applies unchanged)."""
        alphaor = torch.stack([remove_invalid_objects_ds(
            m, m, self.score_map, saliency_thr=self.saliency_thr,
            consensus_thr=self.consensus_thr, downscale=self.or_downscale)
            for m in mask])
        trimap = generate_trimap(alphaor, self.tri_kernel, self.tri_iters)
        net_hw = self.pass1_hw if coarse else self.work_hw
        return self.vmat.device_forward_impl(frames, alpha_pre, trimap,
                                             net_hw)

    def _per_frame_background(self, frames, alpha, bg_prev):
        """(1 - a) * frame darkened in HSV, then the CG regionfill of every
        channel of every segment behind its dilated binarized alpha (K2)
        at half resolution, warm-started from `bg_prev`, as one batch of
        S x 3 solves. Returns (bg (S, H, W, 3), the solve-resolution
        solution (S, sh, sw, 3), the CG iterations (S x 3,))."""
        s, h, w = alpha.shape
        a = (alpha / 255.0)[..., None]
        bg = hsv2bgr(torch.clamp((1.0 - a) * bgr2hsv(frames), 0.0, 255.0))
        hole = dilate(torch.where(alpha > 128, 255.0, 0.0), 3, 2)
        planes = bg.permute(0, 3, 1, 2).reshape(3 * s, h, w)
        x0 = bg_prev.permute(0, 3, 1, 2).reshape(3 * s,
                                                  *bg_prev.shape[1:3])
        filled, sol, iters = regionfill_solve(
            planes, hole.repeat_interleave(3, dim=0), 0.5, cg_iters=200,
            x0=x0)
        return (filled.reshape(s, 3, h, w).permute(0, 2, 3, 1),
                sol.reshape(s, 3, *sol.shape[1:]).permute(0, 2, 3, 1),
                iters)

    # -- per-step work -------------------------------------------------------
    def _prep_frames(self, frames_full: torch.Tensor) -> torch.Tensor:
        """uint8 (S, H, W, 3) or I420 (S, H * 3 / 2, W) on the device ->
        float32 BGR at work resolution."""
        return prep_frames(frames_full, self.work_hw)

    def _step_batched(self, carries: BgCarry, frames_full: torch.Tensor,
                      model_axis=None):
        """Advance S segments one frame: `carries` has a leading segment
        axis S, `frames_full` is uint8 (S, H, W, 3) or I420 (S, H * 3 / 2,
        W) on the device. `model_axis` ((process group, size): ranks that hold
        the same segments) reaches the seed, see `_segment_batched`.
        Returns (new carries, uint8 (S, h, w, 8): alpha, segmask, fg,
        bg)."""
        frames = self._prep_frames(frames_full)
        norms = imnormalize(frames)
        segmask, bank = self._segment_batched(carries, frames, norms,
                                              model_axis)
        return self._post_seg(carries, frames, norms, segmask, bank)

    def _segment_batched(self, carries: BgCarry, frames: torch.Tensor,
                         norms: torch.Tensor, model_axis=None):
        """The segmask of each segment's frame: the STM read of the
        previous alpha where the segment tracks, the seed where it does
        not or the tracked mask ballooned (two flag reads, counted in
        `stats`). With `model_axis` a segment takes the seed where any rank
        of the axis asks for it (one more read), so that all enter the
        seed's collective together. Returns (segmask (S, h, w), the
        updated (bank_k, bank_v, bank_n))."""
        n_s = frames.shape[0]
        tracking = (carries.tracking & (carries.fid > 0)).tolist()
        self.stats["syncs"] += 1
        self.stats["steps"] += 1
        self.step_tracking.append(tuple(tracking))
        seeded = [not t for t in tracking]
        segmask = carries.alpha_pre
        bank = (carries.bank_k, carries.bank_v, carries.bank_n)
        track = [s for s in range(n_s) if tracking[s]]
        if self.use_stm and track:
            idx = torch.tensor(track, device=self.device)
            part = (slice(None) if len(track) == n_s else idx)
            tracked, k_t, v_t = self._stm_track_mask(
                carries.alpha_pre[part], carries.frame_prev[part],
                norms[part], carries.bank_k[part], carries.bank_v[part],
                carries.bank_n[part])
            k = k_t.new_zeros((n_s,) + k_t.shape[1:])
            v = v_t.new_zeros((n_s,) + v_t.shape[1:])
            k[idx], v[idx] = k_t, v_t
            did_track = torch.zeros(n_s, dtype=torch.bool,
                                    device=self.device)
            did_track[idx] = True
            bank = self._bank_update(carries, k, v, did_track)
            balloon = self._ballooned(
                tracked, carries.alpha_pre[part]).tolist()
            self.stats["syncs"] += 1
            self.stats["stm_steps"] += 1
            self.stats["tracked_frames"] += len(track)
            self.stats["ballooned_frames"] += sum(balloon)
            segmask = carries.alpha_pre.clone()
            segmask[idx] = tracked
            for s, b in zip(track, balloon):
                seeded[s] = bool(b)
        if model_axis is not None:
            seeded = axis_any(torch.tensor(seeded, device=self.device),
                              model_axis).tolist()
            self.stats["syncs"] += 1
        need = [s for s in range(n_s) if seeded[s]]
        if need:
            seeds = seed_mask(self.seg, frames[need], model_axis)
            segmask = segmask.clone()
            segmask[torch.tensor(need, device=self.device)] = seeds
            self.stats["seed_steps"] += 1
            self.stats["seeded_frames"] += len(need)
        self.step_seeded.append(tuple(seeded))
        return segmask, bank

    def _post_seg(self, carry: BgCarry, frames: torch.Tensor,
                  norms: torch.Tensor, segmask: torch.Tensor, bank):
        """Everything after segmentation, on (S, ...) batches. `bank` is
        the updated (bank_k, bank_v, bank_n). Returns (new carries, uint8
        (S, h, w, 8))."""
        h, w = self.work_hw
        min_fg = self.fg_exist_thr * h * w
        fg_exists = ((segmask >= 128).sum(dim=(-2, -1)) > min_fg)[:, None,
                                                                  None]
        # matting pass 1 (coarse) and the background estimate
        alpha1 = self._matting_pass(frames, carry.alpha_pre, segmask,
                                    coarse=True)
        bgimg, bg_sol, iters = self._per_frame_background(frames, alpha1,
                                                          carry.bg_prev)
        self._cg_iters.append(iters)
        # background-difference mask against the per-frame estimate fused
        # with the EMA where the EMA has observations
        if self.bg_temporal:
            beta = self.bg_fusion_beta
            bg_for_diff = torch.where(
                (carry.bg_seen > 0)[..., None],
                beta * bgimg + (1.0 - beta) * carry.bg_model, bgimg)
        else:
            bg_for_diff = bgimg
        diff = bgr2gray((frames - bg_for_diff).abs())
        alphabg = torch.where(diff > self.bg_mask_thr, 255.0, diff)
        alphabg = dilate(alphabg.clamp(0.0, 255.0), 4, 2)
        # matting pass 2 on alpha * bgmask
        alpha_ensm = alpha1 * torch.floor(alphabg / 255.0)
        alpha = self._matting_pass(frames, carry.alpha_pre, alpha_ensm)
        alpha = torch.where(fg_exists, alpha, 0.0)

        bg_model, bg_seen = self._bg_model_update(carry, frames, alpha,
                                                  segmask, bgimg)
        tracking = (alpha >= 128).sum(dim=(-2, -1)) > min_fg
        new = BgCarry(alpha_pre=alpha, tracking=tracking, frame_prev=norms,
                      fid=carry.fid + 1, bg_prev=bg_sol, bank_k=bank[0],
                      bank_v=bank[1], bank_n=bank[2], bg_model=bg_model,
                      bg_seen=bg_seen)
        bg_final = torch.where((alpha == 0)[..., None], frames, bgimg)
        fg = torch.where(fg_exists[..., None], get_fg(frames, alpha,
                                                      bg_final), 0.0)
        packed = torch.cat([alpha[..., None], segmask[..., None], fg,
                            bg_final], dim=-1)
        return new, packed.clamp(0.0, 255.0).to(torch.uint8)

    # -- host loop -----------------------------------------------------------
    def run(self, frames, chunk_size: int = 4, host_downscale: bool = True,
            timer: StageTimer = None):
        """Run a clip of uint8 (H, W, 3) BGR frames as one segment.

        Returns (alphas (N, h, w), segmasks (N, h, w), fgs (N, h, w, 3),
        bgs (N, h, w, 3)) as uint8 numpy arrays at work resolution."""
        return self.run_segmented(frames, 1, chunk_size, host_downscale,
                                  timer)

    @torch.inference_mode()
    def run_segmented(self, frames, n_segments: int = 2,
                      chunk_size: int = 4, host_downscale: bool = True,
                      timer: StageTimer = None):
        """Split the clip into `n_segments` contiguous segments advanced in
        lockstep (`pipeline/common.py:run_segments`; segment boundaries
        reset the carry). `host_downscale` resizes the frames to work
        resolution on the host before the upload (else on the device);
        `timer` takes the per-stage split. Returns `run`'s arrays, in clip
        order."""
        frames = list(frames)
        self.reset_stats()
        wire_hw = self.work_hw if host_downscale else frames[0].shape[:2]

        def step(carries, batch):
            carries, packed = self._step_batched(carries, batch)
            return carries, (packed,)

        packed, = run_segments(step, self.init_carries(n_segments), frames,
                               n_segments, chunk_size, self.device,
                               self.stats, wire_hw, self.wire, timer)
        self.count_cg()  # after the last fetch: the card is idle
        return (packed[..., 0], packed[..., 1], packed[..., 2:5],
                packed[..., 5:8])


    # -- bg_offline stage scans ----------------------------------------------
    def _stage1_step(self, carries: BgCarry, frames_full: torch.Tensor):
        """bg_offline stage 1 for one frame of each segment: the segmask
        (seed or STM read), the coarse pass-1 matte (zero without a
        foreground), the per-frame background (the frame itself without a
        foreground) and the EMA update. Returns (new carries, uint8 (S, h,
        w, 4): segmask, bg)."""
        frames = self._prep_frames(frames_full)
        norms = imnormalize(frames)
        segmask, bank = self._segment_batched(carries, frames, norms)
        h, w = self.work_hw
        min_fg = self.fg_exist_thr * h * w
        fg_exists = ((segmask >= 128).sum(dim=(-2, -1)) > min_fg)[:, None,
                                                                  None]
        alpha = self._matting_pass(frames, carries.alpha_pre, segmask,
                                   coarse=True)
        alpha = torch.where(fg_exists, alpha, 0.0)
        bgimg, bg_sol, iters = self._per_frame_background(frames, alpha,
                                                          carries.bg_prev)
        self._cg_iters.append(iters)
        bgimg = torch.where(fg_exists[..., None], bgimg, frames)
        bg_model, bg_seen = self._bg_model_update(carries, frames, alpha,
                                                  segmask, bgimg)
        tracking = (alpha >= 128).sum(dim=(-2, -1)) > min_fg
        new = BgCarry(alpha_pre=alpha, tracking=tracking, frame_prev=norms,
                      fid=carries.fid + 1, bg_prev=bg_sol, bank_k=bank[0],
                      bank_v=bank[1], bank_n=bank[2], bg_model=bg_model,
                      bg_seen=bg_seen)
        packed = torch.cat([segmask[..., None], bgimg.clamp(0.0, 255.0)],
                           dim=-1)
        return new, packed.clamp(0.0, 255.0).to(torch.uint8)

    def _stage3_step(self, carries: BgCarry, frames_full: torch.Tensor,
                     bgimgs: torch.Tensor, segmasks: torch.Tensor):
        """bg_offline stage 3 for one frame of each segment: the
        background-difference mask against the fused background `bgimgs`
        (uint8 (S, h, w, 3)) gates the stage-1 `segmasks` (uint8 (S, h,
        w)); the first frame seeds alpha_pre from that mask; the full
        resolution matte and the fg un-blend. Returns (new carries, uint8
        (S, h, w, 4): alpha, fg)."""
        frames = self._prep_frames(frames_full)
        bgimg = bgimgs.to(torch.float32)
        diff = bgr2gray((frames - bgimg).abs())
        alphabg = torch.where(diff > self.bg_mask_thr, 255.0, diff)
        alphabg = dilate(alphabg.clamp(0.0, 255.0), 4, 2)
        alpha_ensm = segmasks.to(torch.float32) * torch.floor(
            alphabg / 255.0)
        alpha_pre = torch.where((carries.fid == 0)[:, None, None],
                                alpha_ensm, carries.alpha_pre)
        alpha = self._matting_pass(frames, alpha_pre, alpha_ensm)
        bg_final = torch.where((alpha == 0)[..., None], frames, bgimg)
        fg = get_fg(frames, alpha, bg_final)
        new = carries._replace(alpha_pre=alpha, fid=carries.fid + 1)
        packed = torch.cat([alpha[..., None], fg.clamp(0.0, 255.0)], dim=-1)
        return new, packed.clamp(0.0, 255.0).to(torch.uint8)

    def _chunk(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    @torch.inference_mode()
    def process_chunk_stage1(self, carry: BgCarry, frames):
        """bg_offline stage 1 over a chunk of one segment's frames, uint8
        (N, h, w, 3) BGR or (N, h * 3 / 2, w) I420 at work resolution
        (numpy or tensors). Returns (carry, uint8 (N, h, w, 4): segmask,
        bg) on the device."""
        frames = self._chunk(frames)
        outs = []
        for t in range(frames.shape[0]):
            carry, packed = self._stage1_step(carry, frames[t:t + 1])
            outs.append(packed)
        return carry, torch.cat(outs)

    @torch.inference_mode()
    def process_chunk_stage3(self, carry: BgCarry, frames, bgimgs,
                             segmasks):
        """bg_offline stage 3 over a chunk of one segment: `frames` as
        `process_chunk_stage1` takes them, the fused backgrounds uint8 (N,
        h, w, 3) and the stage-1 segmasks uint8 (N, h, w). Returns (carry,
        uint8 (N, h, w, 4): alpha, fg) on the device."""
        frames, bgimgs, segmasks = (self._chunk(x) for x in
                                    (frames, bgimgs, segmasks))
        outs = []
        for t in range(frames.shape[0]):
            carry, packed = self._stage3_step(
                carry, frames[t:t + 1], bgimgs[t:t + 1], segmasks[t:t + 1])
            outs.append(packed)
        return carry, torch.cat(outs)

    @torch.inference_mode()
    def process_segments(self, mesh, segments):
        """Run S clip segments over the ranks of `mesh`, as the JAX
        `process_segments` (see `FusedGreenPipeline.process_segments`).
        Returns, on every rank, (packed uint8 (S, L, h, w, 8): alpha,
        segmask, fg, bg; bg_small uint8 (S, L, 1, 1, 3) zeros, as the JAX
        pipeline's `fetch="device"` returns it) on the device."""
        self.reset_stats()

        def step(carries, frames, model_axis):
            carries, packed = self._step_batched(carries, frames, model_axis)
            return carries, (packed,)

        packed, = segment_blocks(step, self.init_carries, mesh, segments,
                                 self.device)
        self.count_cg()
        return packed, torch.zeros(packed.shape[:2] + (1, 1, 3),
                                   dtype=torch.uint8, device=self.device)


def run_fused(cfg: dict, frames=None, save: bool = False,
              chunk_size: int = 4, work_long_side: int = 960,
              use_stm_tracking: bool = True, segments: int = 1,
              wire: str = "bgr", profile: bool = False,
              device="cuda") -> dict:
    """bg mode on the fused path. `frames` defaults to the clip of
    `cfg["data"]` read from disk; `save` writes `alphamask_`, `segmask_`,
    `fg_` and `bg_*.jpg` at work resolution into
    `cfg["data"]["dst_img_dir"]`; `segments > 1` batches that many clip
    segments (`run_segmented`); `wire` is the upload's format; `profile`
    prints the per-stage report and $VU_TRACE_DIR, when set, receives a
    profiler trace."""
    st = time.time()
    frame_list = list(frames) if frames is not None else read_frames(cfg)
    h, w, _ = frame_list[0].shape
    print(f"{len(frame_list)} frames. Reading Data Done! "
          f"{time.time() - st:.2f}s")
    pipe = FusedBgPipeline(cfg, (h, w), work_long_side=work_long_side,
                           use_stm_tracking=use_stm_tracking, wire=wire,
                           device=device)
    timer = StageTimer(block=True) if profile else None
    st = time.time()
    with maybe_trace():
        alphas, segmasks, fgs, bgs = pipe.run_segmented(
            frame_list, segments, chunk_size, timer=timer)
    elapsed = time.time() - st
    if timer is not None:
        print(timer.report(numframes=len(frame_list)))
    print(f"fused bg: {len(frame_list)} frames in {elapsed:.2f}s "
          f"({len(frame_list) / elapsed:.2f} fps)")
    if save:
        save_artifacts(cfg["data"]["dst_img_dir"], (
            ("alphamask", np.repeat(alphas[..., None], 3, axis=-1)),
            ("segmask", np.repeat(segmasks[..., None], 3, axis=-1)),
            ("fg", fgs), ("bg", bgs)))
    return {"alphas": list(alphas), "numframes": len(frame_list),
            "fps": len(frame_list) / elapsed}
