"""Fused green mode: the whole per-frame stage chain on the device.

Port of `video_unscreen_tpu/pipeline/fused_green.py` (`run`,
`run_segmented`, `process_chunk`, `process_chunk_segments`,
`process_segments` and `run_fused`; the pipeline with both of its
fetches):

    host:   build each chunk: the frames resized to work resolution
            (`host_downscale`, the default) and packed as BGR or I420
            (`wire`), one C++ call a chunk; a worker thread uploads it
            through pinned memory behind the device's work
            (`pipeline/common.py:run_segments`)
    device: I420 -> BGR; the resize unless the host did it ->
            seg (tracking shortcut | DeepLab or chroma seed) ->
            color filter (refit every `colorfiltering_update_duration`-th
            frame, after a tracking loss, or while untrained; else predict)
            -> object removal -> trimap (displacement-adaptive band) ->
            matting UNet -> color correct -> fg un-blend (device fetch)
    host:   fetch uint8 alpha, the screen color and (device fetch) fg,
            once a chunk; bg = alpha < 128 ? the frame at work resolution
            resized on the host from the original : the screen color (as
            JAX's `_assemble_outputs`: the device never sees the original
            under the I420 wire). The host fetch (`fetch_fg="host"`)
            downloads no fg: the host un-blends it from the frame, alpha
            and screen color (`runtime.get_fg_batch`), and with
            `pack_d2h` the alpha crosses bit-packed (`ops/wirepack.py`),
            its full plane left on the device for a frame whose band
            overflows the packed budget.

A run advances S independent clip segments in lockstep (`run` is S = 1),
as the JAX `_step_batched` does. The JAX package compiles one `lax.scan`
whose gates are `lax.cond`s; here torch runs eagerly and the gates are
host branches: each step reads the segments' tracking and refit flags in
one sync and the band tiers in a second, so only the taken branches run:

- the seed runs once a step, on the segments that lost tracking only, as
  one batch (DeepLab: their 12 crops each at 544x960, through the net 48
  at a time), and only when one did; a segment that is tracking takes its
  previous alpha;
- the color filter refits the segments whose schedule says so and
  predicts for the rest (JAX's three tiers, all, some and none);
- one band tier for all segments, the max over the batch, as in JAX: one
  segment's motion widens every segment's band.

The UNet runs with batch S, the trimap (K1) and the band's dilate (K2) on
the (S, H, W) batch in one launch each. The GMM fit and predict, object
removal (K3) and `color_correct` take one frame, so they loop over the
segments. Data-dependent selects inside a stage stay `torch.where`.
Segment boundaries reset the carry; the clip's tail is padded with its last
frame and trimmed.

`process_segments(mesh, segments)` runs the segments over the ranks of a
mesh (`parallel/mesh.py`): each rank advances its block of the data axis
with the same step, and the ranks of a model axis split the DeepLab
seed's crops (`SegAgent._tta_scores_sharded`).
"""

from __future__ import annotations

import collections
import os
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..agents.binseg import build_seg_agent
from ..agents.colorfiltering import CFState, ColorFilteringAgent
from ..agents.vmatting import VMattingAgent
from ..ops.chroma import chroma_segment
from ..ops.compositing import color_correct, get_fg, is_pixel_inrange
from ..ops.connected import remove_invalid_objects_ds
from ..ops.geometry import get_target_size
from ..ops.morphology import dilate
from ..ops.trimap import generate_trimap_withbg
from ..ops.wirepack import pack_plane, unpack_planes
from .. import runtime
from ..parallel.mesh import axis_any
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer, maybe_trace
from .common import (artifact_path, build_score_map, check_wire,
                     host_frames, prep_frames, read_frames, resolve_fetch,
                     run_segments, scan_steps, segment_blocks)


class GreenCarry(NamedTuple):
    alpha_pre: torch.Tensor  # (H, W) work-res alpha of the previous frame
    tracking: torch.Tensor   # 0-d bool
    cf_state: CFState
    fid: torch.Tensor        # 0-d int32


def _build_seed_segmenter(cfg_binseg: dict, dtype: torch.dtype,
                          device="cuda"):
    """None for the weights-free chroma seed, else `build_seg_agent`'s
    agent (a `SegAgent` in `dtype` for "deeplab"). `type` defaults to
    "deeplab" when a model_path is configured and to "chroma" otherwise,
    as in the JAX package; a configured weights file that is missing
    raises."""
    kw = dict(cfg_binseg)
    kind = kw.pop("type", None)
    if kind is None:
        kind = "deeplab" if kw.get("model_path") else "chroma"
    if kind == "chroma":
        return None
    kw.setdefault("dtype", dtype)
    return build_seg_agent(dict(kw, type=kind), device)


def seed_mask(seg, frames: torch.Tensor, model_axis=None) -> torch.Tensor:
    """Non-tracking seed masks {0, 255} of (B, H, W, 3) work-resolution
    frames: the DeepLab TTA (the batch's crops together; their crops split
    over the ranks of `model_axis`, (process group, size), when given) or
    the chroma prior (frame by frame)."""
    if seg is not None:
        return seg.predict_mask_impl(frames, model_axis)
    return torch.stack([chroma_segment(f)[0] for f in frames])


class FusedGreenPipeline:
    """Green-mode runner for one clip geometry.

    `matting_dtype` and `seg_dtype` are the MattingUNet's and the DeepLab
    seed's (`models/precision.py`); bfloat16 by default, as in the JAX
    pipeline. `stats` counts, for the last run, the steps, host syncs,
    seed steps and seeded frames, the refit tiers and the band tiers, the
    bytes downloaded and the packed download's overflow fallbacks;
    `step_tracking` holds each step's tracking flags as the host read
    them (a segment whose flag is False took the seed), and `carries` the
    segments' carries at the end of the last run.

    `wire` is the upload's format: "bgr" (packed uint8 BGR) or "yuv420"
    (I420, 1.5 bytes a pixel, decoded on the device; lossy: BT.601 4:2:0
    as cv2 packs it).

    The parameters are the JAX pipeline's, in its order, then `device`.
    `fetch_fg` is where fg is made: "device" (computed and downloaded with
    the alpha), "host" (un-blended on the host from the downloaded alpha
    and screen color) or "auto", which is "device" (JAX's "auto" takes
    the host when its JPEG runtime builds: `common.resolve_fetch`).
    `pack_d2h` bit-packs the host fetch's alpha ("auto": exactly when
    fetching on the host). `cc_downscale` divides the work resolution of
    color_correct's distance map."""

    def __init__(self, cfg: dict, frame_hw: Tuple[int, int],
                 work_long_side: int = 960, fetch_fg: str = "auto",
                 matting_dtype: torch.dtype = torch.bfloat16,
                 seg_dtype: torch.dtype = torch.bfloat16, wire: str = "bgr",
                 cc_downscale: int = 2, pack_d2h="auto", device="cuda"):
        self.fetch_fg, self.pack_d2h = resolve_fetch(fetch_fg, pack_d2h)
        # a packed plane's band budget, None for
        # `wirepack.default_capacity`; set only by checks that force or
        # avoid an overflow
        self._pack_capacity = None
        self.device = resolve_device(device)
        self.wire = check_wire(wire)
        self.cfg = cfg
        self.seg = _build_seed_segmenter(cfg.get("binseg", {}), seg_dtype,
                                         self.device)
        self.ori_hw = tuple(frame_hw)
        self.work_hw = get_target_size(frame_hw[0], frame_hw[1],
                                       work_long_side, division=32)
        self.cf = ColorFilteringAgent(**{
            k: v for k, v in cfg["colorfiltering"].items()
            if k != "input_long_side"}, input_long_side=work_long_side,
            device=self.device)
        self.vmat = VMattingAgent(
            model_path=cfg["vmatting"].get("model_path"),
            input_long_side=work_long_side, device=self.device,
            dtype=matting_dtype)
        self.score_map = torch.from_numpy(np.array(build_score_map(
            self.work_hw[0], self.work_hw[1], cfg))).to(self.device)
        self.fg_exist_thr = float(cfg["fg_exist_thr"])
        self.cf_duration = int(cfg["colorfiltering_update_duration"])
        self.cf_train_iters = int(cfg["colorfiltering_train_iters"])
        self.saliency_thr = float(cfg["objectremoval"]["saliency_thr"])
        self.consensus_thr = float(cfg["objectremoval"]["consensus_thr"])
        self.or_downscale = int(cfg["objectremoval"].get("downscale", 2))
        # color_correct's distance map at 1/cc_downscale of the work
        # resolution
        self.cc_long_side = max(self.work_hw) // max(int(cc_downscale), 1)
        tri = cfg["trimap"]
        self.tri_kernel = int(tri["kernelsize"])
        self.tri_iters = int(tri["iters"])
        self.tri_winsize = tuple(int(v) for v in tri["color_winsize"])
        # displacement-adaptive outward band: 2x/4x/8x the dilate width
        # when the mask centroid moved > 2/4/5 x iters px since last frame
        self.tri_adaptive = bool(tri.get("adaptive_band", True))
        self.tri_tiers = (1, 2, 4, 8)
        self.stats = collections.Counter()
        self.step_tracking: List[Tuple[bool, ...]] = []
        self.carries = None

    def init_carry(self) -> GreenCarry:
        h, w = self.work_hw
        dev = self.device
        return GreenCarry(
            alpha_pre=torch.zeros((h, w), dtype=torch.float32, device=dev),
            tracking=torch.tensor(False, device=dev),
            cf_state=self.cf.reset_gmms(),
            fid=torch.tensor(0, dtype=torch.int32, device=dev))

    def init_carries(self, n_segments: int) -> List[GreenCarry]:
        """One fresh carry per segment."""
        return [self.init_carry() for _ in range(n_segments)]

    # -- per-step work -------------------------------------------------------
    def _prep_frames(self, frames_full: torch.Tensor) -> torch.Tensor:
        """uint8 (S, H, W, 3) or I420 (S, H * 3 / 2, W) on the device ->
        float32 BGR at work resolution."""
        return prep_frames(frames_full, self.work_hw)

    def _step_batched(self, carries: List[GreenCarry],
                      frames_full: torch.Tensor, model_axis=None):
        """Advance S segments one frame: `carries` has one carry a
        segment, `frames_full` is uint8 (S, H, W, 3) or I420 (S, H * 3 / 2,
        W) on the device. With `model_axis` ((process group, size): ranks
        that hold the same segments) the seed's crops are split over its
        ranks, and a segment takes the seed where any of them lost
        tracking, so that all enter the seed's collective together.
        Returns (new carries, (alpha uint8 (S, h, w), fg uint8 (S, h, w,
        3) or, fetching on the host, None, screen color float32 (S,
        3)))."""
        n_s = len(carries)
        frames = self._prep_frames(frames_full)
        lost = axis_any(~torch.stack([c.tracking for c in carries]),
                        model_axis)
        flags = torch.cat([~lost, torch.stack(
            [self._cf_refit_flag(c) for c in carries])]).tolist()
        self.stats["syncs"] += 1
        tracking, refit = flags[:n_s], flags[n_s:]
        self.step_tracking.append(tuple(tracking))

        # the seed runs only on the segments that lost tracking
        segmask = [c.alpha_pre for c in carries]
        need = [s for s in range(n_s) if not tracking[s]]
        if need:
            seeds = seed_mask(self.seg, frames[need], model_axis)
            for j, s in enumerate(need):
                segmask[s] = seeds[j]
            self.stats["seed_steps"] += 1
            self.stats["seeded_frames"] += len(need)
        segmask = torch.stack(segmask)

        # color filter, one segment at a time: refit or predict
        n_refit = sum(refit)
        self.stats["refit_" + ("none" if n_refit == 0 else "all"
                               if n_refit == n_s else "some")] += 1
        alphacf, bg_color, cf_states = [], [], []
        for s, c in enumerate(carries):
            a, bgc, _, st = self.cf.device_forward_impl(
                frames[s], segmask[s], self.cf_train_iters if refit[s] else 0,
                c.cf_state)
            alphacf.append(a)
            bg_color.append(bgc)
            cf_states.append(st)
        alphacf, bg_color = torch.stack(alphacf), torch.stack(bg_color)
        alpha_pre = torch.stack([c.alpha_pre for c in carries])
        # one band tier for all segments: the largest
        tier = int(self._band_tier(alpha_pre, alphacf).max())
        self.stats["syncs"] += 1
        self.stats[f"tier_{tier}"] += 1
        self.stats["steps"] += 1
        return self._post_cf(carries, frames, segmask, alphacf, bg_color,
                             cf_states, tier)

    @torch.inference_mode()
    def process_segments(self, mesh, segments):
        """Run S clip segments over the ranks of `mesh`, as the JAX
        `process_segments`: `segments` is uint8 (S, L, H, W, 3) or I420
        (S, L, H * 3 / 2, W), numpy or a tensor, with S divisible by the
        data axis; each rank advances block `mesh.index("data")` of S /
        data segments from fresh carries through L calls of
        `_step_batched`, its crops of the DeepLab seed split over the model
        axis. Returns, on every rank, `process_chunk_segments`'s outputs
        over (S, L): two, or three when packing, on the device."""
        self.stats = collections.Counter()
        self.step_tracking = []
        return segment_blocks(self._wire_step, self.init_carries, mesh,
                              segments, self.device)

    def _wire_step(self, carries: List[GreenCarry],
                   frames_full: torch.Tensor, model_axis=None):
        """`_step_batched` with the outputs the fetch downloads, a leading
        S axis on each: (alpha and fg uint8 (S, h, w, 4), screen color
        float32 (S, 3)) fetching on the device; (alpha uint8 (S, h, w, 1),
        screen color) on the host; (the packed alpha uint8 (S,
        packed_size), screen color, alpha uint8 (S, h, w)) packed, the
        last left on the device."""
        carries, (a, fg, bg_color) = self._step_batched(carries,
                                                        frames_full,
                                                        model_axis)
        if fg is not None:
            return carries, (torch.cat([a[..., None], fg], dim=-1),
                             bg_color)
        if self.pack_d2h:
            return carries, (pack_plane(a, self._pack_capacity), bg_color, a)
        return carries, (a[..., None], bg_color)

    def _chunk(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    @torch.inference_mode()
    def process_chunk_segments(self, carries: List[GreenCarry], frames):
        """Advance S segments N frames in lockstep: `frames` uint8 (S, N,
        H, W, 3) BGR or (S, N, H * 3 / 2, W) I420 (a tensor on the device,
        or numpy), `carries` one a segment. Every frame given is run (a
        tail's pad frames are the caller's). Returns (carries,
        `_wire_step`'s outputs, each (S, N, ...))."""
        return scan_steps(self._wire_step, carries, self._chunk(frames))

    def process_chunk(self, carry: GreenCarry, frames):
        """One segment's chunk: `frames` uint8 (N, H, W, 3) or (N, H * 3 /
        2, W). Returns (carry, outputs each (N, ...)), as JAX's `lax.scan`
        over the chunk."""
        carries, outs = self.process_chunk_segments(
            [carry], self._chunk(frames)[None])
        return carries[0], tuple(o[0] for o in outs)

    def _cf_refit_flag(self, carry: GreenCarry) -> torch.Tensor:
        """Refit schedule: every `cf_duration`-th frame, after a tracking
        loss, or while the GMMs are untrained."""
        return ((carry.fid % self.cf_duration == 0)
                | ~carry.tracking | ~carry.cf_state.trained)

    def _band_tier(self, alpha_pre: torch.Tensor,
                   alpha_now: torch.Tensor) -> torch.Tensor:
        """Band-width tier 0..3 from the mask-centroid displacement between
        the previous matte and the current chroma alpha, for an (H, W) pair
        or per item of an (S, H, W) pair."""
        if not self.tri_adaptive:
            return torch.zeros(alpha_pre.shape[:-2], dtype=torch.int64,
                               device=self.device)
        h, w = self.work_hw
        ys = torch.arange(h, dtype=torch.float32, device=self.device)
        xs = torch.arange(w, dtype=torch.float32, device=self.device)

        def centroid(m):
            wgt = (m >= 128).to(torch.float32)
            tot = wgt.sum(dim=(-2, -1))
            cy = (wgt.sum(dim=-1) * ys).sum(dim=-1) / tot.clamp_min(1.0)
            cx = (wgt.sum(dim=-2) * xs).sum(dim=-1) / tot.clamp_min(1.0)
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
        unknown unless the chroma window confirms them as screen color.
        `alphaor` (H, W) with `bg_color` (3,), or (S, H, W) with (S, 3)."""
        bg = bg_color if bg_color.dim() == 1 else bg_color[:, None, None, :]
        base = generate_trimap_withbg(alphaor, frame, bg, self.tri_kernel,
                                      self.tri_iters, self.tri_winsize)
        if not self.tri_adaptive or tier == 0:
            return base
        wide = dilate(alphaor, self.tri_kernel,
                      self.tri_iters * self.tri_tiers[tier])
        bg_like = is_pixel_inrange(frame, bg, self.tri_winsize)
        return torch.where((base == 0.0) & (wide >= 128.0) & ~bg_like, 128.0,
                           base)

    def _post_cf(self, carries: List[GreenCarry], frames: torch.Tensor,
                 segmask: torch.Tensor, alphacf: torch.Tensor,
                 bg_color: torch.Tensor, cf_states: List[CFState],
                 tier: int):
        """Object removal -> trimap -> matting -> color correct -> fg, on
        (S, ...) batches.

        Returns (new carries, (alpha, fg) uint8 at work resolution, fg None
        when fetching on the host, and the screen color))."""
        h, w = self.work_hw
        min_fg = self.fg_exist_thr * h * w
        fg_exists = ((segmask >= 128).sum(dim=(-2, -1)) > min_fg)[:, None,
                                                                  None]

        # invalid-object removal (segmask consensus unless tracking),
        # labeled at 1/or_downscale resolution, one segment at a time
        was_tracking = torch.stack([c.tracking for c in carries])
        consensus_ref = torch.where(was_tracking[:, None, None], alphacf,
                                    segmask)
        alphaor = torch.stack([remove_invalid_objects_ds(
            a, ref, self.score_map, saliency_thr=self.saliency_thr,
            consensus_thr=self.consensus_thr, downscale=self.or_downscale)
            for a, ref in zip(alphacf, consensus_ref)])

        trimap = self._gen_trimap(alphaor, frames, bg_color, tier)
        alpha_pre = torch.stack([c.alpha_pre for c in carries])
        alpha = self.vmat.device_forward_impl(frames, alpha_pre, trimap,
                                              self.work_hw)
        alpha = torch.stack([color_correct(
            f, a, bgc, target_long_side=self.cc_long_side)
            for f, a, bgc in zip(frames, alpha, bg_color)])

        # no-foreground gate; fg only when it is downloaded
        fg = None
        if self.fetch_fg == "device":
            bg_px = bg_color[:, None, None, :]
            bg_img = torch.where((alpha < 128)[..., None], frames,
                                 bg_px.expand(frames.shape))
            fg = torch.where(fg_exists[..., None],
                             get_fg(frames, alpha, bg_img), 0.0)
            fg = fg.clamp(0.0, 255.0).to(torch.uint8)
        alpha = torch.where(fg_exists, alpha, 0.0)

        tracking = (alpha >= 128).sum(dim=(-2, -1)) > min_fg
        new_carries = [GreenCarry(alpha_pre=alpha[s], tracking=tracking[s],
                                  cf_state=cf_states[s], fid=c.fid + 1)
                       for s, c in enumerate(carries)]
        return new_carries, (alpha.clamp(0.0, 255.0).to(torch.uint8), fg,
                             bg_color)

    # -- host loop -----------------------------------------------------------
    def run(self, frames, chunk_size: int = 8, host_downscale: bool = True,
            timer: StageTimer = None):
        """Run a clip of uint8 (H, W, 3) BGR frames as one segment.

        Returns (alphas (N, h, w), fgs (N, h, w, 3), bgs (N, h, w, 3)) as
        uint8 numpy arrays at work resolution."""
        return self.run_segmented(frames, 1, chunk_size, host_downscale,
                                  timer)

    @torch.inference_mode()
    def run_segmented(self, frames, n_segments: int = 2,
                      chunk_size: int = 4, host_downscale: bool = True,
                      timer: StageTimer = None):
        """Split the clip into `n_segments` contiguous segments of
        ceil(N / S) frames (the tail padded with the last frame) and
        advance them in lockstep, S frames a step; outputs are fetched once
        every `chunk_size` steps. Segment boundaries reset the carry.
        `host_downscale` resizes the frames to work resolution on the host
        before the upload (else on the device). `timer` (a `StageTimer`)
        takes the stream_wait / dispatch / fetch / reconstruct split.
        Returns `run`'s arrays, in clip order, trimmed to N frames."""
        timer = timer or StageTimer()
        frames = list(frames)
        self.stats = collections.Counter()
        self.step_tracking = []
        wire_hw = self.work_hw if host_downscale else frames[0].shape[:2]
        payload, bg_colors, resident = run_segments(
            self._wire_step, self.init_carries(n_segments), frames,
            n_segments, chunk_size, self.device, self.stats, wire_hw,
            self.wire, timer, n_fetch=2)
        self.carries = resident.carries
        with timer.stage("fetch"):
            alphas = self._fetch_alphas(payload, resident)
        with timer.stage("reconstruct"):
            fgs = payload[..., 1:4] if self.fetch_fg == "device" else None
            return self._assemble_outputs(frames, alphas, bg_colors, fgs)

    def _fetch_alphas(self, payload: np.ndarray, resident) -> np.ndarray:
        """The (N, h, w) alphas of a run's fetched payload (N, h, w, C), or
        (N, packed_size) packed: unpacked, a frame whose band overflowed
        fetched whole from the device (`resident`, counted in `stats`)."""
        if not self.pack_d2h:
            return payload[..., 0]

        def fallback(i):
            plane = resident.frame(0, i)
            self.stats["fallbacks"] += 1
            self.stats["d2h_bytes"] += plane.nbytes
            return plane
        return unpack_planes(payload, *self.work_hw, self._pack_capacity,
                             fallback=fallback)

    def _assemble_outputs(self, frames, alphas, bg_colors, fgs=None):
        """The artifacts at work resolution from the fetched alphas (N, h,
        w) and screen colors (N, 3): the frames resized on the host from
        the originals; fg un-blended on the host unless the device made it
        (`fgs`); bg = alpha < 128 ? frame : screen color."""
        frames_w = host_frames(frames, self.work_hw)
        if fgs is None:
            fgs = runtime.get_fg_batch(frames_w, alphas, bg_colors)
        bgs = np.where(alphas[..., None] < 128, frames_w,
                       bg_colors[:, None, None, :].astype(np.uint8))
        return alphas, fgs, bgs


def save_artifacts(dst: str, kinds) -> None:
    """Write each (kind, (N, h, w[, 3]) uint8 images) as
    `<dst>/<kind>_<frame>.jpg`."""
    os.makedirs(dst, exist_ok=True)
    for kind, imgs in kinds:
        runtime.encode_batch(
            [artifact_path(dst, kind, i) for i in range(len(imgs))], imgs)


def run_fused(cfg: dict, frames=None, save: bool = False,
              chunk_size: int = 8, work_long_side: int = 960,
              segments: int = 1, wire: str = "bgr", profile: bool = False,
              matting_dtype: torch.dtype = torch.bfloat16,
              seg_dtype: torch.dtype = torch.bfloat16,
              device="cuda") -> dict:
    """Green-mode runner on the fused path. `frames` defaults to the clip
    of `cfg["data"]` read from disk; `save` writes `alphamask_`, `fg_` and
    `bg_*.jpg` at work resolution into `cfg["data"]["dst_img_dir"]`;
    `segments > 1` batches that many clip segments (`run_segmented`);
    `wire` is the upload's format; `profile` prints the per-stage report
    (each stage synchronized) and $VU_TRACE_DIR, when set, receives a
    profiler trace."""
    st = time.time()
    frame_list = list(frames) if frames is not None else read_frames(cfg)
    h, w, _ = frame_list[0].shape
    print(f"{len(frame_list)} frames. Reading Data Done! "
          f"{time.time() - st:.2f}s")
    pipe = FusedGreenPipeline(cfg, (h, w), work_long_side=work_long_side,
                              matting_dtype=matting_dtype,
                              seg_dtype=seg_dtype, wire=wire, device=device)
    timer = StageTimer(block=True) if profile else None
    st = time.time()
    with maybe_trace():
        alphas, fgs, bgs = pipe.run_segmented(frame_list, segments,
                                              chunk_size, timer=timer)
    elapsed = time.time() - st
    print(f"fused green: {len(frame_list)} frames in {elapsed:.2f}s "
          f"({len(frame_list) / elapsed:.2f} fps)")
    if timer is not None:
        print(timer.report(numframes=len(frame_list)))
    if save:
        save_artifacts(cfg["data"]["dst_img_dir"], (
            ("alphamask", np.repeat(alphas[..., None], 3, axis=-1)),
            ("fg", fgs), ("bg", bgs)))
    return {"alphas": list(alphas), "numframes": len(frame_list),
            "fps": len(frame_list) / elapsed}
