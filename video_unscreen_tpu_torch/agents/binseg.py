"""Seed segmenters of the non-tracking frames.

Port of `video_unscreen_tpu/agents/binseg.py`: `SegAgent` (DeepLabV3+
ResNet-50 with grid and flip test-time augmentation), `HumanSegAgent`
(the SCHP human parser, bg mode's seed), `ChromaSegAgent` (the
weights-free chroma prior) and `build_seg_agent`.

SegAgent's TTA: the crop locations are fixed per frame geometry on the
host (`_crop_grid`); the crops of every frame, flipped ones mirrored, go
through ONE forward as one batch; the softmax is taken in float32, flipped
predictions are mirrored back, and the overlap ensemble is a sum of
slice-adds divided by the per-pixel count (floored at 1), in the JAX
package's order. Over the ranks of a model axis (`_tta_scores_sharded`)
each rank forwards its share of the crops and the sums and counts are
added up over the ranks, as the JAX package's `psum`.

HumanSegAgent: one whole-frame warp to the crop (473x473 as shipped) by
the aspect-corrected person box, SCHP, the 1/4 logits upsampled to the
crop, warped back to the frame, argmax, and > 0 -> 255. Both warps are
axis-aligned, so each is two products with host-built resampling matrices
(`ops/geometry.py:warp_planes`); a batch of frames goes through the net as
one batch.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.deeplab import build_deeplab
from ..models.human_parse import SCHPHumanParser
from ..models.precision import convs_to, empty_module
from ..ops.chroma import chroma_segment
from ..ops.geometry import (imnormalize, inv_pad_resize, pad_resize,
                            resize_nchw, warp_matrices, warp_planes)
from ..parallel.train import init_flax_like
from ..utils.checkpoint import load_deeplab, load_schp
from ..utils.device import as_float, resolve_device

Loc = Tuple[int, int, bool]
# crops per forward of the net: a batch of frames' TTA crops goes through
# the net in slices of this many. With S = 8's 8 frames x 12 crops of
# 513x513 in one bfloat16 forward, `run_segmented` with the DeepLab seed
# ran 2.15 frames/s on an H100, and 39.80 sliced 48 a forward
# (`chip_smoke.py --paths green_deeplab`)
_CROPS_PER_FORWARD = 48


def _crop_grid(h: int, w: int, crop_h: int, crop_w: int, stride_ratio: float,
               flip: bool) -> Tuple[Loc, ...]:
    """Crop locations (s_h, s_w, flipped) of a sliding crop_h x crop_w
    window at stride ceil(crop * stride_ratio), the last row and column
    clamped to the frame; with `flip` each location also comes mirrored."""
    stride_h = int(np.ceil(crop_h * stride_ratio))
    stride_w = int(np.ceil(crop_w * stride_ratio))
    grid_h = int(np.ceil(float(h - crop_h) / stride_h) + 1)
    grid_w = int(np.ceil(float(w - crop_w) / stride_w) + 1)
    locs = []
    for ih in range(grid_h):
        for iw in range(grid_w):
            s_h = min(ih * stride_h + crop_h, h) - crop_h
            s_w = min(iw * stride_w + crop_w, w) - crop_w
            locs.append((s_h, s_w, False))
            if flip:
                locs.append((s_h, s_w, True))
    return tuple(locs)


class SegAgent:
    """DeepLabV3+-resnet50 binary segmentation with grid and flip TTA.

    `model_path` is a flax msgpack checkpoint (or a dict of its variables
    as numpy arrays); None gives flax-like random weights from a
    `torch.Generator` seeded with `seed`. `dtype` is the convolutions'
    (`models/precision.py`): float32 or bfloat16; the scores are float32
    either way. `device` is the card unless the caller passes "cpu".
    `forwards` counts the net's forward calls and `frames` the frames
    segmented, so a caller can tell when the seed ran."""

    def __init__(self, model_path: Optional[str] = None,
                 input_long_side: int = 912, crop_h: int = 513,
                 crop_w: int = 513, stride_ratio: float = 0.5,
                 flip: bool = True, cuda_device: int = 0,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        del cuda_device  # the reference's; placement is `device`
        self.device = resolve_device(device)
        self.crop_h = int(crop_h)
        self.crop_w = int(crop_w)
        self.flip = bool(flip)
        self.input_long_side = int(input_long_side)
        self.stride_ratio = float(stride_ratio)
        self.dtype = dtype
        model = empty_module(lambda: build_deeplab(num_classes=2))
        if model_path:
            model.load_state_dict(load_deeplab(model_path))
        else:
            init_flax_like(model, torch.Generator().manual_seed(seed))
        self.model = convs_to(model.to(self.device).eval(), dtype)
        self.forwards = 0
        self.frames = 0

    def get_target_size(self, h: int, w: int) -> Tuple[int, int]:
        """Long-side resize target, floored at the crop size."""
        if h > w:
            th, tw = self.input_long_side, int(
                float(self.input_long_side) * w / h)
        else:
            tw, th = self.input_long_side, int(
                float(self.input_long_side) * h / w)
        return max(th, self.crop_h), max(tw, self.crop_w)

    def _tta_sums(self, norm: torch.Tensor, locs: Sequence[Loc],
                  crop_h: int, crop_w: int):
        """(B, H, W, 3) normalized frames -> the overlap sums (B, 2, H, W)
        and counts (H, W), float32, of the crops at `locs`: all B x
        len(locs) crops through the net 48 at a time, softmax, the flipped
        ones mirrored back, added in `locs` order."""
        n_b, h, w, _ = norm.shape
        acc = torch.zeros((n_b, 2, h, w), dtype=torch.float32,
                          device=norm.device)
        cnt = torch.zeros((h, w), dtype=torch.float32, device=norm.device)
        self.frames += n_b
        if not locs:
            return acc, cnt
        crops = []
        for s_h, s_w, flipped in locs:
            c = norm[:, s_h:s_h + crop_h, s_w:s_w + crop_w]
            crops.append(c.flip(2) if flipped else c)
        batch = torch.stack(crops, dim=1).reshape(-1, crop_h, crop_w, 3)
        step = _CROPS_PER_FORWARD
        logits = torch.cat([self.model(batch[i:i + step].permute(0, 3, 1, 2))
                            for i in range(0, batch.shape[0], step)])
        self.forwards += 1
        probs = torch.softmax(logits.float(), dim=1).reshape(
            n_b, len(locs), 2, crop_h, crop_w)
        for i, (s_h, s_w, flipped) in enumerate(locs):
            p = probs[:, i].flip(3) if flipped else probs[:, i]
            acc[:, :, s_h:s_h + crop_h, s_w:s_w + crop_w] += p
            cnt[s_h:s_h + crop_h, s_w:s_w + crop_w] += 1.0
        return acc, cnt

    def _tta_scores(self, norm: torch.Tensor, locs: Sequence[Loc],
                    crop_h: int, crop_w: int) -> torch.Tensor:
        """(B, H, W, 3) normalized frames -> (B, H, W, 2) float32 scores:
        the overlap sums of every crop divided by the count."""
        acc, cnt = self._tta_sums(norm, locs, crop_h, crop_w)
        return (acc / cnt.clamp_min(1.0)).permute(0, 2, 3, 1)

    def _tta_scores_sharded(self, norm: torch.Tensor, locs: Sequence[Loc],
                            crop_h: int, crop_w: int, group,
                            size: int) -> torch.Tensor:
        """`_tta_scores` with the crops split over the `size` ranks of
        `group`, as the JAX `_tta_scores_sharded`: rank m of the group
        takes crops [m k, (m + 1) k) with k = ceil(len(locs) / size); the
        pad crops past the end weigh 0, so they are not forwarded. The
        sums and counts are added up over the group (`all_reduce`) and
        divided: the unsharded scores up to the order of the float sums.
        Every rank of the group must call this with the same frames."""
        k = -(-len(locs) // size)
        m = dist.get_rank(group)
        acc, cnt = self._tta_sums(norm, locs[m * k:(m + 1) * k], crop_h,
                                  crop_w)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(cnt, op=dist.ReduceOp.SUM, group=group)
        return (acc / cnt.clamp_min(1.0)).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_scores(self, frames: torch.Tensor,
                       model_axis=None) -> torch.Tensor:
        """(H, W, 3) or (B, H, W, 3) BGR 0..255 at the frames' own (work)
        resolution -> (..., H, W, 2) float32 TTA scores. The crop is
        clamped to the frame, so a frame smaller than the crop is one
        whole-frame crop and its flip. `model_axis`, a mesh axis
        (`parallel/mesh.py:Axis`) of size > 1, splits the crops over its
        ranks (`_tta_scores_sharded`)."""
        batch = frames if frames.dim() == 4 else frames[None]
        h, w = batch.shape[1:3]
        crop_h, crop_w = min(self.crop_h, h), min(self.crop_w, w)
        locs = _crop_grid(h, w, crop_h, crop_w, self.stride_ratio, self.flip)
        norm = imnormalize(batch)
        if model_axis is not None and model_axis.size > 1:
            score = self._tta_scores_sharded(norm, locs, crop_h, crop_w,
                                             model_axis.group,
                                             model_axis.size)
        else:
            score = self._tta_scores(norm, locs, crop_h, crop_w)
        return score if frames.dim() == 4 else score[0]

    def predict_mask_impl(self, frames: torch.Tensor,
                          model_axis=None) -> torch.Tensor:
        """`predict_scores` -> {0, 255} float32 mask (argmax); the crops
        split over the ranks of `model_axis` when given."""
        score = self.predict_scores(frames, model_axis)
        return torch.argmax(score, dim=-1).to(torch.float32) * 255.0

    @torch.inference_mode()
    def forward(self, img) -> torch.Tensor:
        """BGR frame (numpy or tensor, 0..255) -> uint8 {0, 255} mask on
        the agent's device: pad-resized to `get_target_size`, the crop
        grid at that size, scores resized back to the frame."""
        x = as_float(img, self.device)
        h, w = x.shape[:2]
        target_hw = self.get_target_size(h, w)
        locs = _crop_grid(*target_hw, self.crop_h, self.crop_w,
                          self.stride_ratio, self.flip)
        norm = imnormalize(pad_resize(x, target_hw))
        score = self._tta_scores(norm[None], locs, self.crop_h,
                                 self.crop_w)[0]
        score = inv_pad_resize(score, (h, w))
        return (torch.argmax(score, dim=-1) * 255).to(torch.uint8)


class HumanSegAgent:
    """SCHP-LIP human parsing as binary segmentation (bg mode's seed).

    `model_path` is a flax msgpack checkpoint (or a dict of its
    variables); None gives flax-like random weights from a
    `torch.Generator` seeded with `seed`. `dtype` is the convolutions'
    (`models/precision.py`); the logits are float32 either way. `downscale`,
    `stride_ratio` and `flip` are the SegAgent config's, accepted for
    parity and ignored with a warning when set, as in the JAX package
    (SCHP runs one whole-frame warp). `forwards` and `frames` count the
    net's forwards and the frames segmented."""

    def __init__(self, model_path: Optional[str] = None,
                 input_long_side: int = 912, downscale: int = 1,
                 crop_h: int = 473, crop_w: int = 473,
                 stride_ratio: float = 0.5, flip: bool = True,
                 cuda_device: int = 0, dtype: torch.dtype = torch.float32,
                 seed: int = 0, layers: Sequence[int] = (3, 4, 23, 3),
                 device="cuda"):
        del input_long_side, cuda_device  # the reference's; unused
        for name, val, default in (("downscale", downscale, 1),
                                   ("stride_ratio", stride_ratio, 0.5),
                                   ("flip", flip, True)):
            if val != default:
                warnings.warn(
                    f"HumanSegAgent ignores {name!r} (accepted for "
                    f"SegAgent config parity only; SCHP runs one "
                    f"whole-frame affine warp)", stacklevel=2)
        self.device = resolve_device(device)
        self.input_size = (int(crop_h), int(crop_w))
        model = empty_module(lambda: SCHPHumanParser(20, tuple(layers)))
        if model_path:
            model.load_state_dict(load_schp(model_path))
        else:
            init_flax_like(model, torch.Generator().manual_seed(seed))
        self.model = convs_to(model.to(self.device).eval(), dtype)
        self._warps = {}
        self.forwards = 0
        self.frames = 0

    def _transforms(self, h: int, w: int):
        """Aspect-corrected person-box warp matrices (frame -> crop, crop ->
        frame), float32 2x3, as the JAX package builds them."""
        ih, iw = self.input_size
        aspect = iw / ih
        cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
        bw, bh = w - 1, h - 1
        if bw > aspect * bh:
            bh = bw / aspect
        elif bw < aspect * bh:
            bw = bh * aspect
        scale_x, scale_y = iw / bw, ih / bh
        fwd = np.array([[scale_x, 0.0, iw / 2.0 - scale_x * cx],
                        [0.0, scale_y, ih / 2.0 - scale_y * cy]], np.float32)
        inv = np.array([[1.0 / scale_x, 0.0, cx - iw / (2.0 * scale_x)],
                        [0.0, 1.0 / scale_y, cy - ih / (2.0 * scale_y)]],
                       np.float32)
        return fwd, inv

    def _warp_pair(self, h: int, w: int):
        """The resampling matrices of both warps for an (h, w) frame, made
        once a geometry and kept on the device."""
        key = (h, w)
        if key not in self._warps:
            fwd, inv = self._transforms(h, w)
            self._warps[key] = (
                warp_matrices(fwd, (h, w), self.input_size, self.device),
                warp_matrices(inv, self.input_size, (h, w), self.device))
        return self._warps[key]

    @torch.inference_mode()
    def predict_logits(self, frames: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) or (B, H, W, 3) BGR 0..255 -> (..., 20, H, W) float32
        logits warped back onto the frame."""
        batch = frames if frames.dim() == 4 else frames[None]
        h, w = batch.shape[1:3]
        to_crop, to_frame = self._warp_pair(h, w)
        crops = warp_planes(batch.permute(0, 3, 1, 2), *to_crop)
        norm = imnormalize(crops.permute(0, 2, 3, 1))
        logits = self.model(norm.permute(0, 3, 1, 2))
        self.forwards += 1
        self.frames += batch.shape[0]
        back = warp_planes(resize_nchw(logits, self.input_size), *to_frame)
        return back if frames.dim() == 4 else back[0]

    def predict_mask_impl(self, frames: torch.Tensor,
                          model_axis=None) -> torch.Tensor:
        """{0, 255} float32 person mask of (H, W, 3) or (B, H, W, 3) frames
        at their own resolution: class > 0 is the person. `model_axis` is
        accepted for the seed interface (SCHP has no crop batch to
        shard)."""
        del model_axis
        logits = self.predict_logits(frames)
        return (torch.argmax(logits, dim=-3) > 0).to(torch.float32) * 255.0

    def forward(self, img) -> torch.Tensor:
        """BGR frame (numpy or tensor, 0..255) -> uint8 {0, 255} mask on
        the agent's device."""
        return self.predict_mask_impl(as_float(img, self.device)).to(
            torch.uint8)


class ChromaSegAgent:
    """Foreground = NOT near the dominant screen color, cleaned by
    open/close morphology, at the frame's own resolution."""

    def __init__(self, input_long_side: int = 960,
                 color_winsize=(24, 140, 240), clean_iters: int = 2,
                 device="cuda", **_ignored):
        self.input_long_side = int(input_long_side)
        self.color_winsize = tuple(int(v) for v in color_winsize)
        self.clean_iters = int(clean_iters)
        self.device = resolve_device(device)

    def device_forward(self, img: torch.Tensor) -> torch.Tensor:
        return chroma_segment(img, self.color_winsize, self.clean_iters)[0]

    def forward(self, img) -> torch.Tensor:
        """BGR frame -> uint8 {0, 255} mask on the agent's device."""
        return self.device_forward(as_float(img, self.device)).to(
            torch.uint8)


def build_seg_agent(cfg_binseg: dict, device="cuda"):
    """The agent for a binseg config section: "deeplab" (the default, as
    in the JAX package), "human" (SCHP) or "chroma"."""
    kw = dict(cfg_binseg)
    kind = kw.pop("type", "deeplab")
    if kind == "chroma":
        return ChromaSegAgent(device=device, **kw)
    if kind == "human":
        return HumanSegAgent(device=device, **kw)
    return SegAgent(device=device, **kw)
