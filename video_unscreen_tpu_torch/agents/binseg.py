"""Seed segmenters of the non-tracking frames.

Port of `video_unscreen_tpu/agents/binseg.py`: `SegAgent` (DeepLabV3+
ResNet-50 with grid and flip test-time augmentation), `ChromaSegAgent`
(the weights-free chroma prior) and `build_seg_agent`. The SCHP seed
(`"human"`) is not ported yet (ROADMAP.md, Queue 1, item 16): asking for
it raises.

SegAgent's TTA: the crop locations are fixed per frame geometry on the
host (`_crop_grid`); the crops of every frame, flipped ones mirrored, go
through ONE forward as one batch; the softmax is taken in float32, flipped
predictions are mirrored back, and the overlap ensemble is a sum of
slice-adds divided by the per-pixel count (floored at 1), in the JAX
package's order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.deeplab import build_deeplab
from ..models.precision import convs_to, empty_module
from ..ops.chroma import chroma_segment
from ..ops.geometry import imnormalize, inv_pad_resize, pad_resize
from ..parallel.train_stm import init_flax_like
from ..utils.checkpoint import load_deeplab
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

    def _tta_scores(self, norm: torch.Tensor, locs: Sequence[Loc],
                    crop_h: int, crop_w: int) -> torch.Tensor:
        """(B, H, W, 3) normalized frames -> (B, H, W, 2) float32 scores:
        all B x len(locs) crops in one forward, softmax, the flipped ones
        mirrored back, summed over the overlaps and divided by the count."""
        n_b, h, w, _ = norm.shape
        crops = []
        for s_h, s_w, flipped in locs:
            c = norm[:, s_h:s_h + crop_h, s_w:s_w + crop_w]
            crops.append(c.flip(2) if flipped else c)
        batch = torch.stack(crops, dim=1).reshape(-1, crop_h, crop_w, 3)
        step = _CROPS_PER_FORWARD
        logits = torch.cat([self.model(batch[i:i + step].permute(0, 3, 1, 2))
                            for i in range(0, batch.shape[0], step)])
        self.forwards += 1
        self.frames += n_b
        probs = torch.softmax(logits.float(), dim=1).reshape(
            n_b, len(locs), 2, crop_h, crop_w)
        acc = torch.zeros((n_b, 2, h, w), dtype=torch.float32,
                          device=norm.device)
        cnt = torch.zeros((h, w), dtype=torch.float32, device=norm.device)
        for i, (s_h, s_w, flipped) in enumerate(locs):
            p = probs[:, i].flip(3) if flipped else probs[:, i]
            acc[:, :, s_h:s_h + crop_h, s_w:s_w + crop_w] += p
            cnt[s_h:s_h + crop_h, s_w:s_w + crop_w] += 1.0
        return (acc / cnt.clamp_min(1.0)).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_scores(self, frames: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) or (B, H, W, 3) BGR 0..255 at the frames' own (work)
        resolution -> (..., H, W, 2) float32 TTA scores. The crop is
        clamped to the frame, so a frame smaller than the crop is one
        whole-frame crop and its flip."""
        batch = frames if frames.dim() == 4 else frames[None]
        h, w = batch.shape[1:3]
        crop_h, crop_w = min(self.crop_h, h), min(self.crop_w, w)
        locs = _crop_grid(h, w, crop_h, crop_w, self.stride_ratio, self.flip)
        score = self._tta_scores(imnormalize(batch), locs, crop_h, crop_w)
        return score if frames.dim() == 4 else score[0]

    def predict_mask_impl(self, frames: torch.Tensor,
                          model_axis=None) -> torch.Tensor:
        """`predict_scores` -> {0, 255} float32 mask (argmax). Sharding
        the crop batch over a mesh axis (`model_axis` of size > 1) is the
        multi-device path, not ported yet (ROADMAP.md, Queue 1, item 21)."""
        if model_axis is not None and model_axis[1] > 1:
            raise NotImplementedError(
                "sharding the TTA crops over a model axis is not ported yet "
                "(ROADMAP.md, Queue 1, item 21)")
        score = self.predict_scores(frames)
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
    """The agent for a binseg config section. `type` defaults to
    "deeplab", as in the JAX package."""
    kw = dict(cfg_binseg)
    kind = kw.pop("type", "deeplab")
    if kind == "chroma":
        return ChromaSegAgent(device=device, **kw)
    if kind == "human":
        raise NotImplementedError(
            "binseg type 'human': the SCHP seed is not ported yet "
            "(ROADMAP.md, Queue 1, item 16)")
    return SegAgent(device=device, **kw)
