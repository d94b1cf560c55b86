"""STMAgent: mask propagation across frames with the Space-Time Memory.

Port of `video_unscreen_tpu/agents/stm.py`. The JAX package runs the frame
loop as one `lax.scan`; here it is a Python loop over the same steps, with
the same memory semantics:

- the bank is a ring buffer of `memory_capacity` committed slots plus one
  slot for the previous frame's memory, which the current frame always
  sees; a slot is read only where `valid` says so;
- every `memory_step`-th step ((t - 1) % memory_step == 0) commits the
  previous frame's memory, FIFO: when the bank is full its slots shift by
  one and the newest goes last.

Frames go in through `pad_resize` and `imnormalize` at the long side
`input_long_side` (a multiple of 16); scores come back through
`inv_pad_resize` and an argmax.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.precision import convs_to
from ..models.stm import STM
from ..ops.geometry import (get_target_size, imnormalize, inv_pad_resize,
                            pad_resize)
from ..utils.checkpoint import load_stm
from ..utils.device import as_float, resolve_device


class STMAgent:
    DIVISION = 16

    def __init__(self, model_path: Optional[str] = None,
                 input_long_side: int = 960, memory_step: int = 2,
                 memory_capacity: int = 10, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32):
        """`model_path` is a flax msgpack checkpoint (or a dict of its
        variables as numpy arrays); None gives random weights from
        `seed`. `device` is the card unless the caller passes "cpu".
        `dtype` is the convolutions' (`models/precision.py`)."""
        self.device = resolve_device(device)
        self.input_long_side = int(input_long_side)
        self.memory_step = int(memory_step)
        self.memory_capacity = int(memory_capacity)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = STM()
        if model_path:
            model.load_state_dict(load_stm(model_path))
        self.model = convs_to(model.to(self.device).eval(), dtype)

    @torch.inference_mode()
    def device_inference(self, frames: List[torch.Tensor],
                         mask0: torch.Tensor) -> List[torch.Tensor]:
        """frames: (H, W, 3) normalized, H and W multiples of 16; mask0
        (H, W) in [0, 1]. Returns each frame's (H, W, 2) softmax scores."""
        h, w = mask0.shape
        hm, wm = h // 16, w // 16
        cap = self.memory_capacity
        # slots 0..cap-1: committed memories; slot cap: the previous frame
        bank_k = torch.zeros((1, cap + 1, hm, wm, 128), device=self.device)
        bank_v = torch.zeros((1, cap + 1, hm, wm, 512), device=self.device)
        valid = torch.zeros((1, cap + 1), dtype=torch.bool,
                            device=self.device)
        valid[0, cap] = True
        n_bank = 0
        pred = torch.stack([1.0 - mask0, mask0], dim=-1)
        preds = [pred]
        for t in range(1, len(frames)):
            k, v = self.model.memorize(
                frames[t - 1].permute(2, 0, 1)[None], pred[None, :, :, 1],
                pred[None, :, :, 0])
            bank_k[:, cap] = k
            bank_v[:, cap] = v
            logits = self.model.segment(frames[t].permute(2, 0, 1)[None],
                                        bank_k, bank_v, valid)
            pred = torch.softmax(logits[0], dim=0).permute(1, 2, 0)
            preds.append(pred)
            if (t - 1) % self.memory_step == 0:
                if n_bank >= cap:
                    bank_k[:, :cap - 1] = bank_k[:, 1:cap].clone()
                    bank_v[:, :cap - 1] = bank_v[:, 1:cap].clone()
                idx = min(n_bank, cap - 1)
                bank_k[:, idx] = k
                bank_v[:, idx] = v
                n_bank = min(n_bank + 1, cap)
                valid[0, :n_bank] = True
        return preds

    def forward(self, framelist, mask0) -> List[torch.Tensor]:
        """Frames (BGR uint8, numpy or tensors) and the first frame's mask
        -> each frame's uint8 {0, 255} mask, on the agent's device."""
        ori_hw = tuple(framelist[0].shape[:2])
        input_hw = get_target_size(*ori_hw, self.input_long_side,
                                   self.DIVISION)
        frames = [imnormalize(pad_resize(as_float(f, self.device), input_hw))
                  for f in framelist]
        m0 = pad_resize(as_float(mask0, self.device), input_hw,
                        method="nearest") / 255.0
        out = []
        for score in self.device_inference(frames, m0):
            score = inv_pad_resize(score, ori_hw)
            out.append((torch.argmax(score, dim=-1) * 255).to(torch.uint8))
        return out
