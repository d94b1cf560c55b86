"""TrimapAgent: resize-wrapped trimap generation.

Port of `video_unscreen_tpu/agents/trimap.py`. The mask goes NEAREST down
to long side `input_long_side`, the {0, 128, 255} band is made there
(kernel K1 on a card, `ops/trimap.py`), comes back up with a linear
resample, and in-between values are re-quantized to 128: the reference's
contract.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.compositing import is_pixel_inrange
from ..ops.geometry import get_target_size, resize
from ..ops.trimap import generate_trimap
from ..utils.device import as_float, resolve_device


class TrimapAgent:

    def __init__(self, input_long_side: int = 960, kernelsize: int = 3,
                 iters: int = 5,
                 color_winsize: Sequence[int] = (10, 100, 180),
                 device="cuda"):
        self.input_long_side = int(input_long_side)
        self.kernelsize = int(kernelsize)
        self.iters = int(iters)
        self.color_winsize = tuple(int(v) for v in color_winsize)
        self.device = resolve_device(device)

    # -- device cores (work at a given geometry) -----------------------------
    def device_generate(self, mask: torch.Tensor,
                        work_hw: Tuple[int, int]) -> torch.Tensor:
        """Mask-only trimap: NEAREST down, band, linear up, re-quantize."""
        tri = generate_trimap(resize(mask, work_hw, method="nearest"),
                              self.kernelsize, self.iters)
        tri = resize(tri, tuple(mask.shape))
        return torch.where((tri > 0) & (tri < 255), 128.0, tri)

    def device_generate_withbg(self, mask: torch.Tensor, img: torch.Tensor,
                               bg: torch.Tensor,
                               work_hw: Tuple[int, int]) -> torch.Tensor:
        """Chroma-ensembled trimap: the fuzzy-area test runs at full
        resolution, only the band at `work_hw`."""
        fg = mask > 0
        fg_count = fg.sum()
        fuzzy = fg & is_pixel_inrange(img, bg, self.color_winsize)
        fallback = fuzzy.sum() / fg_count.clamp_min(1) > 0.1
        take = ~fallback & fuzzy
        tri = self.device_generate(torch.where(take, 0.0, mask), work_hw)
        tri = torch.where(take, 128.0, tri)
        return torch.where(fg_count == 0, mask, tri)

    # -- host API -----------------------------------------------------------
    def _work_hw(self, h: int, w: int) -> Tuple[int, int]:
        return get_target_size(h, w, self.input_long_side)

    def generate_trimap(self, mask) -> torch.Tensor:
        m = as_float(mask, self.device)
        return self.device_generate(m, self._work_hw(*m.shape)).to(
            torch.uint8)

    def generate_trimap_withbg(self, mask, img, bg) -> torch.Tensor:
        m = as_float(mask, self.device)
        out = self.device_generate_withbg(
            m, as_float(img, self.device), as_float(bg, self.device),
            self._work_hw(*m.shape))
        return out.to(torch.uint8)

    def forward(self, *args) -> torch.Tensor:
        """Arity dispatch: (mask) or (mask, img, bg) -> uint8 trimap on the
        agent's device."""
        if len(args) > 2:
            return self.generate_trimap_withbg(*args)
        return self.generate_trimap(*args)
