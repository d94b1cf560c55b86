"""Seed segmenters of the non-tracking frames.

Port of `video_unscreen_tpu/agents/binseg.py`: `ChromaSegAgent` (the
weights-free chroma prior) and `build_seg_agent`. The DeepLab
(`"deeplab"`) and SCHP (`"human"`) seeds are not ported yet (ROADMAP.md,
Queue 1, items 8 and 16): asking for one raises.
"""

from __future__ import annotations

import torch

from ..ops.chroma import chroma_segment
from ..utils.device import as_float, resolve_device


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
    raise NotImplementedError(
        f"binseg type {kind!r}: the DeepLab and SCHP seeds are not ported "
        "yet (ROADMAP.md, Queue 1, items 8 and 16); set binseg to "
        "{'type': 'chroma'}")
