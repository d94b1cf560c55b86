"""VMattingAgent: temporal alpha matting with the MattingUNet.

Port of `video_unscreen_tpu/agents/vmatting.py` (`device_forward_impl`):
pad/resize to a multiple of 32, the {0, 128, 255} trimap as three one-hot
channels, the net, the inverse geometry, and the hard reset outside the
unknown band (0 where the trimap is 0, 1 where it is 255).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.matting_unet import MattingUNet
from ..ops.geometry import imnormalize, inv_pad_resize, pad_resize
from ..utils.checkpoint import load_matting_unet
from ..utils.device import resolve_device


class VMattingAgent:
    DIVISION = 32

    def __init__(self, model_path: Optional[str] = None,
                 input_long_side: int = 960, device="cuda"):
        """`model_path` is a flax msgpack checkpoint (or a dict of its
        variables as numpy arrays); None gives random weights from seed 0.
        A `.meta.json` sidecar asking for the SpectralNorm fold is refused:
        none ships, and the fold is not ported. `device` is the card unless
        the caller passes "cpu"."""
        if input_long_side % self.DIVISION != 0:
            input_long_side = (input_long_side // self.DIVISION + 1
                               ) * self.DIVISION
        self.input_long_side = int(input_long_side)
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = MattingUNet()
        if model_path is not None:
            if isinstance(model_path, str):
                self._refuse_spectral_norm(model_path)
            model.load_state_dict(load_matting_unet(model_path))
        self.model = model.to(self.device).eval()

    @staticmethod
    def _refuse_spectral_norm(model_path: str) -> None:
        import json
        import os.path as osp
        meta = f"{model_path}.meta.json"
        if osp.exists(meta):
            with open(meta) as f:
                if json.load(f).get("pre_spectral_norm", False):
                    raise NotImplementedError(
                        f"{meta} asks for the SpectralNorm fold, which the "
                        "port does not run yet")

    def device_forward_impl(self, img: torch.Tensor, alpha_pre: torch.Tensor,
                            trimap: torch.Tensor,
                            input_hw: Tuple[int, int]) -> torch.Tensor:
        """(H, W, 3) BGR + (H, W) alpha_pre + (H, W) trimap -> (H, W)
        alpha 0..255."""
        ori_hw = tuple(trimap.shape)
        img_p = pad_resize(img, input_hw)
        tri_p = pad_resize(trimap, input_hw)
        ap_p = pad_resize(alpha_pre, input_hw) / 255.0
        norm = imnormalize(img_p)
        # one-hot trimap: 0 -> bg, (0, 255) -> unknown, 255 -> fg
        cls = torch.where(tri_p >= 255.0, 2, torch.where(tri_p > 0.0, 1, 0))
        tri_oh = F.one_hot(cls.to(torch.int64), 3).to(norm.dtype)
        pred = self.model(norm.permute(2, 0, 1)[None],
                          ap_p[None, None],
                          tri_oh.permute(2, 0, 1)[None])[0, 0]
        pred = inv_pad_resize(pred, ori_hw)
        # keep the prediction only in the unknown band
        pred = torch.where(trimap == 0.0, 0.0, pred)
        pred = torch.where(trimap == 255.0, 1.0, pred)
        return pred * 255.0
