"""VMattingAgent: temporal alpha matting with the MattingUNet.

Port of `video_unscreen_tpu/agents/vmatting.py` (`device_forward_impl`
and the host API `forward`):
pad/resize to a multiple of 32, the {0, 128, 255} trimap as three one-hot
channels, the net, the inverse geometry, and the hard reset outside the
unknown band (0 where the trimap is 0, 1 where it is 255). A batch of
frames goes through the net as one batch. `dtype` is the net's
(`models/precision.py`): float32, or bfloat16 as the JAX green pipeline
runs it; the alpha is float32 either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.matting_unet import MattingUNet
from ..models.precision import convs_to, empty_module
from ..ops.geometry import (get_target_size, imnormalize, inv_pad_resize,
                            pad_resize)
from ..parallel.train import init_flax_like
from ..utils.checkpoint import load_matting_unet
from ..utils.device import as_float, resolve_device


class VMattingAgent:
    DIVISION = 32

    def __init__(self, model_path: Optional[str] = None,
                 input_long_side: int = 960, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        """`model_path` is a flax msgpack checkpoint (or a dict of its
        variables as numpy arrays); None gives flax-like random weights
        from a `torch.Generator` seeded with `seed`. A `.meta.json` sidecar
        asking for the SpectralNorm fold is refused: none ships, and the
        fold is not ported. `device` is the card unless the caller passes
        "cpu"."""
        if input_long_side % self.DIVISION != 0:
            input_long_side = (input_long_side // self.DIVISION + 1
                               ) * self.DIVISION
        self.input_long_side = int(input_long_side)
        self.device = resolve_device(device)
        model = empty_module(MattingUNet)
        if model_path is not None:
            if isinstance(model_path, str):
                self._refuse_spectral_norm(model_path)
            model.load_state_dict(load_matting_unet(model_path))
        else:
            init_flax_like(model, torch.Generator().manual_seed(seed))
        self.model = convs_to(model.to(self.device).eval(), dtype)

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
        alpha 0..255, or the same with a leading batch axis on all four."""
        if trimap.dim() == 2:
            return self.device_forward_impl(img[None], alpha_pre[None],
                                            trimap[None], input_hw)[0]
        ori_hw = tuple(trimap.shape[1:])
        img_p = torch.stack([pad_resize(x, input_hw) for x in img])
        tri_p = torch.stack([pad_resize(t, input_hw) for t in trimap])
        ap_p = torch.stack([pad_resize(a, input_hw) for a in alpha_pre]) \
            / 255.0
        norm = imnormalize(img_p)
        # one-hot trimap: 0 -> bg, (0, 255) -> unknown, 255 -> fg
        cls = torch.where(tri_p >= 255.0, 2, torch.where(tri_p > 0.0, 1, 0))
        tri_oh = F.one_hot(cls.to(torch.int64), 3).to(norm.dtype)
        pred = self.model(norm.permute(0, 3, 1, 2), ap_p[:, None],
                          tri_oh.permute(0, 3, 1, 2))[:, 0]
        pred = torch.stack([inv_pad_resize(p, ori_hw) for p in pred])
        # keep the prediction only in the unknown band
        pred = torch.where(trimap == 0.0, 0.0, pred)
        pred = torch.where(trimap == 255.0, 1.0, pred)
        return pred * 255.0

    @torch.inference_mode()
    def forward(self, img, alpha_pre, trimap) -> torch.Tensor:
        """BGR frame, previous alpha and trimap (numpy or tensors, uint8
        ranges) -> the uint8 alpha on the agent's device."""
        tri = as_float(trimap, self.device)
        h, w = tri.shape
        input_hw = get_target_size(h, w, self.input_long_side, self.DIVISION)
        out = self.device_forward_impl(as_float(img, self.device),
                                       as_float(alpha_pre, self.device), tri,
                                       input_hw)
        return out.clamp(0, 255).to(torch.uint8)
