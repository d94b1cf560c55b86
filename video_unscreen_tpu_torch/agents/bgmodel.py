"""BackgroundAgent: background inpainting behind a foreground mask.

Port of `video_unscreen_tpu/agents/bgmodel.py`, at long side
`input_long_side` (540 by default). The mask is dilated (kernel K2, an
ellipse of `dilation_ksize`, `dilation_iters` times) and then filled by
one of three methods:

- `mean`: the mean HSV colour of the ring around the hole
  (`ops.morphology.get_outer_boundary`, K2 again);
- `pcov`: partial convolution, box filter after box filter until every
  pixel is known. The JAX package runs a `lax.while_loop`; here it is a
  host loop with the same stopping rule (every pixel known, or 100
  iterations), one sync an iteration, and `pcov_iters` keeps the last
  count;
- `rf` (default): the CG regionfill of the V channel at half resolution
  (`ops/regionfill.py`), H and S from the ring's mean.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.color import bgr2hsv, hsv2bgr
from ..ops.geometry import get_target_size, resize
from ..ops.morphology import box_filter, dilate, get_outer_boundary
from ..ops.regionfill import regionfill
from ..utils.device import as_float, resolve_device

PCOV_MAX_ITERS = 100


class BackgroundAgent:
    """The surface of the JAX `BackgroundAgent`, plus `device`."""

    def __init__(self, input_long_side: int = 540,
                 dilation_ksize: int = 5, dilation_iters: int = 3,
                 boundary_ksize: int = 7, boundary_iters: int = 10,
                 pcov_ksize: int = 5, device="cuda"):
        self.input_long_side = int(input_long_side)
        self.dilation_ksize = int(dilation_ksize)
        self.dilation_iters = int(dilation_iters)
        self.boundary_ksize = int(boundary_ksize)
        self.boundary_iters = int(boundary_iters)
        self.pcov_ksize = int(pcov_ksize)
        self.device = resolve_device(device)
        self.pcov_iters = None

    # -- device cores -------------------------------------------------------
    def _mean_bg_color(self, img_hsv: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """Mean HSV colour of the ring around `mask`, or of the whole image
        when the ring is empty."""
        boundary = get_outer_boundary(mask, self.boundary_ksize,
                                      self.boundary_iters) > 0
        cnt = boundary.sum()
        band_mean = (img_hsv * boundary[..., None].to(torch.float32)
                     ).sum((0, 1)) / cnt.clamp_min(1)
        return torch.where(cnt == 0, img_hsv.mean((0, 1)), band_mean)

    def _dilated(self, mask: torch.Tensor) -> torch.Tensor:
        return dilate(mask, self.dilation_ksize, self.dilation_iters)

    @staticmethod
    def _fuse(dmask: torch.Tensor, bg: torch.Tensor,
              img: torch.Tensor) -> torch.Tensor:
        a = (dmask / 255.0)[..., None]
        return a * bg + (1.0 - a) * img

    def device_mean(self, img: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        img_hsv = bgr2hsv(img)
        dmask = self._dilated(mask)
        color = self._mean_bg_color(img_hsv, dmask)
        return self._fuse(dmask, hsv2bgr(color.expand(img.shape)), img)

    def device_pcov(self, img: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """Partial-convolution fill over the whole frame: each iteration
        replaces every pixel that has a known neighbour in the box by the
        mean of its known neighbours, until every pixel is known."""
        dmask = self._dilated(mask)
        hole = dmask > 0
        bg = torch.where(hole[..., None], 0.0, img)
        count = (~hole).to(torch.float32)
        total = float(mask.shape[0] * mask.shape[1])
        it = 0
        # the JAX loop's condition, read on the host (one sync each)
        while it < PCOV_MAX_ITERS and float(count.sum()) < total:
            bg_f = box_filter(bg, self.pcov_ksize)
            cnt_f = box_filter(count, self.pcov_ksize)
            filled = cnt_f > 0
            bg = torch.where(filled[..., None],
                             (bg_f / cnt_f.clamp_min(1e-6)[..., None]
                              ).clamp(0, 255), bg)
            count = filled.to(torch.float32)
            it += 1
        self.pcov_iters = it
        return self._fuse(dmask, bg, img)

    def device_rf(self, img: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        """The V channel regionfilled at half resolution behind the dilated
        mask; H and S there from the ring's mean."""
        img_hsv = bgr2hsv(img)
        dmask = self._dilated(mask)
        color = self._mean_bg_color(img_hsv, dmask)
        v_filled = regionfill(img_hsv[..., 2], dmask, 0.5)
        hole = dmask > 0
        bg_hsv = torch.where(hole[..., None], color, img_hsv)
        v = torch.where(hole, v_filled, img_hsv[..., 2])
        return hsv2bgr(torch.cat([bg_hsv[..., :2], v[..., None]], -1))

    # -- host API -----------------------------------------------------------
    @torch.inference_mode()
    def forward(self, img: np.ndarray, mask: np.ndarray,
                method: str = "rf") -> np.ndarray:
        """The inpainted uint8 background of a BGR frame behind a uint8
        mask, at the frame's size. A mask without background gives float
        zeros, one without foreground the frame itself (the JAX agent's
        two early exits)."""
        mask_np = np.asarray(mask)
        if (mask_np == 0).sum() == 0:
            return np.zeros(np.asarray(img).shape)
        if mask_np.sum() == 0:
            return np.asarray(img)
        ori_h, ori_w = mask_np.shape
        th, tw = get_target_size(ori_h, ori_w, self.input_long_side)
        img_d = resize(as_float(img, self.device), (th, tw))
        mask_d = resize(as_float(mask_np, self.device), (th, tw))
        fn = {"mean": self.device_mean, "pcov": self.device_pcov,
              "rf": self.device_rf}.get(method)
        if fn is None:
            raise NameError(
                f"No such method for background inpainting: {method}")
        bg = resize(fn(img_d, mask_d), (ori_h, ori_w))
        return bg.clamp(0, 255).to(torch.uint8).cpu().numpy()
