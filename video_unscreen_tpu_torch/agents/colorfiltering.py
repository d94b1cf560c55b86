"""ColorFilteringAgent: chroma-key alpha from six 1-D GMMs, on the device.

Port of `video_unscreen_tpu/agents/colorfiltering.py` (the device core the
fused green pipeline runs): the 256-bin hue prior, stride-subsampled
weighted-EM fits of the (3 HSV channels x {fg, bg}) GMM banks warm-started
from a carried `CFState`, the per-pixel mixture alpha, the adaptive
threshold plus close/open cleanup, and the degenerate-input guards. The
refit loop runs a fixed number of iterations; a `live` flag freezes the
state once fg or bg runs dry, as the JAX `lax.cond` does, with selects and
no host sync. The host API of the modular green driver (`forward`,
`is_trained`) keeps the agent's own `state`, as the JAX agent does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import color as colorops
from ..ops import morphology as morph
from ..ops.geometry import get_target_size, resize
from ..ops.gmm import GMMParams, gmm_fit_em, gmm_init, gmm_pdf
from ..utils.device import as_float, resolve_device


class CFState(NamedTuple):
    """Carried agent state."""
    bg: GMMParams   # (3, K_bg_max)
    fg: GMMParams   # (3, K_fg_max)
    trained: torch.Tensor  # 0-d bool


def _color_prior(h_channel: torch.Tensor, weight: torch.Tensor,
                 winsize: int) -> torch.Tensor:
    """Pixels within +-winsize//2 of the peak of the `weight`-ed hue
    histogram."""
    bins = h_channel.to(torch.int64).clamp(0, 255).reshape(-1)
    hist = torch.zeros(256, dtype=torch.float32, device=h_channel.device)
    hist.index_add_(0, bins, weight.reshape(-1))
    peak = torch.argmax(hist).to(torch.float32)
    return ((h_channel > peak - winsize // 2)
            & (h_channel < peak + winsize // 2))


def _fit(img_hsv: torch.Tensor, sample_mask: torch.Tensor,
         params: GMMParams, active: torch.Tensor, em_iters: int,
         max_fit_samples: int = 65536) -> GMMParams:
    """Fit the 3-channel bank on pixels weighted by `sample_mask`, stride-
    subsampled to at most `max_fit_samples` pixels."""
    x = img_hsv.reshape(-1, 3).T  # (3, N)
    stride = max(x.shape[1] // max_fit_samples, 1)
    x = x[:, ::stride]
    w = sample_mask.reshape(-1)[::stride][None, :].expand(x.shape)
    return gmm_fit_em(x, w.to(torch.float32), params, active, em_iters)


def _alpha_from_gmms(img_hsv: torch.Tensor, bg_params: GMMParams,
                     fg_params: GMMParams):
    """Per-pixel fg probability: the cube root of the product over channels
    of each bank's pdf, fg / (fg + bg). Returns (alpha 0..255, std)."""
    h, w, _ = img_hsv.shape
    x = img_hsv.reshape(-1, 3).T
    bg_prob = torch.prod(gmm_pdf(bg_params, x), dim=0) ** (1.0 / 3.0)
    fg_prob = torch.prod(gmm_pdf(fg_params, x), dim=0) ** (1.0 / 3.0)
    prob = fg_prob / (bg_prob + fg_prob + 1e-6)
    confidence = torch.std(prob, unbiased=False)
    return torch.clamp(prob * 255.0, 0.0, 255.0).reshape(h, w), confidence


def _postprocess(alpha: torch.Tensor, mask: torch.Tensor,
                 thr_ratio: float = 0.8) -> torch.Tensor:
    """Adaptive threshold, then close and open (four K2 calls on a card)."""
    consistent = (alpha > 128) & (mask > 0)
    cnt = consistent.sum().clamp_min(1)
    score_thr = torch.where(consistent, alpha, 0.0).sum() / cnt * thr_ratio
    alpha = torch.where(alpha < score_thr, 0.0, alpha)
    alpha = morph.erode(morph.dilate(alpha, 3, 2), 3, 2)
    return morph.dilate(morph.erode(alpha, 3, 2), 3, 2)


def _select_state(flag: torch.Tensor, a: CFState, b: CFState) -> CFState:
    """a where flag (0-d bool) else b, field by field."""
    def sel(x, y):
        return torch.where(flag, x, y)
    return CFState(GMMParams(*map(sel, a.bg, b.bg)),
                   GMMParams(*map(sel, a.fg, b.fg)),
                   sel(a.trained, b.trained))


class ColorFilteringAgent:
    """Same constructor surface as the JAX agent, plus `device` (the card
    unless the caller passes "cpu"). The fused pipelines carry a `CFState`
    per segment through `device_forward_impl`; `forward` uses and updates
    the agent's own `state`."""

    def __init__(self, input_long_side: int = 960, bg_ncomp=(3, 5, 5),
                 fg_ncomp=(10, 10, 10), max_num_samples: int = 10000,
                 color_prior_winsize: int = 30,
                 use_opencv_gmm: bool = False, em_iters: int = 12,
                 device="cuda"):
        if len(bg_ncomp) != 3 or len(fg_ncomp) != 3:
            raise ValueError("bg_ncomp and fg_ncomp need one entry per "
                             "HSV channel")
        if use_opencv_gmm:
            raise ValueError(
                "use_opencv_gmm=True is not supported: the only GMM fit is "
                "the device weighted EM of ops/gmm.py")
        self.device = resolve_device(device)
        self.input_long_side = int(input_long_side)
        self.bg_ncomp = tuple(int(n) for n in bg_ncomp)
        self.fg_ncomp = tuple(int(n) for n in fg_ncomp)
        self.max_num_samples = int(max_num_samples)
        self.color_prior_winsize = int(color_prior_winsize)
        self.em_iters = int(em_iters)
        self._bg_active = self._active(self.bg_ncomp)
        self._fg_active = self._active(self.fg_ncomp)
        self.state = self.reset_gmms()

    def _active(self, ncomp) -> torch.Tensor:
        n = torch.tensor(ncomp, device=self.device)
        return torch.arange(max(ncomp), device=self.device)[None, :] \
            < n[:, None]

    def reset_gmms(self) -> CFState:
        """Fresh (untrained) GMM banks, also made the agent's `state`."""
        self.state = CFState(
            bg=gmm_init(3, self._bg_active.shape[1], self._bg_active),
            fg=gmm_init(3, self._fg_active.shape[1], self._fg_active),
            trained=torch.tensor(False, device=self.device))
        return self.state

    def is_trained(self) -> bool:
        return bool(self.state.trained)

    def device_forward_impl(self, img: torch.Tensor, mask: torch.Tensor,
                            iters: int, state: CFState
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, CFState]:
        """One color-filtering step at work resolution.

        img (H, W, 3) BGR 0..255, mask (H, W) coarse fg 0..255; `iters`
        fit iterations (0 = predict only). Returns (alpha (H, W), bg_color
        (3,) BGR, confidence, new state)."""
        fg_min = max(self.fg_ncomp) * 5
        bg_min = max(self.bg_ncomp) * 5
        img_hsv = colorops.bgr2hsv(img)

        if iters == 0:
            alpha, conf = _alpha_from_gmms(img_hsv, state.bg, state.fg)
            alpha = _postprocess(alpha, mask)
            out_state = state
        else:
            cur, mask_c = state, mask
            alpha = torch.zeros_like(mask)
            conf = torch.tensor(1.0, device=img.device)
            live = torch.tensor(True, device=img.device)
            for _ in range(iters):
                bg_coarse = (mask_c < 128).to(torch.float32)
                fg_coarse = (mask_c > 128).to(torch.float32)
                bg_prior = _color_prior(img_hsv[..., 0], bg_coarse,
                                        self.color_prior_winsize)
                fg_prior = _color_prior(img_hsv[..., 0], bg_coarse,
                                        self.color_prior_winsize // 5)
                bg_w = bg_coarse * bg_prior
                # exclude prior-colored pixels from the fg samples when
                # enough remain
                fg_w_strict = fg_coarse * (1.0 - fg_prior.to(torch.float32))
                fg_w = torch.where(fg_w_strict.sum() > fg_min, fg_w_strict,
                                   fg_coarse)
                new = CFState(
                    _fit(img_hsv, bg_w, cur.bg, self._bg_active,
                         self.em_iters),
                    _fit(img_hsv, fg_w, cur.fg, self._fg_active,
                         self.em_iters),
                    torch.tensor(True, device=img.device))
                new_alpha, new_conf = _alpha_from_gmms(img_hsv, new.bg,
                                                       new.fg)
                new_alpha = _postprocess(new_alpha, mask_c)
                new_mask = (new_alpha > 128).to(torch.float32) * 255.0
                # freeze once fg or bg runs dry
                still_live = (((new_mask > 128).sum() >= fg_min)
                              & ((new_mask < 128).sum() >= bg_min))
                cur = _select_state(live, new, cur)
                mask_c = torch.where(live, new_mask, mask_c)
                alpha = torch.where(live, new_alpha, alpha)
                conf = torch.where(live, new_conf, conf)
                live = live & still_live
            out_state = cur

        # pure-color background from the dominant bg component per channel
        kidx = torch.argmax(out_state.bg.weights, dim=1)
        bg_hsv = out_state.bg.means.gather(1, kidx[:, None])[:, 0]
        bg_color = colorops.hsv2bgr(bg_hsv[None, None, :])[0, 0]

        # degenerate input: no fg -> the mask passes through, no filtering;
        # no bg -> the mask with a black background color
        fg_cnt = (mask > 128).sum()
        bg_cnt = (mask < 128).sum()
        degenerate = (fg_cnt < fg_min) | (bg_cnt < bg_min)
        alpha = torch.where(degenerate, mask, alpha)
        conf = torch.where(degenerate, 1.0, conf)
        bg_color = torch.where(fg_cnt < fg_min, 0.0, bg_color)
        out_state = _select_state(degenerate, state, out_state)
        return alpha, bg_color, conf, out_state

    @torch.inference_mode()
    def forward(self, img, mask, iters: int = 1):
        """The modular driver's step on a full-resolution BGR frame and
        coarse mask (numpy or tensors, 0..255): at `input_long_side`, with
        the agent's `state`. Returns (alpha uint8 (H, W), background image
        uint8 (H, W, 3) of the screen color, confidence) on the agent's
        device; too few fg or bg pixels in the mask return it unfiltered
        (with the frame, or a black background) and leave the state."""
        img = as_float(img, self.device)
        mask = as_float(mask, self.device)
        if int((mask > 128).sum()) < max(self.fg_ncomp) * 5:
            return mask.to(torch.uint8), img.to(torch.uint8), 1.0
        if int((mask < 128).sum()) < max(self.bg_ncomp) * 5:
            return (mask.to(torch.uint8),
                    torch.zeros(img.shape, dtype=torch.uint8,
                                device=self.device), 1.0)
        ori_h, ori_w = img.shape[:2]
        work_hw = get_target_size(ori_h, ori_w, self.input_long_side)
        alpha, bg_color, conf, self.state = self.device_forward_impl(
            resize(img, work_hw), resize(mask, work_hw), int(iters),
            self.state)
        alpha = resize(alpha, (ori_h, ori_w)).clamp(0.0, 255.0)
        bg_img = bg_color.clamp(0.0, 255.0).expand(ori_h, ori_w, 3)
        return alpha.to(torch.uint8), bg_img.to(torch.uint8), conf
