"""Banks of 1-D Gaussian mixtures: weighted EM and the mixture pdf.

Port of `video_unscreen_tpu/ops/gmm.py` (`gmm_init`, `gmm_fit_em`,
`gmm_pdf`). A bank holds M models of K components; models with fewer live
components carry zero-weight padding (`active`). The JAX package vmaps one
model's EM over the bank; here the bank is a leading axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_VAR_FLOOR = 1e-3
_EPS = 1e-10


class GMMParams(NamedTuple):
    """One bank of 1-D GMMs, each field (M, K)."""
    weights: torch.Tensor  # zero for padding components
    means: torch.Tensor
    variances: torch.Tensor


def gmm_init(n_models: int, k_max: int, active: torch.Tensor) -> GMMParams:
    """Uniform weights over the live components, means spread over
    0..255, variance 100."""
    act = active.to(torch.float32)
    w = act / act.sum(-1, keepdim=True).clamp_min(1.0)
    means = torch.linspace(0.0, 255.0, k_max,
                           device=active.device).expand(n_models, k_max)
    var = torch.full((n_models, k_max), 100.0, device=active.device)
    return GMMParams(w, means.contiguous(), var)


def gmm_fit_em(x: torch.Tensor, sample_w: torch.Tensor, params: GMMParams,
               active: torch.Tensor, iters: int = 20) -> GMMParams:
    """Weighted EM, warm-started from `params`.

    x, sample_w: (M, N) samples and their weights (0 = padding); active:
    (M, K) bool mask of live components."""
    keep = active
    w, m, v = params
    xs = x[:, :, None]
    for _ in range(iters):
        d = xs - m[:, None, :]
        logp = (-0.5 * d * d / v[:, None, :]
                - 0.5 * torch.log(2.0 * math.pi * v[:, None, :]))
        logp = logp + torch.log(w.clamp_min(_EPS))[:, None, :]
        logp = torch.where(keep[:, None, :], logp, float("-inf"))
        resp = torch.softmax(logp, dim=-1) * sample_w[:, :, None]
        nk = resp.sum(1)
        m_new = (resp * xs).sum(1) / nk.clamp_min(_EPS)
        d = xs - m_new[:, None, :]
        v_new = (resp * d * d).sum(1) / nk.clamp_min(_EPS) + _VAR_FLOOR
        w_new = nk / nk.sum(-1, keepdim=True).clamp_min(_EPS)
        w = torch.where(keep, w_new, 0.0)
        m = torch.where(keep, m_new, m)
        v = torch.where(keep, v_new, 100.0)
    return GMMParams(w, m, v)


def gmm_pdf(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """(M, P) mixture pdf of every model at its points x (M, P)."""
    w, m, v = params
    d = x[:, :, None] - m[:, None, :]
    comp = torch.exp(-0.5 * d * d / v[:, None, :]) / torch.sqrt(
        2.0 * math.pi * v[:, None, :])
    return (comp * w[:, None, :]).sum(-1)
