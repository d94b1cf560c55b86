"""K4 (masked memory attention, the STM memory read): wrapper and plain
version.

Replaces the Pallas TPU kernel `video_unscreen_tpu/ops/pallas/attention.py:
_attn_kernel` (entry `masked_memory_attention`, forward); the CUDA source
is `csrc/attention.cu`. Both versions return, for q (Lq, dk), k (Lk, dk),
v (Lk, dv) and kv_mask (Lk,) (a key is valid where the mask is > 0):

- `out` (Lq, dv): softmax(q k^T / sqrt(dk)) v over the valid keys, 0 for a
  query with no valid key;
- `lse` (Lq,): the log-sum-exp of the valid scores, 0 for such a query.

Masked scores are -1e30, not -inf, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build
from .morph import LaunchCount

ATTENTION = LaunchCount("attention")

_NEG = -1e30


def _scale(dk: int) -> float:
    """1 / sqrt(dk) rounded as the f32 computation rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dk)))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (Lq, Lk) score matrix, the masked softmax and the same
    zero-valid rule."""
    s = (q @ k.T) * _scale(q.shape[1])
    s = torch.where(kv_mask[None, :] > 0, s, _NEG)
    m = s.max(dim=1, keepdim=True).values
    p = torch.exp(s - m)
    l_fin = p.sum(dim=1, keepdim=True).clamp_min(1e-30)
    any_valid = m > _NEG * 0.5
    out = torch.where(any_valid, (p @ v) / l_fin, 0.0)
    lse = torch.where(any_valid, m + torch.log(l_fin), 0.0)
    return out, lse[:, 0]


def _check(t: torch.Tensor, name: str, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"attention: {name} must be a CPU or CUDA tensor "
                         f"like q, got {t.device}")
    if (t.dtype != torch.float32 or t.dim() != dim
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"attention: {name} must be a contiguous, 16-byte aligned "
            f"{dim}-D float32 tensor, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}")


def masked_memory_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out (Lq, dv), lse (Lq,)) of the masked attention."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    for t, name, dim in ((q, "q", 2), (k, "k", 2), (v, "v", 2),
                         (kv_mask, "kv_mask", 1)):
        _check(t, name, dim)
    (lq, dk), (lk, dv) = q.shape, v.shape
    if k.shape != (lk, dk) or kv_mask.shape != (lk,):
        raise ValueError(f"attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} mask "
                         f"{tuple(kv_mask.shape)} do not agree")
    if dk > 128 or dk % 4 or dv % 4 or lq == 0 or lk == 0:
        raise ValueError(f"attention: needs dk <= 128, dk and dv multiples "
                         f"of 4 and non-empty q and k, got Lq {lq} Lk {lk} "
                         f"dk {dk} dv {dv}")
    lib = build.library()
    out = torch.empty((lq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty(lq, dtype=torch.float32, device=q.device)
    launches = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vut_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                kv_mask.data_ptr(), out.data_ptr(),
                                lse.data_ptr(), lq, lk, dk, dv, stream,
                                ctypes.addressof(launches))
    build.check(err, "attention kernel")
    ATTENTION.add(launches)
    return out, lse
