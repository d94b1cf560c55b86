"""K4 (masked memory attention, the STM memory read), K5 and K6 (its
backward): wrappers, plain versions and the autograd function.

Replace the Pallas TPU kernels of `video_unscreen_tpu/ops/pallas/
attention.py`: `_attn_kernel` (K4, forward), `_bwd_dq_kernel` (K5) and
`_bwd_dkv_kernel` (K6); the CUDA source of all three is
`csrc/attention.cu`. For q (Lq, dk), k (Lk, dk), v (Lk, dv)
and kv_mask (Lk,) (a key is valid where the mask is > 0) the forward
returns:

- `out` (Lq, dv): softmax(q k^T / sqrt(dk)) v over the valid keys, 0 for a
  query with no valid key;
- `lse` (Lq,): the log-sum-exp of the valid scores, 0 for such a query.

Masked scores are -1e30, not -inf, as in the TPU kernel. The backward
(`_mma_bwd` of the JAX package) recomputes P = exp(s - lse) from the saved
LSE, so a masked key (s = -1e30) and a query with no valid key (lse 0,
every s -1e30) get P = 0 and pass no gradient.

`MaskedMemoryAttention` is the differentiable read: K4 forward, then
delta = rowsum(dO * O) (a plain reduction, as in the JAX package), K5 and
K6. Every wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor or raises; the shapes the kernels refuse (dk >
128, dk or dv not a multiple of 4, an empty q or k) are refused on the
card, never sent to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build
from .morph import LaunchCount

ATTENTION = LaunchCount("attention")
ATTENTION_BWD_DQ = LaunchCount("attention_bwd_dq")
ATTENTION_BWD_DKV = LaunchCount("attention_bwd_dkv")

_NEG = -1e30


def _scale(dk: int) -> float:
    """1 / sqrt(dk) rounded as the f32 computation rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dk)))


def _masked_scores(q: torch.Tensor, k: torch.Tensor,
                   kv_mask: torch.Tensor) -> torch.Tensor:
    """(Lq, Lk) scores q k^T * scale, -1e30 at the masked keys."""
    s = (q @ k.T) * _scale(q.shape[1])
    return torch.where(kv_mask[None, :] > 0, s, _NEG)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (Lq, Lk) score matrix, the masked softmax and the same
    zero-valid rule."""
    s = _masked_scores(q, k, kv_mask)
    m = s.max(dim=1, keepdim=True).values
    p = torch.exp(s - m)
    l_fin = p.sum(dim=1, keepdim=True).clamp_min(1e-30)
    any_valid = m > _NEG * 0.5
    out = torch.where(any_valid, (p @ v) / l_fin, 0.0)
    lse = torch.where(any_valid, m + torch.log(l_fin), 0.0)
    return out, lse[:, 0]


def _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta):
    """P = exp(s - lse) and dS = P * (dO V^T - delta), both (Lq, Lk)."""
    p = torch.exp(_masked_scores(q, k, kv_mask) - lse[:, None])
    ds = p * (dout @ v.T - delta[:, None])
    return p, ds


def attention_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta
                           ) -> torch.Tensor:
    """K5's function: dQ = dS K * scale (Lq, dk)."""
    _, ds = _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta)
    return (ds @ k) * _scale(q.shape[1])


def attention_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's function: dK = dS^T Q * scale (Lk, dk) and dV = P^T dO
    (Lk, dv)."""
    p, ds = _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta)
    return (ds.T @ q) * _scale(q.shape[1]), p.T @ dout


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the masked attention for the output cotangent
    `dout`, by the explicit formula of the JAX package's `_mma_bwd` (not
    autograd): delta = rowsum(dO * O), P = exp(s - lse), dP = dO V^T,
    dS = P * (dP - delta), dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO.
    """
    delta = (dout * out).sum(dim=1)
    args = (q, k, v, kv_mask, dout, lse, delta)
    return (attention_bwd_dq_plain(*args), *attention_bwd_dkv_plain(*args))


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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor, **per_query: torch.Tensor
                  ) -> Tuple[int, int, int, int]:
    """(Lq, Lk, dk, dv) of CUDA inputs the kernels take, else raise.
    `per_query` are the backward's dout (Lq, dv), lse and delta (Lq,)."""
    for t, name, dim in ((q, "q", 2), (k, "k", 2), (v, "v", 2),
                         (kv_mask, "kv_mask", 1)):
        _check(t, name, dim)
    (lq, dk), (lk, dv) = q.shape, v.shape
    if k.shape != (lk, dk) or kv_mask.shape != (lk,):
        raise ValueError(f"attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} mask "
                         f"{tuple(kv_mask.shape)} do not agree")
    for name, t in per_query.items():
        want = (lq, dv) if name == "dout" else (lq,)
        _check(t, name, len(want))
        if t.shape != want:
            raise ValueError(f"attention: {name} {tuple(t.shape)}, want "
                             f"{want}")
    if dk > 128 or dk % 4 or dv % 4 or lq == 0 or lk == 0:
        raise ValueError(f"attention: needs dk <= 128, dk and dv multiples "
                         f"of 4 and non-empty q and k, got Lq {lq} Lk {lk} "
                         f"dk {dk} dv {dv}")
    return lq, lk, dk, dv


def _launch(entry: str, counter: LaunchCount, what: str, *args) -> None:
    """Call a C entry on the current stream of the first tensor's card."""
    lib = build.library()
    launches = ctypes.c_int(0)
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream, ctypes.addressof(launches))
    build.check(err, what)
    counter.add(launches)


def masked_memory_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out (Lq, dv), lse (Lq,)) of the masked attention."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask)
    out = torch.empty((lq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty(lq, dtype=torch.float32, device=q.device)
    _launch("vut_attention", ATTENTION, "attention kernel", q, k, v, kv_mask,
            out, lse, lq, lk, dk, dv)
    return out, lse


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: torch.Tensor, dout: torch.Tensor,
                     lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """K5: dq (Lq, dk) from the forward's lse and delta = rowsum(dO * O)."""
    if q.device.type == "cpu":
        return attention_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta)
    lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask, dout=dout, lse=lse,
                                   delta=delta)
    dq = torch.empty((lq, dk), dtype=torch.float32, device=q.device)
    _launch("vut_attention_bwd_dq", ATTENTION_BWD_DQ, "attention dQ kernel",
            q, k, v, kv_mask, dout, lse, delta, dq, lq, lk, dk, dv)
    return dq


def attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (dk (Lk, dk), dv (Lk, dv)); a masked key gets exactly 0."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta)
    lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask, dout=dout, lse=lse,
                                   delta=delta)
    dk_out = torch.empty((lk, dk), dtype=torch.float32, device=q.device)
    dv_out = torch.empty((lk, dv), dtype=torch.float32, device=q.device)
    _launch("vut_attention_bwd_dkv", ATTENTION_BWD_DKV,
            "attention dK/dV kernel", q, k, v, kv_mask, dout, lse, delta,
            dk_out, dv_out, lq, lk, dk, dv)
    return dk_out, dv_out


class MaskedMemoryAttention(torch.autograd.Function):
    """out = masked attention of (q, k, v, kv_mask), differentiable in q,
    k and v (the mask gets no gradient): K4 forward, K5 and K6 backward
    (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = masked_memory_attention(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout * out).sum(dim=1)
        dq = attention_bwd_dq(q, k, v, kv_mask, dout, lse, delta)
        dk, dv = attention_bwd_dkv(q, k, v, kv_mask, dout, lse, delta)
        return dq, dk, dv, None
