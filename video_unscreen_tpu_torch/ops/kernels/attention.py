"""K4 (masked memory attention, the STM memory read), K5 and K6 (its
backward): wrappers, plain versions and the autograd function.

Replace the Pallas TPU kernels of `video_unscreen_tpu/ops/pallas/
attention.py`: `_attn_kernel` (K4, forward), `_bwd_dq_kernel` (K5) and
`_bwd_dkv_kernel` (K6); the CUDA source of all three is
`csrc/attention.cu`. The read is batched as the JAX package vmaps it: for
q (B, Lq, dk), k (B, Lk, dk), v (B, Lk, dv) and kv_mask (B, Lk) (a key is
valid where the mask is > 0) the forward returns:

- `out` (B, Lq, dv): softmax(q k^T / sqrt(dk)) v over the valid keys, 0
  for a query with no valid key;
- `lse` (B, Lq): the log-sum-exp of the valid scores, 0 for such a query.

A 2-D input (no batch axis) is read as B = 1 and gets 2-D results. Masked
scores are -1e30, not -inf, as in the TPU kernel. The backward
(`_mma_bwd` of the JAX package) recomputes P = exp(s - lse) from the saved
LSE, so a masked key (s = -1e30) and a query with no valid key (lse 0,
every s -1e30) get P = 0 and pass no gradient.

On the card K4 and K5 walk a list of the 64-key tiles that hold a valid
key (`_live_key_tiles`, one small launch, counted as the call's). K5
splits its key range across blocks (`dq_splits`) and, with more than one
split, sums the splits in a second launch. K6 runs one block per 32 keys,
and up to 4 blocks share a key block's dV columns where the blocks would
leave SMs idle (`dkv_grid`). So one K4 call is 2 launches,
one K5 call 2 or 3 and one K6 call 1; in `MaskedMemoryAttention` K5
reuses K4's list (1 or 2). K6 takes dv <= 512 (the STM's value width)
and raises on a wider V; so does `MaskedMemoryAttention` on the card when
q, k or v needs a gradient, at the forward call.

`MaskedMemoryAttention` is the differentiable read: K4 forward (it keeps
the list for K5), then delta = rowsum(dO * O) (a plain reduction, as in
the JAX package), K5 and K6, one call each for the whole batch. Every
wrapper runs its plain version for a CPU tensor and launches its kernel
for a CUDA tensor or raises; the shapes the kernels refuse (dk > 128, dk
or dv not a multiple of 4, an empty q or k) are refused on the card,
never sent to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .morph import LaunchCount

ATTENTION = LaunchCount("attention")
ATTENTION_BWD_DQ = LaunchCount("attention_bwd_dq")
ATTENTION_BWD_DKV = LaunchCount("attention_bwd_dkv")

_NEG = -1e30
TILE = 64   # keys per tile and queries per block in csrc/attention.cu

Tiles = Tuple[torch.Tensor, torch.Tensor]


def _scale(dk: int) -> float:
    """1 / sqrt(dk) rounded as the f32 computation rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dk)))


def _masked_scores(q: torch.Tensor, k: torch.Tensor,
                   kv_mask: torch.Tensor) -> torch.Tensor:
    """(..., Lq, Lk) scores q k^T * scale, -1e30 at the masked keys."""
    s = (q @ k.transpose(-1, -2)) * _scale(q.shape[-1])
    return torch.where(kv_mask[..., None, :] > 0, s, _NEG)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (..., Lq, Lk) score matrix, the masked softmax and the
    same zero-valid rule."""
    s = _masked_scores(q, k, kv_mask)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l_fin = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    any_valid = m > _NEG * 0.5
    out = torch.where(any_valid, (p @ v) / l_fin, 0.0)
    lse = torch.where(any_valid, m + torch.log(l_fin), 0.0)
    return out, lse[..., 0]


def _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta):
    """P = exp(s - lse) and dS = P * (dO V^T - delta), both (..., Lq,
    Lk)."""
    p = torch.exp(_masked_scores(q, k, kv_mask) - lse[..., None])
    ds = p * (dout @ v.transpose(-1, -2) - delta[..., None])
    return p, ds


def attention_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta
                           ) -> torch.Tensor:
    """K5's function: dQ = dS K * scale (..., Lq, dk)."""
    _, ds = _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta)
    return (ds @ k) * _scale(q.shape[-1])


def attention_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's function: dK = dS^T Q * scale (..., Lk, dk) and dV = P^T dO
    (..., Lk, dv)."""
    p, ds = _bwd_p_ds(q, k, v, kv_mask, dout, lse, delta)
    return ((ds.transpose(-1, -2) @ q) * _scale(q.shape[-1]),
            p.transpose(-1, -2) @ dout)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the masked attention for the output cotangent
    `dout`, by the explicit formula of the JAX package's `_mma_bwd` (not
    autograd): delta = rowsum(dO * O), P = exp(s - lse), dP = dO V^T,
    dS = P * (dP - delta), dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO.
    """
    delta = (dout * out).sum(dim=-1)
    args = (q, k, v, kv_mask, dout, lse, delta)
    return (attention_bwd_dq_plain(*args), *attention_bwd_dkv_plain(*args))


def dq_splits(batch: int, lq: int, lk: int, n_sm: int) -> int:
    """K5's key splits: as many as keep the (64-query tile, split, item)
    blocks within two waves of the card's `n_sm` SMs (K5 runs one block
    per SM), so that no third wave runs a sliver of blocks; at least one,
    at most one split per 64-key tile."""
    blocks = batch * -(-lq // TILE)
    return max(1, min(-(-lk // TILE), 2 * n_sm // blocks))


KEY_BLOCK = 32    # keys per K6 block in csrc/attention.cu
DV_CHUNK = 128    # dv columns per chunk of K6's dO ring
DV_MAX_DKV = 512  # the widest dv K6 takes


def dkv_grid(batch: int, lk: int, dv: int, n_sm: int
             ) -> Tuple[int, int, int]:
    """K6's grid, (tail0, g_head, g_tail): key blocks [0, tail0) of 32
    keys are shared by g_head blocks each and the rest by g_tail (a block
    takes a share of the key block's 128-column dV chunks; at most one
    block per chunk). K6 runs one block per SM of the card's `n_sm`:
    - where the (key block, item) blocks fill at most half a wave, every
      key block gets the most groups, a power of two, that stay within
      one wave;
    - a single read (batch 1) over more than a wave gives the key blocks
      of its last, partial wave as many groups as fill that wave;
    - otherwise one block per key block."""
    n_kb, chunks = -(-lk // KEY_BLOCK), -(-dv // DV_CHUNK)
    blocks = batch * n_kb
    if 2 * blocks <= n_sm:
        groups = 1
        while 2 * groups <= chunks and 2 * groups * blocks <= n_sm:
            groups *= 2
        return n_kb, groups, groups
    tail = blocks % n_sm
    if batch == 1 and blocks > n_sm and tail:
        return n_kb - tail, 1, max(1, min(chunks, n_sm // tail))
    return n_kb, 1, 1


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
                  ) -> Tuple[int, int, int, int, int]:
    """(B, Lq, Lk, dk, dv) of batched CUDA inputs the kernels take, else
    raise. `per_query` are the backward's dout (B, Lq, dv), lse and delta
    (B, Lq)."""
    for t, name, dim in ((q, "q", 3), (k, "k", 3), (v, "v", 3),
                         (kv_mask, "kv_mask", 2)):
        _check(t, name, dim)
    (b, lq, dk), (_, lk, dv) = q.shape, v.shape
    if (k.shape != (b, lk, dk) or v.shape[0] != b
            or kv_mask.shape != (b, lk)):
        raise ValueError(f"attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} mask "
                         f"{tuple(kv_mask.shape)} do not agree")
    for name, t in per_query.items():
        want = (b, lq, dv) if name == "dout" else (b, lq)
        _check(t, name, len(want))
        if t.shape != want:
            raise ValueError(f"attention: {name} {tuple(t.shape)}, want "
                             f"{want}")
    if (dk > 128 or dk % 4 or dv % 4 or lq == 0 or lk == 0 or b == 0
            or b > 65535):
        raise ValueError(f"attention: needs dk <= 128, dk and dv multiples "
                         f"of 4, non-empty q and k and 1 <= B <= 65535, got "
                         f"B {b} Lq {lq} Lk {lk} dk {dk} dv {dv}")
    return b, lq, lk, dk, dv


def _batched(*ts: torch.Tensor) -> Tuple[bool, list]:
    """(whether q had no batch axis, the tensors with a leading axis of 1
    added where q had none)."""
    flat = ts[0].dim() == 2
    return flat, [t.unsqueeze(0) if flat else t for t in ts]


def _launch(entry: str, what: str, *args) -> int:
    """Call a C entry on the current stream of the first tensor's card;
    returns the device launches it made."""
    lib = build.library()
    launches = ctypes.c_int(0)
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream, ctypes.addressof(launches))
    build.check(err, what)
    return launches.value


def _count(counter: LaunchCount, launches: int) -> None:
    counter.calls += 1
    counter.launches += launches


def _live_key_tiles(kv_mask: torch.Tensor) -> Tuple[Tiles, int]:
    """((tiles (B, ceil(Lk / 64)) int32, n_live (B,) int32), launches) of a
    batched CUDA mask: per item, the indices of the 64-key tiles holding a
    key > 0 in increasing order, and their count; made on the card with
    no host sync."""
    b, lk = kv_mask.shape
    tiles = torch.empty((b, -(-lk // TILE)), dtype=torch.int32,
                        device=kv_mask.device)
    n_live = torch.empty(b, dtype=torch.int32, device=kv_mask.device)
    n = _launch("vut_attention_tiles", "attention live-tile kernel", kv_mask,
                tiles, n_live, b, lk)
    return (tiles, n_live), n


def _forward(q, k, v, kv_mask):
    """K4 on batched CUDA inputs: (out, lse, the live-tile list)."""
    b, lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask)
    tiles, n = _live_key_tiles(kv_mask)
    out = torch.empty((b, lq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    n += _launch("vut_attention", "attention kernel", q, k, v, kv_mask,
                 *tiles, out, lse, b, lq, lk, dk, dv)
    _count(ATTENTION, n)
    return out, lse, tiles


def masked_memory_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out (B, Lq, dv), lse (B, Lq)) of the masked attention."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    flat, (q, k, v, kv_mask) = _batched(q, k, v, kv_mask)
    out, lse, _ = _forward(q, k, v, kv_mask)
    return (out[0], lse[0]) if flat else (out, lse)


def _bwd_dq(q, k, v, kv_mask, dout, lse, delta,
            tiles: Optional[Tiles] = None) -> torch.Tensor:
    """K5 on batched CUDA inputs, walking `tiles` (K4's list) if given."""
    b, lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask, dout=dout, lse=lse,
                                      delta=delta)
    n = 0
    if tiles is None:
        tiles, n = _live_key_tiles(kv_mask)
    splits = dq_splits(b, lq, lk, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    dq = torch.empty((b, lq, dk), dtype=torch.float32, device=q.device)
    work = (torch.empty((splits, b, lq, dk), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    n += _launch("vut_attention_bwd_dq", "attention dQ kernel", q, k, v,
                 kv_mask, dout, lse, delta, *tiles, dq, work, b, lq, lk, dk,
                 dv, splits)
    _count(ATTENTION_BWD_DQ, n)
    return dq


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: torch.Tensor, dout: torch.Tensor,
                     lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """K5: dq (B, Lq, dk) from the forward's lse and delta = rowsum(dO *
    O); deterministic (no atomics)."""
    if q.device.type == "cpu":
        return attention_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta)
    flat, args = _batched(q, k, v, kv_mask, dout, lse, delta)
    dq = _bwd_dq(*args)
    return dq[0] if flat else dq


def _bwd_dkv(q, k, v, kv_mask, dout, lse, delta):
    """K6 on batched CUDA inputs."""
    b, lq, lk, dk, dv = _check_inputs(q, k, v, kv_mask, dout=dout, lse=lse,
                                      delta=delta)
    if dv > DV_MAX_DKV:
        raise ValueError(f"attention dK/dV: needs dv <= {DV_MAX_DKV}, got "
                         f"{dv}")
    grid = dkv_grid(b, lk, dv, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    dk_out = torch.empty((b, lk, dk), dtype=torch.float32, device=q.device)
    dv_out = torch.empty((b, lk, dv), dtype=torch.float32, device=q.device)
    _count(ATTENTION_BWD_DKV, _launch(
        "vut_attention_bwd_dkv", "attention dK/dV kernel", q, k, v, kv_mask,
        dout, lse, delta, dk_out, dv_out, b, lq, lk, dk, dv, *grid))
    return dk_out, dv_out


def attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (dk (B, Lk, dk), dv (B, Lk, dv)); a masked key gets exactly
    0."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta)
    flat, args = _batched(q, k, v, kv_mask, dout, lse, delta)
    dk_out, dv_out = _bwd_dkv(*args)
    return (dk_out[0], dv_out[0]) if flat else (dk_out, dv_out)


class MaskedMemoryAttention(torch.autograd.Function):
    """out = masked attention of (q, k, v, kv_mask), differentiable in q,
    k and v (the mask gets no gradient): K4 forward, K5 and K6 backward,
    one call each for the whole batch (their plain versions for CPU
    tensors). Takes the batched or the 2-D shapes of the wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.flat = False
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, kv_mask)
            ctx.save_for_backward(q, k, v, kv_mask, out, lse, None, None)
            return out
        if v.shape[-1] > DV_MAX_DKV and any(ctx.needs_input_grad[:3]):
            # refused at the call, not at the first backward pass
            raise ValueError(f"attention: a differentiable read on the card "
                             f"needs dv <= {DV_MAX_DKV} (K6), got "
                             f"{v.shape[-1]}")
        ctx.flat, (q, k, v, kv_mask) = _batched(q, k, v, kv_mask)
        out, lse, tiles = _forward(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse, *tiles)
        return out[0] if ctx.flat else out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse, tiles, n_live = ctx.saved_tensors
        dout = dout.contiguous().reshape(out.shape)
        delta = (dout * out).sum(dim=-1)
        args = (q, k, v, kv_mask, dout, lse, delta)
        if q.device.type == "cpu":
            return (attention_bwd_dq_plain(*args),
                    *attention_bwd_dkv_plain(*args), None)
        grads = (_bwd_dq(*args, tiles=(tiles, n_live)), *_bwd_dkv(*args))
        return (*(g[0] if ctx.flat else g for g in grads), None)
