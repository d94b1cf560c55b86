"""Device timing and bounds of the port's kernels and nets on one NVIDIA
card, shared by `chip_smoke.py` and the timing tools (`tools/*_torch*.py`).

`cuda_ms` times a call with CUDA events; `bound` is the least time the
card could take for a call (the larger of its bytes over the memory rate
and its operations over the peak rate of their type, H100 SXM data-sheet
rates at 700 W); `attn_bounds` applies it to the STM read's kernels K4-K6,
`net_flops` counts a net's operations on the meta device, and `sdpa_fwd_ms`
/ `sdpa_bwd_ms` time PyTorch's own attention on the same read. The module
imports torch only inside its functions.
"""

from __future__ import annotations

import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3  # H100 SXM TF32 tensor cores, 3 passes
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 tensor cores, dense
# the modular bg path's STM memory read: 544x960 / 16 query pixels against
# a bank of 10 slots plus the previous frame (K4's shape there)
ATTN_LQ, ATTN_SLOTS, ATTN_DK, ATTN_DV = 34 * 60, 11, 128, 512


def cuda_ms(fn, reps, rounds=7):
    """Median over `rounds` of the device time per call of `fn`, from CUDA
    events around `reps` calls. A sleep kernel holds the stream while the
    host queues the calls, so the card runs them back to back and the
    host's launch cost (tens of us per call from Python) stays out of the
    time of a kernel that takes less."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    # cycles for 1.5x the host's queueing time at up to 2 GHz
    cycles = int((1.5 * reps * host_ms + 1.0) * 2e6)
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bounds(kind, n_b, n_q, n_k, n_valid, dk, dv):
    """bound() of K4 ("fwd"), K5 ("dq") or K6 ("dkv") on n_b items of
    n_q queries over n_k keys of which n_valid are valid, at the f32 rate
    and at the 3xTF32 tensor-core rate (and, for K6 only as a diagnostic,
    at its own split between the two, "fma_tc"): q, the valid keys' k and
    v and the mask read once (and for the backward dO, lse and delta), the
    outputs written once. The card's bound is the 3xTF32 one: it does
    f32-accurate products at that rate."""
    per_pair = {"fwd": dk + dv, "dq": 2 * dk + dv, "dkv": 2 * dk + 2 * dv}
    flops = 2 * n_b * n_q * n_valid * per_pair[kind]
    if kind == "fwd":
        n_io = n_q * dk + n_valid * (dk + dv) + n_k + n_q * (dv + 1)
    else:
        n_io = (n_q * (dk + dv + 2) + n_valid * (dk + dv) + n_k
                + (n_q * dk if kind == "dq" else n_k * (dk + dv)))
    out = {"f32": bound(4 * n_b * n_io, flops),
           "3xtf32": bound(4 * n_b * n_io, flops, TF32X3_OPS_PER_S)}
    if kind == "dkv":
        # K6 as built: S and dV (dk + dv multiply-adds a pair) on the FMA
        # units, dP and dK (the other dk + dv) on the tensor cores at
        # 3xTF32; the pipes run at once, so the slower half bounds this
        # design (a looser bound than the card's, kept beside it)
        out["fma_tc"] = bound(4 * n_b * n_io, flops / 2)
    return out


def as_bh(t):
    """(B, L, d) or (L, d) -> (B, 1, L, d), SDPA's batch and head axes."""
    return t.reshape(-1, 1, *t.shape[-2:])


def sdpa_fwd_ms(q, k, v, mask, reps):
    """SDPA on the same read with the boolean mask: the library time."""
    import torch.nn.functional as F
    q4, k4, v4 = as_bh(q), as_bh(k), as_bh(v)
    m4 = (mask > 0).reshape(-1, 1, 1, mask.shape[-1])
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4), reps)


def sdpa_bwd_ms(q, k, v, mask, dout, reps):
    """SDPA's backward (dQ, dK and dV) on the same read."""
    import torch
    import torch.nn.functional as F
    q4, k4, v4 = (as_bh(t).clone().requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=(mask > 0).reshape(-1, 1, 1, mask.shape[-1]))
    g4 = as_bh(dout)
    return cuda_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), g4, retain_graph=True), reps)


def net_flops(build, *shapes):
    """Operations of one forward of `build()` on zero inputs of `shapes`,
    counted by `torch.utils.flop_counter` on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        net = build().eval()
        with FlopCounterMode(display=False) as counter:
            net(*[torch.zeros(*s) for s in shapes])
    return counter.get_total_flops()
