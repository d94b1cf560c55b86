#!/usr/bin/env python3
"""The STM read's backward kernels K5 (dQ) and K6 (dK, dV) at the shapes
of their paths, on one NVIDIA card.

    python tools/time_torch_attention_bwd.py

Times each kernel's call (CUDA events, `utils/timing.py:cuda_ms`) beside
SDPA's backward on the same read (dQ, dK and dV from one
`torch.autograd.grad`, boolean mask) and the kernels' 3xTF32 and f32
bounds (`utils/timing.py:attn_bounds`, over the valid keys; for K6 also the
bound of its split between FMA units and tensor cores), at: bg's read
(Lq 2040, Lk 22440, dk 128, dv 512) with the STM mask, every key valid
and no valid key; the default training batch (8 x Lq 64, Lk 128, every
key valid); and the `--sizes 256` training read (8 x Lq 256, Lk 512).
Prints one JSON line with the card's name. Needs CUDA.
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.timing import (  # noqa: E402
    ATTN_DK, ATTN_DV, ATTN_LQ, ATTN_SLOTS, attn_bounds, cuda_ms, sdpa_bwd_ms)
from video_unscreen_tpu_torch.ops.kernels import attention as ka  # noqa


def cases():
    """(name, B, Lq, Lk, mask kind) of the timed reads."""
    lq, lk = ATTN_LQ, ATTN_SLOTS * ATTN_LQ
    return [("bg_stm", 1, lq, lk, "stm"), ("bg_all", 1, lq, lk, "all"),
            ("bg_none", 1, lq, lk, "none"), ("train", 8, 64, 128, "all"),
            ("sizes256", 8, 256, 512, "all")]


def main():
    if not torch.cuda.is_available():
        print("time_torch_attention_bwd: CUDA is not available",
              file=sys.stderr)
        return 2
    dk, dv = ATTN_DK, ATTN_DV
    res = {"device": torch.cuda.get_device_name(0)}
    for name, b, lq, lk, kind in cases():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dout = (torch.randn(*s, generator=gen, device="cuda")
                         for s in ((b, lq, dk), (b, lk, dk), (b, lk, dv),
                                   (b, lq, dv)))
        mask = torch.zeros(b, lk, device="cuda")
        if kind == "all":
            mask[:] = 1.0
        elif kind == "stm":
            mask[:, -lq:] = 1.0
        out, lse = ka.attention_plain(q, k, v, mask)
        args = (q, k, v, mask, dout, lse, (dout * out).sum(dim=-1))
        big = lk > 10000 and kind == "all"
        reps = 5 if big else 50
        n_valid = int(mask[0].sum())
        row = {"B": b, "Lq": lq, "Lk": lk, "valid_keys": n_valid}
        for key, fn, kk in (("dq", ka.attention_bwd_dq, "dq"),
                            ("dkv", ka.attention_bwd_dkv, "dkv")):
            bd = attn_bounds(kk, b, lq, lk, n_valid, dk, dv)
            row[f"{key}_ms"] = cuda_ms(lambda: fn(*args), reps)
            row[f"{key}_bound_3xtf32_ms"] = bd["3xtf32"][0]
            row[f"{key}_bound_f32_ms"] = bd["f32"][0]
            if kk == "dkv":
                row["dkv_bound_fma_tc_ms"] = bd["fma_tc"][0]
        if kind != "none":
            row["sdpa_bwd_ms"] = sdpa_bwd_ms(q, k, v, mask, dout,
                                             3 if big else reps)
        res[name] = row
        print(f"{name}: " + ", ".join(f"{k_} {v_:.4f}" if isinstance(
            v_, float) else f"{k_} {v_}" for k_, v_ in row.items()),
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
