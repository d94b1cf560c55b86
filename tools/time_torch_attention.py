#!/usr/bin/env python3
"""What K4's recomputed q k^T costs at bg's shape, on one NVIDIA card.

    python tools/time_torch_attention.py

K4 (`csrc/attention.cu:attn_fwd_kernel`) gives each block one 64-query
tile and one 128-column chunk of dv, so the dv / 128 blocks of a query
tile each form the same q k^T tile. This times K4 over Lq 2040 x Lk 22440
(dk 128), with every key valid and with the STM mask, at dv 128 (32
blocks, one a query tile) and at dv 512 (the bg path's width: 128 blocks,
four a query tile, each doing a dv-128 block's work), and prints one JSON
line. Equal times mean the recomputation runs on SMs that would otherwise
idle: one block a query tile forming q k^T once would do four chunks of
P V on 32 SMs. Needs CUDA; device time from CUDA events
(`utils/timing.py:cuda_ms`).
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.timing import (  # noqa: E402
    ATTN_DK, ATTN_LQ, ATTN_SLOTS, cuda_ms)
from video_unscreen_tpu_torch.ops.kernels import attention as ka  # noqa


def main():
    if not torch.cuda.is_available():
        print("time_torch_attention: CUDA is not available", file=sys.stderr)
        return 2
    lq, lk, dk = ATTN_LQ, ATTN_SLOTS * ATTN_LQ, ATTN_DK
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(lq, dk, generator=gen, device="cuda")
    k = torch.randn(lk, dk, generator=gen, device="cuda")
    v = torch.randn(lk, 512, generator=gen, device="cuda")
    masks = {"all": torch.ones(lk, device="cuda"),
             "stm": torch.zeros(lk, device="cuda")}
    masks["stm"][-lq:] = 1.0
    res = {"device": torch.cuda.get_device_name(0), "Lq": lq, "Lk": lk,
           "dk": dk}
    for name, mask in masks.items():
        for dv in (128, 512):
            vv = v[:, :dv].contiguous()
            res[f"{name}_dv{dv}_ms"] = cuda_ms(
                lambda: ka.masked_memory_attention(q, k, vv, mask), 20)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
