#!/usr/bin/env python3
"""Where K6's time goes: K6 with parts of its work switched off, on one
NVIDIA card.

    python tools/time_torch_dkv_parts.py

Builds the kernel library once for each variant below through
`ops/kernels/build.py` (all at once), each with a `-DVUT_DKV_SKIP` mask
that `csrc/attention.cu` reads (the outputs of a variant are wrong; only
its time is read), and times each variant's `vut_attention_bwd_dkv` at
bg's read with every key valid (Lq 2040, Lk 22440, dk 128, dv 512; the
wrapper's grid) with CUDA events (`utils/timing.py:cuda_ms`):
  full         the kernel as built;
  no_dv        the FMA warps' dV products;
  no_dp        the tensor-core warps' dP products;
  no_s         the FMA warps' S loop (P from zero scores);
  no_dk        the tensor-core warps' dK products;
  skeleton     all four: what is left is the staging, the barriers, P and
               dS written, the stores;
  one_group    the kernel as built with one block per key block, without
               the split of the last wave's key blocks (`dkv_grid`).
The gap between two rows is the part's cost where the rest does not hide
it. Prints one JSON line with the card's name. Needs CUDA and nvcc.
"""

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.timing import (  # noqa: E402
    ATTN_DK, ATTN_DV, ATTN_LQ, ATTN_SLOTS, cuda_ms)
from video_unscreen_tpu_torch.ops.kernels import attention as ka  # noqa
from video_unscreen_tpu_torch.ops.kernels import build  # noqa: E402

# the VUT_DKV_SKIP mask of each variant (bits as in csrc/attention.cu)
VARIANTS = {"full": 0, "no_dv": 1, "no_dp": 2, "no_s": 4, "no_dk": 8,
            "skeleton": 15}


def load_variants():
    """{variant: loaded library}, the builds run at once."""
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(
            lambda m: build.build((f"-DVUT_DKV_SKIP={m}",)),
            VARIANTS.values())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.vut_attention_bwd_dkv.argtypes = list(
            build._SIGNATURES["vut_attention_bwd_dkv"])
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("time_torch_dkv_parts: CUDA is not available", file=sys.stderr)
        return 2
    lq, lk, dk, dv = ATTN_LQ, ATTN_SLOTS * ATTN_LQ, ATTN_DK, ATTN_DV
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(1, *s, generator=gen, device="cuda")
                     for s in ((lq, dk), (lk, dk), (lk, dv), (lq, dv)))
    mask = torch.ones(1, lk, device="cuda")
    out, lse = ka.attention_plain(q, k, v, mask)
    delta = (dout * out).sum(dim=-1)
    grad_k = torch.empty(1, lk, dk, device="cuda")
    grad_v = torch.empty(1, lk, dv, device="cuda")
    grid = ka.dkv_grid(1, lk, dv, torch.cuda.get_device_properties(
        0).multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"device": torch.cuda.get_device_name(0), "Lq": lq, "Lk": lk,
           "dk": dk, "dv": dv, "grid": grid}
    libs = load_variants()
    runs = [(name, lib, grid) for name, lib in libs.items()]
    runs.append(("one_group", libs["full"], (-(-lk // ka.KEY_BLOCK), 1, 1)))
    for name, lib, g in runs:
        n = ctypes.c_int(0)

        def call():
            err = lib.vut_attention_bwd_dkv(
                *[t.data_ptr() for t in (q, k, v, mask, dout, lse, delta,
                                         grad_k, grad_v)],
                1, lq, lk, dk, dv, *g, stream, ctypes.addressof(n))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        res[f"{name}_ms"] = cuda_ms(call, 5)
        print(f"{name}: {res[f'{name}_ms']:.4f} ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
