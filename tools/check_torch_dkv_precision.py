#!/usr/bin/env python3
"""Why K6 sums dV in query order: the plain f32 backward is itself
inexact where dV is a long sum that cancels, on one NVIDIA card.

    python tools/check_torch_dkv_precision.py

With one valid key (the `cuda` tests' "all_but_one" and "last_key" masks)
P is 1 for every query and dV[key] is the sum of dO's Lq rows. This holds,
at bg's read (Lq 2040, Lk 22440, dk 128, dv 512) and at Lq 200, the
valid key's dV row of: the plain f32 version (`attention_bwd_dkv_plain`),
K6, and the best a tile-blocked order can do (exact 64-query partials,
summed in f32, as a tensor-core product per query tile would at best),
against the exact sum (float64), and counts the entries that miss the
card's check |d| <= 1e-5 + 1e-4 |t| against the plain version. Prints one
JSON line with the card's name. Needs CUDA.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.ops.kernels import attention as ka  # noqa


def misses(got, want):
    return int(((got - want).abs() > 1e-5 + 1e-4 * want.abs()).sum())


def main():
    if not torch.cuda.is_available():
        print("check_torch_dkv_precision: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"device": torch.cuda.get_device_name(0)}
    for lq, lk in ((2040, 22440), (200, 600)):
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
                   for s in ((lq, 128), (lk, 128), (lk, 512)))
        dout = torch.from_numpy(np.random.RandomState(1).randn(
            lq, 512).astype(np.float32)).cuda()
        key = lk // 3
        mask = torch.zeros(lk, device="cuda")
        mask[key] = 1.0
        out, lse = ka.attention_plain(q, k, v, mask)
        args = (q, k, v, mask, dout, lse, (dout * out).sum(dim=1))
        plain = ka.attention_bwd_dkv_plain(*args)[1][key]
        kernel = ka.attention_bwd_dkv(*args)[1][key]
        exact = dout.double().sum(dim=0)
        blocked = torch.zeros(512, device="cuda")
        for q0 in range(0, lq, 64):
            blocked = blocked + dout[q0:q0 + 64].double().sum(dim=0).float()
        row = {}
        for name, t in (("plain", plain), ("k6", kernel),
                        ("blocked64", blocked)):
            row[f"{name}_max_abs_err_vs_exact"] = float(
                (t.double() - exact).abs().max())
            if name != "plain":
                row[f"{name}_misses_vs_plain"] = misses(t, plain)
        row["k6_equals_plain"] = bool(torch.equal(kernel, plain))
        res[f"one_valid_key_lq{lq}_lk{lk}"] = row
        print(f"one valid key, Lq {lq} Lk {lk}: {row}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
