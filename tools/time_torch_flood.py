#!/usr/bin/env python3
"""Where K3's time goes, phase by phase, on one NVIDIA card.

    python tools/time_torch_flood.py [--reps 200]

K3 (`csrc/flood.cu`, connected-component labels with dense ids) runs as a
few launches a call. This times each launch with CUDA events between them
(`connected.phase_ms`, calls queued back to back behind a sleep kernel)
and the whole call as `chip_smoke.py` times it (`utils/timing.py:cuda_ms`), on
the masks `chip_smoke.py` times K3 on: the object-removal labels of the
green path at 272x480 and of bg mode at 1080x1920 (a thresholded soft
ellipse with speckle), and a random mask of density 0.45 at each size.
Prints one JSON line with the card's name. Needs CUDA.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.synthetic import soft_mask  # noqa: E402
from video_unscreen_tpu_torch.utils.timing import cuda_ms  # noqa: E402

SEED = 0
from video_unscreen_tpu_torch.ops.kernels import connected as kcc  # noqa


def masks():
    """(name, (H, W) f32 mask) of the timed cases."""
    out = []
    for (h, w), seed in (((272, 480), SEED + 1), ((1080, 1920), SEED + 4)):
        out.append((f"{h}x{w}_ellipse",
                    (soft_mask(h, w, seed) > 120).astype(np.float32) * 255))
        rng = np.random.RandomState(seed)
        out.append((f"{h}x{w}_random045",
                    (rng.rand(h, w) < 0.45).astype(np.float32) * 255))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_flood: CUDA is not available", file=sys.stderr)
        return 2
    res = {"device": torch.cuda.get_device_name(0)}
    for name, a in masks():
        m = torch.from_numpy(a).cuda()
        for g, t in zip(kcc.connected_components_compact(m),
                        kcc.cc_plain(m)):
            if not torch.equal(g, t):
                raise RuntimeError(f"flood {name}: differs from cc_plain")
        before = kcc.FLOOD.launches
        kcc.connected_components_compact(m)
        launches = kcc.FLOOD.launches - before
        phases = kcc.phase_ms(m, args.reps)
        call = cuda_ms(lambda: kcc.connected_components_compact(m),
                       args.reps)
        res[name] = dict(call_ms=call, launches=launches,
                         phases_ms=phases,
                         phases_sum_ms=sum(phases.values()))
        print(f"{name}: call {call:.4f} ms, {launches} launches; phases "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()),
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
