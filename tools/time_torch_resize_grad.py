#!/usr/bin/env python3
"""ISeg BRS with `resize_nchw`'s matrix gradient against torch's own
bilinear backward, on one NVIDIA card.

    python tools/time_torch_resize_grad.py [--reps 5]

`ops/geometry.py:resize_nchw` takes its gradient as two matmuls by cached
interpolation matrices, so a train step repeats bit for bit on the card
(torch's CUDA bilinear backward sums with atomics). BRS (`agents/iseg.py`)
takes that gradient at every function evaluation. This runs the shipped
`weights/iseg.msgpack` as `chip_smoke.py` phase 11 does (a 1080x1920 green
frame, input_long_side 800, flip TTA, two clicks), at each insertion
point, with `models/iseg.py`'s resize swapped between the two backwards
in one process: wall ms a call over `--reps` calls after a warm-up, in
the order a-b-b-a-a-b; then one after_deeplab call of each under
`torch.profiler`, its device and host totals. Prints the card's name and
power limit, and one JSON line. Needs CUDA.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.agents.iseg import ISegAgent  # noqa: E402
from video_unscreen_tpu_torch.models import iseg as miseg  # noqa: E402
from video_unscreen_tpu_torch.ops.geometry import resize_nchw  # noqa: E402
from video_unscreen_tpu_torch.utils.synthetic import green_clip  # noqa

FRAME_HW, LONG, SEED = (1080, 1920), 800, 0
MODES = ("after_aspp", "after_c4", "after_deeplab")
ORDER = ("torch", "matrix", "matrix", "torch", "torch", "matrix")


def torch_backward(x, out_hw):
    """`resize_nchw` with torch's own bilinear backward."""
    return F.interpolate(x, size=(int(out_hw[0]), int(out_hw[1])),
                         mode="bilinear", align_corners=False,
                         antialias=False)


RESIZES = {"torch": torch_backward, "matrix": resize_nchw}


def call_ms(agent, img, clicks, reps):
    agent.predict_probs(img, clicks, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        agent.predict_probs(img, clicks, True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profiled_ms(agent, img, clicks):
    """(device ms, host ms) of one BRS call, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    agent.predict_probs(img, clicks, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        agent.predict_probs(img, clicks, True)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return (sum(e.self_device_time_total for e in ka) / 1e3,
            sum(e.self_cpu_time_total for e in ka) / 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    frames, gts = green_clip(1, *FRAME_HW, seed=SEED + 2)
    img, gt = frames[0], gts[0]
    ys, xs = np.nonzero(gt)
    clicks = [(True, int(ys.mean()), int(xs.mean())), (False, 80, 120)]
    weights = str(ROOT / "weights" / "iseg.msgpack")
    agents = {m: ISegAgent(weights, input_long_side=LONG, with_brs=True,
                           insertion_mode=m, device="cuda") for m in MODES}
    runs = []
    for name in ORDER:
        miseg.resize_nchw = RESIZES[name]
        ms = {m: call_ms(a, img, clicks, args.reps)
              for m, a in agents.items()}
        runs.append({"backward": name, "ms": ms})
        print(f"{name}: BRS ms a call over {args.reps} calls: "
              + ", ".join(f"{m} {v:.2f}" for m, v in ms.items()),
              flush=True)
    profiled = {}
    for name in ("torch", "matrix"):
        miseg.resize_nchw = RESIZES[name]
        dev, host = profiled_ms(agents["after_deeplab"], img, clicks)
        profiled[name] = {"device_ms": dev, "host_ms": host}
        print(f"{name}: after_deeplab profiled, device {dev:.2f} ms, host "
              f"{host:.2f} ms", flush=True)
    miseg.resize_nchw = resize_nchw
    print(json.dumps({"card": card, "runs": runs, "profiled": profiled}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
