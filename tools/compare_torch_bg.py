"""bg mode of the PyTorch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/compare_torch_bg.py [--height 270]
        [--width 480] [--frames 8]

Runs `video_unscreen_tpu_torch/pipeline/bg.py:run` (device="cpu") and the
JAX `video_unscreen_tpu/pipeline/bg.py:run` on the same seeded synthetic
frames (`chip_smoke.py:green_clip` at the given size) with the slice's
configuration (configs/bg.json with the chroma seed at 960: STM and matting
at long side 960 whatever the frame size), and prints per frame the IoU of
each with the synthetic ground truth and the uint8 alphas' max |diff|, the
share of pixels with |diff| > 1 and the share whose side of 128 differs.
Keep the frames small: both runs are on the host.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import bg_config, green_clip, iou  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    from video_unscreen_tpu.pipeline import run_bg
    from video_unscreen_tpu_torch.pipeline import bg

    cfg = bg_config(ROOT / "weights" / "stm.msgpack",
                    ROOT / "weights" / "matting_unet.msgpack")
    frames, gts = green_clip(args.frames, args.height, args.width, seed=0)
    t0 = time.perf_counter()
    port = bg.run(cfg, frames, device="cpu")["alphas"]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_bg(dict(cfg, data={"dst_img_dir": tmp, "range": None}),
                     frames=frames, save=False)["alphas"]
    t2 = time.perf_counter()
    print(f"{args.frames} frames at {args.height}x{args.width}: port "
          f"{t1 - t0:.1f} s, JAX {t2 - t1:.1f} s (host wall, builds "
          f"included)")
    print("frame  IoU port  IoU JAX  max|diff|  |diff|>1  side of 128")
    for i, (a, b, g) in enumerate(zip(port, ref, gts)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        side = float(((a >= 128) != (b >= 128)).mean())
        print(f"{i:5d} {iou(a, g):9.4f} {iou(b, g):8.4f} {int(d.max()):10d} "
              f"{float((d > 1).mean()):9.6f} {side:12.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
