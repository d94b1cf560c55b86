"""bg mode of the PyTorch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/compare_torch_bg.py [--height 270]
        [--width 480] [--frames 8] [--fused]

Runs `video_unscreen_tpu_torch/pipeline/bg.py:run` (device="cpu") and the
JAX `video_unscreen_tpu/pipeline/bg.py:run` on the same seeded synthetic
frames (`utils/synthetic.py:green_clip` at the given size) with the
slice's configuration (configs/bg.json with the chroma seed at 960: STM
and matting at long side 960 whatever the frame size), and prints per
frame the IoU of each with the synthetic ground truth and the uint8
alphas' max |diff|, the share of pixels with |diff| > 1 and the share
whose side of 128 differs, against the JAX suite's bound (max |diff| <= 4,
|diff| > 1 on < 0.1%). `--fused` compares the fused pipelines instead:
`FusedBgPipeline.run` of both packages in float32 at work long side 960
(the JAX one with `host_downscale=False` and the artifacts on the
device), alphas at work resolution. Keep the frames few: both runs are on
the host.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.synthetic import (  # noqa: E402
    bg_config, green_clip, iou)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args()
    cfg = bg_config(ROOT / "weights" / "stm.msgpack",
                    ROOT / "weights" / "matting_unet.msgpack")
    hw = (args.height, args.width)
    frames, gts = green_clip(args.frames, *hw, seed=0)
    t0 = time.perf_counter()
    if args.fused:
        port, ref = run_fused(cfg, frames, hw)
    else:
        port, ref = run_modular(cfg, frames)
    t1 = time.perf_counter()
    print(f"{args.frames} frames at {hw[0]}x{hw[1]}, "
          f"{'fused' if args.fused else 'modular'}: {t1 - t0:.1f} s for "
          f"both (host wall, builds included)")
    print("frame  IoU port  IoU JAX  max|diff|  |diff|>1  side of 128")
    ok = True
    for i, (a, b, g) in enumerate(zip(port, ref, gts)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        side = float(((a >= 128) != (b >= 128)).mean())
        frac = float((d > 1).mean())
        ok &= bool(d.max() <= 4 and frac < 1e-3)
        g = resize_gt(g, a.shape)
        print(f"{i:5d} {iou(a, g):9.4f} {iou(b, g):8.4f} {int(d.max()):10d} "
              f"{frac:9.6f} {side:12.6f}")
    print("within the JAX bound" if ok else "OUTSIDE the JAX bound")
    return 0 if ok else 1


def resize_gt(gt, hw):
    """The ground truth at the alphas' resolution (nearest)."""
    if gt.shape == hw:
        return gt
    ys = np.minimum(((np.arange(hw[0]) + 0.5) * gt.shape[0] / hw[0]
                     ).astype(int), gt.shape[0] - 1)
    xs = np.minimum(((np.arange(hw[1]) + 0.5) * gt.shape[1] / hw[1]
                     ).astype(int), gt.shape[1] - 1)
    return gt[ys][:, xs]


def run_modular(cfg, frames):
    from video_unscreen_tpu.pipeline import run_bg
    from video_unscreen_tpu_torch.pipeline import bg
    port = bg.run(cfg, frames, device="cpu")["alphas"]
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_bg(dict(cfg, data={"dst_img_dir": tmp, "range": None}),
                     frames=frames, save=False)["alphas"]
    return port, ref


def run_fused(cfg, frames, hw):
    import jax.numpy as jnp
    import torch
    from video_unscreen_tpu.pipeline.fused_bg import \
        FusedBgPipeline as JPipe
    from video_unscreen_tpu_torch.pipeline.fused_bg import \
        FusedBgPipeline as TPipe
    port = TPipe(cfg, hw, matting_dtype=torch.float32,
                 stm_dtype=torch.float32, seg_dtype=torch.float32,
                 device="cpu").run(frames, host_downscale=False)[0]
    ref = JPipe(cfg, hw, fetch="device", pack_d2h=False,
                matting_dtype=jnp.float32, stm_dtype=jnp.float32,
                seg_dtype=jnp.float32).run(frames, host_downscale=False)[0]
    return port, ref


if __name__ == "__main__":
    sys.exit(main())
