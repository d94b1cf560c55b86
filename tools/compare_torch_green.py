"""Green mode of the PyTorch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/compare_torch_green.py [--height 1080]
        [--width 1920] [--frames 3] [--seed chroma|deeplab]

Runs `video_unscreen_tpu_torch`'s `FusedGreenPipeline.run` (device="cpu")
and the JAX `FusedGreenPipeline.run` (`host_downscale=False`: the frames
resized on the device, fg on the device) on the same seeded synthetic
frames (`utils/synthetic.py:green_clip` at the given size), both in
float32, with configs/green.json at work long side 960 (1080p -> 544x960)
and the chroma seed, or with `--seed deeplab` the shipped DeepLab seed
(weights/deeplab_binseg.msgpack, 12 crops of 513x513 at 544x960). Prints
per frame the uint8 alphas' max |diff|, the share of pixels with |diff| >
1 and the share whose side of 128 differs, against the JAX suite's bound
(max |diff| <= 4, |diff| > 1 on < 0.1% of pixels,
tests/test_fused_green.py). Both runs are on the host: a few frames take
minutes.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--seed", choices=("chroma", "deeplab"),
                    default="chroma")
    args = ap.parse_args()
    import jax.numpy as jnp
    import torch

    from video_unscreen_tpu.pipeline.fused_green import \
        FusedGreenPipeline as JPipe
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline as TPipe
    from video_unscreen_tpu_torch.utils.synthetic import green_clip

    cfg = load_config(str(ROOT / "configs" / "green.json"))
    if args.seed == "chroma":
        cfg["binseg"] = {"type": "chroma"}
    else:
        cfg["binseg"]["model_path"] = str(ROOT / "weights" /
                                          "deeplab_binseg.msgpack")
    cfg["vmatting"]["model_path"] = str(ROOT / "weights" /
                                        "matting_unet.msgpack")
    hw = (args.height, args.width)
    frames, _ = green_clip(args.frames, *hw, seed=0)
    t0 = time.perf_counter()
    port = TPipe(cfg, hw, matting_dtype=torch.float32,
                 seg_dtype=torch.float32, device="cpu").run(
                     frames, host_downscale=False)
    t1 = time.perf_counter()
    ref = JPipe(cfg, hw, fetch_fg="device", pack_d2h=False,
                matting_dtype=jnp.float32, seg_dtype=jnp.float32).run(
                    frames, host_downscale=False)
    t2 = time.perf_counter()
    print(f"{args.frames} frames at {hw[0]}x{hw[1]}, seed {args.seed}, "
          f"float32: port {t1 - t0:.1f} s, JAX {t2 - t1:.1f} s (host wall, "
          f"builds and compiles included)")
    ok = True
    for name, got, want in zip(("alpha", "fg", "bg"), port, ref):
        print(f"{name}: frame  max|diff|  |diff|>1  side of 128")
        for i, (a, b) in enumerate(zip(got, want)):
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            side = float(((a >= 128) != (b >= 128)).mean())
            frac = float((d > 1).mean())
            ok &= bool(d.max() <= 4 and frac < 1e-3)
            print(f"{i:11d} {int(d.max()):10d} {frac:9.6f} {side:12.6f}")
    print("within the JAX bound" if ok else "OUTSIDE the JAX bound")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
