"""Time the port's JPEG codec beside the JAX package's libjpeg runtime on
this machine's CPU, on the same 1080p frames, and check they agree.

    JAX_PLATFORMS=cpu python tools/compare_torch_codec.py [--frames 8]
        [--reps 3] [--threads 1 8]

The frames are `utils/synthetic.py:green_clip(n, 1080, 1920, seed)` (the
codec phase of `chip_smoke.py`). Each codec encodes them at quality 95 and
decodes its files, at each thread count; the best of `--reps` runs, in ms
a frame, goes on one JSON line, with the check that both codecs wrote the
same bytes and decoded the same pixels. Needs g++ and libjpeg (the JAX
runtime's build); runs on the CPU only.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def best_ms(fn, reps, n):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3 / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from video_unscreen_tpu import runtime as jax_rt
    from video_unscreen_tpu_torch import runtime as port_rt
    from video_unscreen_tpu_torch.utils.synthetic import green_clip

    frames = np.stack(green_clip(args.frames, 1080, 1920, args.seed)[0])
    n = len(frames)
    out = {"frames": n, "hw": [1080, 1920], "quality": 95,
           "cpus": os.cpu_count()}
    with tempfile.TemporaryDirectory(prefix="vut_codec_cmp_") as d:
        paths = {k: [str(Path(d, f"{k}_{i}.jpg")) for i in range(n)]
                 for k in ("port", "libjpeg")}
        for name, rt in (("port", port_rt), ("libjpeg", jax_rt)):
            rt.encode_batch(paths[name], frames, quality=95)  # builds
            for t in args.threads:
                out[f"{name}_threads_{t}"] = {
                    "encode_ms_a_frame": best_ms(
                        lambda: rt.encode_batch(paths[name], frames,
                                                quality=95, threads=t),
                        args.reps, n),
                    "decode_ms_a_frame": best_ms(
                        lambda: rt.decode_batch(paths[name], threads=t),
                        args.reps, n)}
        out["bytes_equal"] = all(
            Path(a).read_bytes() == Path(b).read_bytes()
            for a, b in zip(paths["port"], paths["libjpeg"]))
        out["pixels_equal"] = bool(np.array_equal(
            port_rt.decode_batch(paths["libjpeg"]),
            jax_rt.decode_batch(paths["libjpeg"])))
    print(json.dumps(out))
    return 0 if out["bytes_equal"] and out["pixels_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
