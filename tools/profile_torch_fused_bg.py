"""Where the PyTorch port's fused bg mode spends a frame, on one NVIDIA card.

    python tools/profile_torch_fused_bg.py [--frames 8] [--segments 1]
        [--seed chroma|schp]

Runs `video_unscreen_tpu_torch`'s `FusedBgPipeline` (configs/bg.json:
STM, matting and seed in the pipeline's default bfloat16, a ring bank of
2, 1080p -> 544x960) with the chroma seed, or with `--seed schp` the SCHP
seed on seeded weights (random SCHP masks change how often STM tracks, so
its rates are not the shipped weights'), on the seeded synthetic frames of
`utils/synthetic.py:green_clip`: `run`, or `run_segmented` with S
segments in chunks of 4. A warm-up, three unprofiled runs (frames/s of
each, for the spread), then one under `torch.profiler` with each stage in
a `record_function` span. Prints per stage the device time of the kernels
launched inside the span and the host wall time per frame (a span's times
include its nested spans: `background` holds `regionfill`), the
pipeline's counts (host syncs, CG iterations, tracked and seeded frames),
the device's busy and idle share of the profiled window, its launches a
frame and the top device kernels. Kernels launched through `ctypes` (K1-K4)
appear in the kernel list but not in the spans. Needs a card: it exits
non-zero without one.
"""

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from profile_torch_green import busy_ms, device_kernels, spanned  # noqa
from video_unscreen_tpu_torch.pipeline import fused_bg  # noqa: E402
from video_unscreen_tpu_torch.utils.synthetic import (  # noqa: E402
    bg_config, green_clip)

# (span, module function of pipeline/fused_bg.py)
MODULE_SPANS = (("seed", "seed_mask"),
                ("object_removal", "remove_invalid_objects_ds"),
                ("trimap", "generate_trimap"),
                ("regionfill", "regionfill_solve"),
                ("fg", "get_fg"))
# (span, pipeline method)
PIPE_SPANS = (("stm", "_stm_track_mask"), ("bank", "_bank_update"),
              ("background", "_per_frame_background"),
              ("bg_ema", "_bg_model_update"))
STAGES = ("seed", "stm", "bank", "object_removal", "trimap", "matting",
          "background", "regionfill", "bg_ema", "fg")


@contextlib.contextmanager
def instrumented(pipe):
    """Wrap each stage in a profiler span; the module functions are put
    back on exit."""
    for span, attr in PIPE_SPANS:
        setattr(pipe, attr, spanned(span, getattr(pipe, attr)))
    pipe.vmat.device_forward_impl = spanned("matting",
                                            pipe.vmat.device_forward_impl)
    saved = {attr: getattr(fused_bg, attr) for _, attr in MODULE_SPANS}
    try:
        for span, attr in MODULE_SPANS:
            setattr(fused_bg, attr, spanned(span, saved[attr]))
        yield pipe
    finally:
        for attr, fn in saved.items():
            setattr(fused_bg, attr, fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--segments", type=int, default=1)
    ap.add_argument("--seed", choices=("chroma", "schp"), default="chroma")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fused_bg: CUDA is not available",
              file=sys.stderr)
        return 2
    cfg = bg_config(ROOT / "weights" / "stm.msgpack",
                    ROOT / "weights" / "matting_unet.msgpack")
    if args.seed == "schp":
        cfg["binseg"] = {"type": "human", "seed": 0}
    frames, _ = green_clip(args.frames, 1080, 1920, seed=0)
    pipe = fused_bg.FusedBgPipeline(cfg, (1080, 1920), device="cuda")
    n, s = args.frames, args.segments

    def run(clip):
        return pipe.run_segmented(clip, s, 4, host_downscale=False)

    with instrumented(pipe):
        run(frames[:max(2, s)])
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(frames)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        print(f"seed {args.seed}, bfloat16, S {s}; unprofiled frames/s: "
              + ", ".join(f"{r:.3f}" for r in rates))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3

    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {n} frames, wall {wall:.2f} ms "
          f"({n / wall * 1e3:.3f} frames/s profiled)")
    st = pipe.stats
    print(f"counts: {dict(st)}; {st['syncs'] / n:.3f} host syncs a frame; "
          f"{st['cg_iters'] / (3 * n):.1f} CG iterations a channel solve")
    events = prof.events()
    print("stage            device ms/frame   host ms/frame   calls")
    for stage in STAGES:
        spans = [e for e in events if e.name == stage
                 and e.device_type == torch.autograd.DeviceType.CPU]
        dev = sum(e.device_time_total for e in spans) / 1e3 / n
        host = sum(e.cpu_time_total for e in spans) / 1e3 / n
        print(f"{stage:16s} {dev:15.3f} {host:15.3f} {len(spans):7d}")
    busy = busy_ms(events, STAGES)
    print(f"device busy {busy:.2f} ms of {wall:.2f} ms wall: idle share "
          f"{1.0 - busy / wall:.4f}")
    kernels = device_kernels(events, STAGES)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print(f"device kernels: {len(kernels)} launches, "
          f"{len(kernels) / n:.1f} per frame; top 15 by device time:")
    for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / 1e3 / n:9.4f} ms/frame {c:6d}x  {k[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
