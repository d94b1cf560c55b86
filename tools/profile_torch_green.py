"""Where the PyTorch port's green path spends a frame, on one NVIDIA card.

    python tools/profile_torch_green.py [--frames 8] [--warmup 2]

Runs `video_unscreen_tpu_torch`'s `FusedGreenPipeline` (configs/green.json,
chroma seed, 1080p -> 544x960) on the seeded synthetic frames of
`chip_smoke.py:green_clip`, first three times unprofiled (frames/s of each
run, for the run-to-run spread), then once under `torch.profiler`, with
each stage wrapped in a `record_function` span, and prints per stage the device time (kernels launched inside the span) and the
host wall time, the top device kernels, the device's busy and idle share of
the profiled window, and the MattingUNet's operation count (counted on the
meta device) beside its device time. Needs a card: it exits non-zero
without one.
"""

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import green_clip  # noqa: E402
from video_unscreen_tpu_torch.config import load_config  # noqa: E402
from video_unscreen_tpu_torch.models.matting_unet import \
    MattingUNet  # noqa: E402
from video_unscreen_tpu_torch.pipeline import fused_green  # noqa: E402

STAGES = ("seed_mask", "color_filter", "object_removal", "trimap",
          "matting", "color_correct", "fg")


def spanned(name, fn):
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def instrumented(pipe):
    """Wrap each stage of one pipeline object in a profiler span; the
    module functions of `pipeline/fused_green.py` that it wraps are put
    back on exit."""
    pipe.cf.device_forward_impl = spanned("color_filter",
                                          pipe.cf.device_forward_impl)
    pipe.vmat.device_forward_impl = spanned("matting",
                                            pipe.vmat.device_forward_impl)
    pipe._gen_trimap = spanned("trimap", pipe._gen_trimap)
    saved = {}
    for mod_attr, stage in (("seed_mask", "seed_mask"),
                            ("remove_invalid_objects_ds", "object_removal"),
                            ("color_correct", "color_correct"),
                            ("get_fg", "fg")):
        saved[mod_attr] = getattr(fused_green, mod_attr)
        setattr(fused_green, mod_attr, spanned(stage, saved[mod_attr]))
    try:
        yield pipe
    finally:
        for mod_attr, fn in saved.items():
            setattr(fused_green, mod_attr, fn)


def device_kernels(events):
    """Kernel events: device-side, minus the device copies of our spans."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in STAGES]


def busy_ms(events):
    """Union of the device intervals of all kernels, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_kernels(events))
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def unet_flop(h, w):
    """Operations of one MattingUNet forward at (h, w), counted by
    `torch.utils.flop_counter` on the meta device (no compute)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        net = MattingUNet().eval()
        with FlopCounterMode(display=False) as counter:
            net(torch.zeros(1, 3, h, w), torch.zeros(1, 1, h, w),
                torch.zeros(1, 3, h, w))
    return counter.get_total_flops()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_green: CUDA is not available", file=sys.stderr)
        return 2

    cfg = load_config(str(ROOT / "configs" / "green.json"))
    cfg["binseg"] = {"type": "chroma"}
    cfg["vmatting"]["model_path"] = str(ROOT / "weights" /
                                        "matting_unet.msgpack")
    frames, _ = green_clip(args.frames, 1080, 1920, seed=0)
    pipe = fused_green.FusedGreenPipeline(cfg, (1080, 1920), device="cuda")
    n = args.frames
    with instrumented(pipe):
        pipe.run(frames[:args.warmup])
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe.run(frames)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        print("unprofiled frames/s: "
              + ", ".join(f"{r:.2f}" for r in rates))

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.run(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}; {n} frames, "
          f"wall {wall:.2f} ms ({n / wall * 1e3:.2f} frames/s)")
    events = prof.events()
    print("stage            device ms/frame   host ms/frame   calls")
    device_ms = {}
    for stage in STAGES:
        spans = [e for e in events if e.name == stage
                 and e.device_type == torch.autograd.DeviceType.CPU]
        dev = sum(e.device_time_total for e in spans) / 1e3 / n
        host = sum(e.cpu_time_total for e in spans) / 1e3 / n
        device_ms[stage] = dev
        print(f"{stage:16s} {dev:15.3f} {host:15.3f} {len(spans):7d}")
    flop = unet_flop(*pipe.work_hw)
    print(f"MattingUNet at {pipe.work_hw}: {flop / 1e9:.2f} GFLOP per frame, "
          f"{flop / device_ms['matting'] / 1e9:.2f} TFLOP/s over the "
          f"matting stage's device time")
    busy = busy_ms(events)
    print(f"device busy {busy:.2f} ms of {wall:.2f} ms wall: idle share "
          f"{1.0 - busy / wall:.4f}")
    kernels = device_kernels(events)
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
