"""Where the PyTorch port's green path spends a frame, on one NVIDIA card.

    python tools/profile_torch_green.py [--frames 8] [--warmup 2]
        [--seed chroma|deeplab] [--segments 1] [--wire bgr|yuv420]

Runs `video_unscreen_tpu_torch`'s `FusedGreenPipeline` (configs/green.json,
1080p -> 544x960, the chroma seed or, with `--seed deeplab`, the shipped
DeepLab seed from weights/deeplab_binseg.msgpack; matting and seed in the
pipeline's default bfloat16; `run`, or
`run_segmented` with S segments of 4-frame chunks) on the seeded synthetic
frames of `utils/synthetic.py:green_clip`. `--wire bgr` (the default)
uploads the 1080p BGR frames and resizes them on the device
(`host_downscale=False`); `--wire yuv420` runs bench.py's configuration:
the host resizes each frame to 544x960 and packs it as I420, and the
device decodes it. The run goes first three times unprofiled
(frames/s of each run, for the run-to-run spread), then once under
`torch.profiler`, with
each stage wrapped in a `record_function` span, and prints per stage the device time (kernels launched inside the span) and the
host wall time, the top device kernels, the device's busy and idle share of
the profiled window, and the MattingUNet's operation count (counted on the
meta device) beside its device time, and the host side of the upload:
the worker's host prep (`runtime.prep_batch`) ms a chunk and a frame, the
main thread's wait for chunks (`stream_wait`) ms a frame, and the
host-to-device copies' device ms a frame and bytes a frame. Needs a card:
it exits non-zero without one.
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

from video_unscreen_tpu_torch.utils.synthetic import green_clip  # noqa
from video_unscreen_tpu_torch.config import load_config  # noqa: E402
from video_unscreen_tpu_torch.models.matting_unet import \
    MattingUNet  # noqa: E402
from video_unscreen_tpu_torch import runtime  # noqa: E402
from video_unscreen_tpu_torch.pipeline import fused_green  # noqa: E402
from video_unscreen_tpu_torch.utils.profiling import StageTimer  # noqa

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


@contextlib.contextmanager
def timed_prep(seconds):
    """Append the host seconds of each `runtime.prep_batch` call (one a
    chunk, in the streamer's worker) to `seconds`."""
    saved = runtime.prep_batch

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return saved(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)
    runtime.prep_batch = wrapper
    try:
        yield
    finally:
        runtime.prep_batch = saved


def device_kernels(events, stages=STAGES):
    """Kernel events: device-side, minus the device copies of the spans
    named `stages`."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in stages]


def busy_ms(events, stages=STAGES):
    """Union of the device intervals of all kernels, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_kernels(events, stages))
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
    ap.add_argument("--seed", choices=("chroma", "deeplab"),
                    default="chroma")
    ap.add_argument("--segments", type=int, default=1)
    ap.add_argument("--wire", choices=("bgr", "yuv420"), default="bgr")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_green: CUDA is not available", file=sys.stderr)
        return 2

    cfg = load_config(str(ROOT / "configs" / "green.json"))
    if args.seed == "chroma":
        cfg["binseg"] = {"type": "chroma"}
    else:
        cfg["binseg"]["model_path"] = str(ROOT / "weights" /
                                          "deeplab_binseg.msgpack")
    cfg["vmatting"]["model_path"] = str(ROOT / "weights" /
                                        "matting_unet.msgpack")
    frames, _ = green_clip(args.frames, 1080, 1920, seed=0)
    pipe = fused_green.FusedGreenPipeline(cfg, (1080, 1920), wire=args.wire,
                                          device="cuda")
    n, s = args.frames, args.segments
    host_downscale = args.wire == "yuv420"
    timer, prep_s = StageTimer(), []

    def run(clip):
        return pipe.run_segmented(clip, s, 4 if s > 1 else 8,
                                  host_downscale=host_downscale,
                                  timer=timer)

    with instrumented(pipe):
        run(frames[:max(args.warmup, s)])
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(frames)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        print(f"seed {args.seed}, bfloat16, S {s}, wire {args.wire}; "
              f"unprofiled frames/s: "
              + ", ".join(f"{r:.2f}" for r in rates))

        timer = StageTimer()
        with timed_prep(prep_s), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}; wire {args.wire}; "
          f"{n} frames, wall {wall:.2f} ms ({n / wall * 1e3:.2f} frames/s)")
    events = prof.events()
    h2d = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "HtoD" in e.name]
    h2d_ms = sum(e.time_range.elapsed_us() for e in h2d) / 1e3
    wire_bytes = (pipe.work_hw[0] * pipe.work_hw[1] * 3 // 2
                  if host_downscale else 1080 * 1920 * 3)
    print(f"upload: host prep {sum(prep_s) * 1e3 / len(prep_s):.3f} ms a "
          f"chunk ({len(prep_s)} chunks), {sum(prep_s) * 1e3 / n:.3f} ms a "
          f"frame (worker thread); stream_wait "
          f"{timer.times['stream_wait'] * 1e3 / n:.3f} ms a frame (main "
          f"thread); host-to-device copies {len(h2d)}, {h2d_ms / n:.4f} "
          f"device ms a frame; wire bytes a frame {wire_bytes}")
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
