"""Where the PyTorch port's bg mode spends a frame, on one NVIDIA card.

    python tools/profile_torch_bg.py [--frames 8]

Runs `video_unscreen_tpu_torch/pipeline/bg.py:run` (configs/bg.json with
the chroma seed at 960, 1080p frames, STM and matting at 544x960) on the
seeded synthetic frames of `utils/synthetic.py:green_clip`: a 2-frame warm-up,
then once under `torch.profiler` with each stage in a `record_function`
span; the profiled run reuses the warm-up's agents, so the window holds
the frames and no weight loading. Prints per stage the device time of the kernels launched inside the
span and the host wall time per frame (a span's times include its nested
spans: `stm` holds `memory_read`, `background` holds `regionfill`), the
regionfill's CG iterations, the device's busy and idle share of the
profiled window, and the top device kernels. Needs a card: it exits
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

from video_unscreen_tpu_torch.utils.synthetic import (  # noqa: E402
    bg_config, green_clip)
from profile_torch_green import busy_ms, device_kernels, spanned  # noqa
from video_unscreen_tpu_torch.agents import (binseg, stm, trimap,  # noqa
                                             vmatting)
from video_unscreen_tpu_torch.models import stm as stm_model  # noqa: E402
from video_unscreen_tpu_torch.ops import regionfill as rf  # noqa: E402
from video_unscreen_tpu_torch.pipeline import bg  # noqa: E402

# (span, object, attribute)
PATCHES = (
    ("seed", binseg.ChromaSegAgent, "forward"),
    ("stm", stm.STMAgent, "forward"),
    ("memory_read", stm_model, "memory_read"),
    ("object_removal", bg, "remove_invalid_objects_cfg"),
    ("trimap", trimap.TrimapAgent, "forward"),
    ("matting", vmatting.VMattingAgent, "forward"),
    ("background", bg, "_per_frame_background"),
    ("regionfill", bg, "regionfill"),
    ("bg_mask", bg, "bgr2gray"),
    ("fg", bg, "get_fg"),
)
STAGES = tuple(p[0] for p in PATCHES)


@contextlib.contextmanager
def instrumented(iters):
    """Wrap each stage in a profiler span, record the CG iteration counts
    of the regionfill in `iters`, and build the agents once; everything is
    put back on exit."""
    core = rf._fill_core
    build = bg.build_bg_agents
    agents = []

    def build_once(*args, **kwargs):
        if not agents:
            agents.append(build(*args, **kwargs))
        return agents[0]

    def counted_core(*args, **kwargs):
        out, k = core(*args, **kwargs)
        iters.append(k.tolist())
        return out, k

    saved = [(obj, attr, getattr(obj, attr)) for _, obj, attr in PATCHES]
    saved += [(rf, "_fill_core", core), (bg, "build_bg_agents", build)]
    try:
        for (name, obj, attr), (_, _, fn) in zip(PATCHES, saved):
            setattr(obj, attr, spanned(name, fn))
        rf._fill_core = counted_core
        bg.build_bg_agents = build_once
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_bg: CUDA is not available", file=sys.stderr)
        return 2
    cfg = bg_config(ROOT / "weights" / "stm.msgpack",
                    ROOT / "weights" / "matting_unet.msgpack")
    frames, _ = green_clip(args.frames, 1080, 1920, seed=0)
    n = args.frames
    iters = []
    with instrumented(iters):
        bg.run(cfg, frames[:2], device="cuda")
        torch.cuda.synchronize()
        iters.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = bg.run(cfg, frames, device="cuda")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    frame_ms = sum(res["frame_seconds"]) * 1e3
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {n} frames, wall {wall:.2f} ms, frames "
          f"{frame_ms:.2f} ms ({n / frame_ms * 1e3:.3f} frames/s), per "
          f"frame {[round(t * 1e3, 1) for t in res['frame_seconds']]}")
    events = prof.events()
    print("stage            device ms/frame   host ms/frame   calls")
    for stage in STAGES:
        spans = [e for e in events if e.name == stage
                 and e.device_type == torch.autograd.DeviceType.CPU]
        dev = sum(e.device_time_total for e in spans) / 1e3 / n
        host = sum(e.cpu_time_total for e in spans) / 1e3 / n
        print(f"{stage:16s} {dev:15.3f} {host:15.3f} {len(spans):7d}")
    print(f"regionfill CG iterations per channel, per call: {iters}")
    kernels = device_kernels(events, STAGES)
    busy = busy_ms(events, STAGES)
    print(f"device busy {busy:.2f} ms of {wall:.2f} ms wall: idle share "
          f"{1.0 - busy / wall:.4f}")
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
