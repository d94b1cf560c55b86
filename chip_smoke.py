#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its wall seconds:
  1. build the CUDA kernels of video_unscreen_tpu_torch/csrc (one nvcc call);
  2. build the green pipeline (configs/green.json with the chroma seed) at
     1080p -> 544x960 and load the MattingUNet weights
     (weights/matting_unet.msgpack; missing weights fail the run);
  3. hold each kernel (K1 trimap, K2 morph, K3 flood) bit-exact against its
     plain PyTorch version on the card at the main path's shapes, and time
     both with CUDA events;
  4. run `FusedGreenPipeline.run` on 8 seeded synthetic 1080p green-screen
     frames with every launch count reset just before, check that each
     kernel launched, the outputs (IoU with the synthetic ground truth
     > 0.75), and the frames per second;
  5. run the first 2 frames again on the host (device="cpu", the plain
     versions) and hold the card's alphas to the JAX suite's bound.

Then it prints one JSON line of per-kernel numbers, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without CUDA, or without the package
beside this file, it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAME_HW = (1080, 1920)
WORK_LONG_SIDE = 960
N_FRAMES = 8
N_CPU_FRAMES = 2
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f}s", flush=True)


def green_clip(n, h, w, seed):
    """A magenta ellipse moving right over a noisy green screen (the
    pattern of the repo's synthetic clips, at 1080p), and its GT alpha."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames, gts = [], []
    for t in range(n):
        blob = ((yy - h // 2) ** 2 / 260.0 ** 2
                + (xx - (w // 3 + 6 * t)) ** 2 / 170.0 ** 2) < 1.0
        img = np.empty((h, w, 3), np.float32)
        img[...] = (40, 190, 50)
        img[blob] = (150, 60, 170)
        img += rng.randn(h, w, 3).astype(np.float32) * 4
        frames.append(img.clip(0, 255).astype(np.uint8))
        gts.append(blob)
    return frames, gts


def soft_mask(h, w, seed):
    """Seeded soft ellipse with speckle: a grayscale mask for morphology."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w), np.float32)
    a[((yy - h // 2) ** 2 / (h * 0.3) ** 2
       + (xx - w // 3) ** 2 / (w * 0.2) ** 2) < 1.0] = 255.0
    a *= rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    a[rng.rand(h, w) < 0.002] = 200.0
    return a


def cuda_ms(fn, reps, rounds=7):
    """Median over `rounds` of the device time per call of `fn`, from CUDA
    events around `reps` calls. A sleep kernel holds the stream while the
    host queues the calls, so the card runs them back to back and the
    host's launch cost (tens of us per call from Python) stays out of the
    time of a kernel that takes less."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    # cycles for 1.5x the host's queueing time at up to 2 GHz
    cycles = int((1.5 * reps * host_ms + 1.0) * 2e6)
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(device):
    """Each kernel against its plain version on the card; returns rows."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import connected as kcc
    from video_unscreen_tpu_torch.ops.kernels import morph as km
    from video_unscreen_tpu_torch.ops.morphology import ellipse_offsets

    h, w = 544, 960
    offs = ellipse_offsets(3)
    n_nb = len([o for o in offs if o != (0, 0)])
    mask = torch.from_numpy(soft_mask(h, w, SEED)).to(device)
    rows = {}

    def held(name, got, want):
        check(all(g.shape == t.shape and g.dtype == t.dtype
                  for g, t in zip(got, want)), f"{name}: shape/dtype")
        err = max(float((g.double() - t.double()).abs().max())
                  for g, t in zip(got, want))
        check(err == 0.0, f"{name}: kernel differs from plain by {err}")
        return err

    # K1: trimap, k=3, iters=5 (one per frame)
    err = held("trimap", [km.trimap(mask, offs, 5)],
               [km.trimap_plain(mask, offs, 5)])
    err = max(err, held("trimap iters=20",
                        [km.trimap(mask, offs, 20)],
                        [km.trimap_plain(mask, offs, 20)]))
    ms = cuda_ms(lambda: km.trimap(mask, offs, 5), 200)
    plain = cuda_ms(lambda: km.trimap_plain(mask, offs, 5), 5)
    b, by = bound(2 * h * w * 4, h * w * (2 * 5 * n_nb + 2))
    rows["trimap"] = dict(
        source="video_unscreen_tpu_torch/csrc/morph.cu",
        replaces="video_unscreen_tpu/ops/pallas/morph.py:80",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    print(f"  K1 trimap 544x960 k=3 iters=5: {ms:.4f} ms (plain "
          f"{plain:.4f} ms, bound {b:.4f} ms)", flush=True)

    # K2: morph, k=3, iters=2 (color filter and seed cleanup), and the
    # band widen's longest chain (iters=40, three launches)
    err = 0.0
    for iters in (2, 10, 40):
        for dil in (True, False):
            err = max(err, held(f"morph iters={iters} dilate={dil}",
                                [km.morph(mask, offs, iters, dil)],
                                [km.morph_plain(mask, offs, iters, dil)]))
    ms = cuda_ms(lambda: km.morph(mask, offs, 2, True), 200)
    plain = cuda_ms(lambda: km.morph_plain(mask, offs, 2, True), 5)
    ms40 = cuda_ms(lambda: km.morph(mask, offs, 40, True), 50)
    plain40 = cuda_ms(lambda: km.morph_plain(mask, offs, 40, True), 2)
    b, by = bound(2 * h * w * 4, h * w * 2 * n_nb)
    rows["morph"] = dict(
        source="video_unscreen_tpu_torch/csrc/morph.cu",
        replaces="video_unscreen_tpu/ops/pallas/morph.py:89",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    print(f"  K2 morph 544x960 k=3 iters=2: {ms:.4f} ms (plain "
          f"{plain:.4f} ms, bound {b:.4f} ms); iters=40: {ms40:.4f} ms "
          f"(plain {plain40:.4f} ms)", flush=True)

    # K3: flood at 272x480 (object removal labels at work/2)
    hh, ww = h // 2, w // 2
    rng = np.random.RandomState(SEED)
    cases = [(soft_mask(hh, ww, SEED + 1) > 120).astype(np.float32) * 255,
             (rng.rand(hh, ww) < 0.45).astype(np.float32) * 255,
             (rng.rand(hh, ww) < 0.6).astype(np.float32) * 255]
    err = 0.0
    for i, c in enumerate(cases):
        m = torch.from_numpy(c).to(device)
        err = max(err, held(f"flood case {i}",
                            kcc.connected_components_compact(m),
                            kcc.cc_plain(m)))
    m = torch.from_numpy(cases[0]).to(device)
    ms = cuda_ms(lambda: kcc.connected_components_compact(m), 200)
    plain = cuda_ms(lambda: kcc.cc_plain(m), 2, rounds=3)
    b, by = bound(hh * ww * (4 + 4 + 4), hh * ww * 2)
    rows["flood"] = dict(
        source="video_unscreen_tpu_torch/csrc/flood.cu",
        replaces="video_unscreen_tpu/ops/pallas/flood.py:102",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    print(f"  K3 flood 272x480: {ms:.4f} ms (plain {plain:.4f} ms, bound "
          f"{b:.4f} ms)", flush=True)
    return rows


def within_bound(got, want):
    import numpy as np
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 1).mean())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import video_unscreen_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: imported {pkg.__file__}, not the package "
              f"beside this script", file=sys.stderr)
        return 2

    import numpy as np
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.ops.geometry import resize
    from video_unscreen_tpu_torch.ops.kernels import build
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    phase(f"build ({lib_path.name})", t0)

    t0 = time.perf_counter()
    cfg = load_config(str(ROOT / "configs" / "green.json"))
    cfg["binseg"] = {"type": "chroma"}
    weights = ROOT / "weights" / "matting_unet.msgpack"
    check(weights.is_file(), f"the MattingUNet weights {weights} are missing")
    cfg["vmatting"]["model_path"] = str(weights)
    pipe = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              device="cuda")
    check(pipe.work_hw == (544, 960), f"work res {pipe.work_hw}")
    phase(f"weights ({weights.relative_to(ROOT)})", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(device)
    phase("kernels vs plain", t0)

    t0 = time.perf_counter()
    frames, gts = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    phase("frames", t0)

    t0 = time.perf_counter()
    pipe.run(frames[:2])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    phase("pipeline warm-up (2 frames)", t0)

    kernels.reset_counts()
    t0 = time.perf_counter()
    alphas, fgs, bgs = pipe.run(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.counts()
    phase("pipeline", t0)
    fps = N_FRAMES / dt
    print(f"  green 1080p -> 544x960, {N_FRAMES} frames: {fps:.2f} "
          f"frames/s; (calls, launches) {counts}", flush=True)
    for k, (_, n) in counts.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    check(alphas.shape == (N_FRAMES, 544, 960) and alphas.dtype == np.uint8,
          f"alphas {alphas.shape} {alphas.dtype}")
    check(fgs.shape == bgs.shape == (N_FRAMES, 544, 960, 3), "fg/bg shape")
    ious = []
    for a, gt in zip(alphas, gts):
        g = resize(torch.from_numpy(gt.astype(np.float32)), (544, 960),
                   "nearest").numpy() > 0
        p = a >= 128
        ious.append(float((g & p).sum() / max((g | p).sum(), 1)))
    print(f"  IoU with the synthetic ground truth: min {min(ious):.4f} "
          f"mean {np.mean(ious):.4f}", flush=True)
    check(min(ious) > 0.75, f"IoU with the ground truth {ious}")

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    host = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              device="cpu")
    h_alphas, _, _ = host.run(frames[:N_CPU_FRAMES])
    dmax, frac = within_bound(alphas[:N_CPU_FRAMES], h_alphas)
    phase(f"host run ({N_CPU_FRAMES} frames)", t0)
    print(f"  card vs host alphas: max |diff| {dmax}, |diff| > 1 on "
          f"{frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"card vs host alphas: max {dmax}, frac>1 {frac}")

    out = []
    for k, (calls, n) in counts.items():
        out.append(dict(name=k, route="cuda", launches=n, calls=calls,
                        library_ms=None, **rows[k]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": out}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
