#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--paths default|green_deeplab|iseg]

The default run reads weights/matting_unet.msgpack and weights/stm.msgpack
only, so that one copy of the repo holds it (the DeepLab and SCHP seeds
run on seeded weights). Phases, each printed with its
wall seconds:
  1. build the CUDA kernels of video_unscreen_tpu_torch/csrc (one nvcc call);
  2. build the green pipeline (configs/green.json with the chroma seed) at
     1080p -> 544x960 and load the MattingUNet weights
     (weights/matting_unet.msgpack); bg mode also needs weights/stm.msgpack
     (a missing weights file fails the run);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, and time both with CUDA events: K1 trimap and K2
     morph bit-exact at every call the paths make (`MORPH_CALLS` of
     `ops/kernels/morph_cases.py`: 544x960, 540x960, 272x480 and
     1080x1920, 303x540, 151x270; the cross, the 4x4, 5x5 and 7x7
     ellipses; 1 to 40 iterations), K2 in both directions, on a soft
     mask, all 255, all 0, hot corners, edge lines, a checkerboard and the
     call's batch (`MORPH_CALLS`: 8 planes, run_segmented's S, 24 for the
     fused bg regionfill's perimeter, 96 for bg_offline stage 2's 32
     frames x 3 channels), one launch a call, timed beside the same chain
     as F.max_pool2d calls (held bit-exact first), the green, fused bg and
     stage-2 calls also at their batch; K3 flood bit-exact (green's 272x480, bg's
     1080x1920; also on a checkerboard, a snake across every tile edge,
     the full and the empty mask, with its launches a call), K4 attention (the STM memory read, Lq 2040 x Lk
     22440, dk 128, dv 512, and one training read, Lq 64 x Lk 128) to
     rtol 1e-4 / atol 1e-5, with SDPA timed beside it as its yardstick,
     and K5 (dQ) and K6 (dK, dV), the read's backward, from a seeded dO
     at the training shape and at bg's shape with the STM mask, every key
     valid and no key valid: rtol 1e-4 / atol 1e-5, masked keys' dK and
     dV exactly 0, K5 and K6 deterministic, with the plain versions and
     SDPA's backward timed beside them; then the read as a train step
     makes it (8 items, one call each of K4, K5, K6, against SDPA on the
     same batch), the `--sizes 256` training read (8 items, Lq 256 x Lk
     512) and 3-item batches of ragged reads over every mask kind;
  4. run `FusedGreenPipeline.run` on 8 seeded synthetic 1080p green-screen
     frames (the BGR upload resized on the device, as in every phase
     before 5d: `DEV_RESIZE`) with every launch count reset just before,
     check that each kernel launched, the outputs (IoU with the synthetic
     ground truth > 0.75), and the frames per second;
  5. run the first 2 frames again on the host (device="cpu", the plain
     versions) and hold the card's alphas to the JAX suite's bound (this
     pipeline and phase 4's are float32: matting_dtype and seg_dtype set);
  5-eval. the evaluation protocol's device work (`pipeline/evaluate.py:
     score_pair` and `ops/metrics.py:roi_sad`) on phase 4's alphas,
     resized to 1080x1920, against their GTs, counts reset just before: K3
     11 calls a frame (4 launches a call), K2 2 (one launch each); K3
     bit-exact against plain on CONN's 11 intersections of frame 0; ms a
     scored frame beside the device time of K3's 11 calls; a 544x960
     prediction (the resize path) against the pre-resized pair to 1e-6;
     two components of equal area (the smaller label wins); card against
     host at 270x480 (2 frames and the tie), every score to 1e-4
     relative;
  5a. the DeepLab seed (DeepLabV3+ ResNet-50, grid and flip TTA: 12 crops
     of 513x513 at 544x960) at full width with seeded weights: its time in
     float32 and in bfloat16 beside its operation count (counted on the
     meta device) and bound, and the MattingUNet's at 544x960 likewise;
     card against host in float32 on a 320x480 frame at crop 257 (2x3
     overlapping locations and their flips, 12 crops, as 513 gives at
     544x960): scores to 1e-4, masks equal wherever |p_fg - p_bg| > 1e-3;
     bfloat16 scores finite;
  5b. the green path in bfloat16 (the pipeline's default) with the chroma
     seed on the same 8 frames, counts reset just before: IoU > 0.75 on
     every frame, alpha >= 128 masks agree with phase 4's on >= 99.99% of
     the pixels of every frame, frames/s;
  5c. `run_segmented` with S = 8 segments of 4 frames (32 frames), bfloat16
     and float32, counts reset just before the bfloat16 run: IoU > 0.75 on
     every frame, K1 one launch a step for the batch of 8, host syncs per
     frame against phase 5b's, frames/s; float32 segment 0 held to the
     sequential run of its frames within the JAX bound;
  5d. wire green: bench.py's configuration (bfloat16, `run_segmented` S = 8
     x 4 frames in chunks of 4, `wire="yuv420"`, the host resize to
     544x960) beside the BGR wire with the device resize on the same
     frames, in turns (bgr, yuv420, yuv420, bgr): frames/s, upload bytes a
     frame, IoU > 0.75 on every frame, K1-K3 launched; the streamed run
     (pinned double-buffered upload) bit-equal to a plain loop that
     uploads each step's I420 batch synchronously and calls
     `_step_batched`; float32 card against host on 2 frames, alpha, fg and
     bg within the JAX bound;
  5e. the modular green driver (`pipeline/green.py:run`) on the 8 frames
     at 1080p, counts reset just before: K1-K3 launched, IoU > 0.75 on
     every frame, frames/s over its stages;
  6. run bg mode (`pipeline/bg.py:run`, configs/bg.json with the chroma
     seed at 960) on the same 8 frames, counts reset just before: each of
     K1-K4 must launch, IoU with the ground truth > 0.8 on frame 0 and
     > 0.75 on average, frames/s over the 7 tracked frames;
  7. run bg mode on 2 smaller frames on the card and on the host and hold
     the alphas to the same bound;
  7a. K4 at the fused bg read (B = 1 and 8 segments, Lq 2040 over a ring
     bank of 2 slots plus the previous frame, Lk 6120, bank_n 0, 1, 2)
     against its plain version to rtol 1e-4 / atol 1e-5, timed beside SDPA
     and its bound over the valid keys;
  7b. fused bg (`pipeline/fused_bg.py:FusedBgPipeline.run`, configs/bg.json
     with the chroma seed; STM, matting and seed in bfloat16 as shipped,
     and in float32) on the 8 frames, counts reset just before the
     bfloat16 run: K1-K4 must launch, IoU > 0.8 on frame 0 and > 0.75 on
     average, alpha >= 128 masks of bfloat16 and float32 agree on
     BG_BF16_ALPHA_AGREE of every frame, frames/s and host syncs a frame;
     float32 card against host on 2 frames of 270x480 within the JAX bound;
  7c. fused bg `run_segmented` as bench.py runs bg (S = 8, chunks of 4, 64
     frames: 8-frame segments) in bfloat16, frames/s and the IoU bars; in
     float32 with pass 1 at full resolution, segment 0 against the
     sequential run of its frames within the JAX bound;
  7d. the SCHP seed at full width on seeded weights (544x960 -> 473x473)
     in float32 and bfloat16 (each in its shipped layout, `models/
     precision.py:net_input`), beside its operations (meta-device count)
     and bound; float32 card against host on
     a 270x480 frame (logits to 1e-4 of their scale, masks equal wherever
     the top-two margin > 1e-3); then 7c in bfloat16 with `binseg: human`
     on those weights: the seed's forwards and frames against the frames
     that were not tracking or ballooned (random SCHP masks change how
     often STM tracks: these frames/s are not the shipped weights');
  7e. wire fused bg: `FusedBgPipeline` in bfloat16, S = 8 x 8 frames in
     chunks of 4, the I420 wire and the host resize: frames/s, IoU > 0.8 on
     frame 0 and > 0.75 on average, K1-K4 launched; float32 card against
     host on 2 frames of 270x480 with the same wire;
  7f. disk, where libjpeg is on the machine (`runtime.codec_missing()`,
     decided before the phase; else one line says why it did not run): the
     8 frames written as JPEGs, then `tools/unscreen/green_torch.py` and
     `bg_torch.py` (`--fused --segments 8 --wire yuv420`) through their
     `main`: every artifact written, the decoded alphamasks within mean 8
     of the returned alphas, frames/s with the read and the write;
  10. bg_offline (`pipeline/bg_offline.py:run`, fused, chunks of 4;
     configs/bg.json with the chroma seed, the shipped MattingUNet and STM
     weights) on the 8 frames, stages 1, 2, 3, bfloat16 as shipped with
     the counts reset just before: K1-K4 launched, IoU mean > 0.6 (the
     JAX suite's bar for the mode), seconds a stage, stage 2's CG
     iterations, frames/s over the stages; the same in float32, alpha >=
     128 masks on BG_BF16_ALPHA_AGREE of every frame; stage 2 alone on 24
     frames with their ground-truth masks (a hole with a boundary) in
     chunks of 16: one K2 launch a chunk, CG iterations, card vs host at
     270x480 within 1 level; float32 card against host on 3 frames at
     270x480, fused (alphas and fg within the JAX bound, ema_seen equal,
     always_bg within 1) and modular (alphas and fg within the bound);
  10a. the replacement core (`pipeline/replace.py:compose_frames`) on
     phase 10's alphas and fgs brought to 1080p over a seeded background,
     with and without harmonization, ms a frame, float32 card against
     host within the bound (neither runs K1-K4: its box filter, shift and
     Lab toning were never TPU kernels); `BackgroundAgent.forward` with
     each method at 1080p (work 303x540), K2 launched, card against host
     within the bound, pcov's iterations equal;
  10b. where libjpeg is on the machine: `tools/unscreen/bg_offline_torch
     .py` stages 1,2,3 and then `--stages 3` (the store's resume) through
     `main`, then `tools/replace/replace_torch.py` on the store with and
     without `--harmonize`, every artifact written (both PNGs included);
     else one line says why it did not run;
  11. interactive segmentation on seeded weights: `ISegAgent` at its
     shipped input_long_side 800 with flip TTA on a 1080p frame, plain and
     BRS at each insertion point (after_aspp, after_c4, after_deeplab): ms
     a call, L-BFGS iterations, function evaluations and host syncs; card
     against host at input_long_side 320 (plain and one-step BRS
     probabilities within 1e-3 and masks on >= 99.9%, 20-step BRS masks
     on >= 99%); the MobileNetV2 DeepLab's logits at 513x513, card against
     host within 1e-4 |want| + 1e-4 max |want|;
  11a. the app protocol's scenario 3 (`tools/run_app_protocol_torch.py:
     run_stm_iseg`: STM from weights/stm.msgpack through a hard cut, the
     seeded ISeg re-seeding it, both scored), counts reset just before:
     K3 and K4 launched, the scores finite;
  8. train the STM 3 AdamW steps from weights/stm.msgpack at the trainer's
     defaults (batch 8, 128x128, clip_len 3, lr 5e-4) on the port's own
     synthetic clips, counts reset just before: every loss finite, K4, K5
     and K6 one call per step for the whole batch (K4 2 launches: the
     live-tile list and the kernel; K5 the kernel and the sum of its key
     splits; K6 1); the steps per second; then
     save with `save_stm` and read back with `load_stm` bit for bit;
  9. one train step on the card and the same step on the host (batch 2,
     64x64, clip_len 3): the loss to 1e-4 relative, the parameters and the
     BatchNorm statistics as `tests/test_torch_train_stm.py` holds the
     port to the JAX step.

Each path's K1 and K2 calls must be one launch each. Then it prints one
JSON line of per-kernel numbers, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without CUDA, or without the package
beside this file, it exits non-zero before printing any result.

`--paths green_deeplab` runs configs/green.json as shipped (the DeepLab
seed from weights/deeplab_binseg.msgpack, bfloat16) with the MattingUNet
weights, and needs no STM weights: the build, K1-K3 against their plain
versions, then 8 frames in bfloat16 and in float32 and `run_segmented`
with S = 8 (32 frames) in both: IoU > 0.75 on every frame, the seed run
exactly on the frames whose segment was not tracking (its forward and
frame counts against the tracking flags), bfloat16 against float32 on the
card (seed masks on >= 99.95% of the pixels, alpha >= 128 masks on
>= 99.99% of every frame),
float32 card against host on 2 frames of 270x480 (work 288x480) within the
JAX bound, frames/s and the seed's time with the shipped weights. It ends
with the same JSON lines (the kernels row for K1-K3).

`--paths iseg` reads weights/iseg.msgpack and no other weights file: K2
(with the roi_sad call) and K3 and K4 against their plain versions, phase
11 with the shipped weights, the click contract of tests/test_iseg.py:
64-96 (20 BRS steps at 128), the evaluation phase on the ISeg masks of
the 8 frames (two clicks a frame) against their GTs, and scenario 3 with
the shipped ISeg and seeded STM weights. Its kernels row lists K2-K4.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

try:  # beside the package; copied alone, main() refuses to run
    from video_unscreen_tpu_torch.utils.synthetic import (bg_config,
                                                          green_clip, iou,
                                                          soft_mask)
    from video_unscreen_tpu_torch.utils.timing import (
        ATTN_DK, ATTN_DV, ATTN_LQ, ATTN_SLOTS, BF16_OPS_PER_S, F32_OPS_PER_S,
        attn_bounds, bound, cuda_ms, net_flops, sdpa_bwd_ms, sdpa_fwd_ms)
except ImportError:
    pass

ROOT = Path(__file__).resolve().parent
FRAME_HW = (1080, 1920)
WORK_LONG_SIDE = 960
N_FRAMES = 8
N_CPU_FRAMES = 2
BG_HOST_HW = (270, 480)  # bg card-vs-host frames: the host's CG stays short
SEED = 0
# STM training at the trainer's defaults: 128x128 clips of 3 frames, so
# 8x8 queries against 2 memory frames (K5/K6's training shape)
TRAIN_BATCH, TRAIN_HW, TRAIN_CLIP, TRAIN_LR, TRAIN_STEPS = 8, 128, 3, 5e-4, 3
TRAIN_HOST = dict(batch=2, hw=64)  # the card-vs-host step
# fused bg: the ring bank of configs/bg.json (stm.fused_bank_capacity),
# run_segmented as bench.py runs bg (S = 8, chunks of 4) on 8-frame
# segments
FUSED_BANK, SEG_CHUNK, BG_SEG_FRAMES = 2, 4, 8
N_SEGMENTS, SEG_FRAMES = 8, 4   # run_segmented: bench.py's S, 4 frames each
DEEPLAB_HOST_HW, DEEPLAB_HOST_LONG = (270, 480), 480  # host DeepLab stays short
# the seed's card-vs-host frame and crop: 2x3 overlapping locations, each
# with its flip (12 crops), as the 513 crop gives at 544x960
SEED_GRID_HW, SEED_GRID_CROP = (320, 480), 257
# bfloat16 against float32 on the card: the least share of pixels on which
# the alpha >= 128 masks (and the seed masks) agree, on every frame
BF16_ALPHA_AGREE, BF16_SEED_AGREE = 0.9999, 0.9995
BG_BF16_ALPHA_AGREE = 0.997  # ~14x the share that differed when read
# bg_offline: the stage scans' chunk (bench.py's), the frames of the
# stage-2 run whose hole has a boundary (a pixel needs > 10 background
# frames) and its chunk, and the frames of the card-vs-host runs
BG_OFFLINE_CHUNK, STAGE2_FRAMES, STAGE2_CHUNK, N_OFFLINE_HOST = 4, 24, 16, 3
# the phases older than the wire phases upload BGR and resize on the device
# (the JAX pipelines' host_downscale=False), as when PERF.md's numbers of
# them were read; the wire phases run bench.py's host resize and I420
DEV_RESIZE = dict(host_downscale=False)
EVAL_HOST_HW = (270, 480)   # evaluation card-vs-host pairs: the host's
                            # plain labels stay short
ISEG_LONG, ISEG_HOST_LONG = 800, 320   # ISeg: shipped, card vs host
ISEG_MODES = ("after_aspp", "after_c4", "after_deeplab")
ISEG_MASK_AGREE = 0.999     # card vs host, plain and one-step BRS masks
ISEG_BRS20_AGREE = 0.99     # card vs host, 20-step BRS masks
EVAL_RTOL = 1e-4            # card vs host scores, relative


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f}s", flush=True)


def item_mask(name, lq, lk, rng):
    """The key masks the kernels are held on: the STM read's (an empty
    bank, the last frame valid), every key, one key, none, random, one
    live 64-key tile in the middle, only the last key."""
    import numpy as np
    m = np.zeros(lk, np.float32)
    if name == "stm":
        m[-lq:] = 1.0
    elif name == "all":
        m[:] = 1.0
    elif name == "one":
        m[lk // 3] = 1.0
    elif name == "random":
        m = (rng.rand(lk) > 0.5).astype(np.float32)
    elif name == "mid_tile":
        mid = (-(-lk // 64)) // 2 * 64
        m[mid:mid + 64] = 1.0
    elif name == "last_key":
        m[-1] = 1.0
    return m


def held_close(what, got, want, atol=1e-5):
    """|got - want| <= atol + 1e-4 |want| everywhere (the card checks'
    tolerance); returns (max |diff|, max |diff| / max |want|)."""
    d = (got - want).abs()
    check(bool((d <= atol + 1e-4 * want.abs()).all()),
          f"{what}: max |diff| {float(d.max())}")
    return float(d.max()), float(d.max() / want.abs().max().clamp_min(1e-30))


def held_bwd(what, got, want, mask, dout, v):
    """dQ, dK, dV of one item held as tests/test_torch_kernels_cuda.py
    holds them: where a single key is valid the exact dQ and dK are 0 and
    both versions return rounding noise, held to 1e-5 of |dO V^T|; masked
    keys' dK and dV exactly 0; with no valid key every gradient 0."""
    n_valid = int((mask > 0).sum())
    noise = 1.0
    if n_valid == 1:
        noise = max(1.0, float((dout @ v[mask > 0].T).abs().max()))
    errs = [held_close(f"{what} {name}", g, t, atol)
            for name, g, t, atol in zip(("dQ", "dK", "dV"), got, want,
                                        (1e-5 * noise,) * 2 + (1e-5,))]
    dead = mask <= 0
    check(not got[1][dead].any() and not got[2][dead].any(),
          f"{what}: a masked key's dK or dV is not 0")
    if n_valid == 0:
        check(not any(g.any() for g in got),
              f"{what}: no valid key must give 0")
    # relative to |want| only where the exact gradient is not 0
    exact = errs[2:] if n_valid == 1 else errs
    return max(e[0] for e in errs), max(e[1] for e in exact)


def pool_chain(x, se, iters, dilate):
    """The same chain as F.max_pool2d calls: the library yardstick, which
    the port never calls. A step of the 5-point cross is the max of a 1x3
    and a 3x1 pool at stride 1 (their -inf padding is dilation's border;
    both hold the anchor); the 4x4 ellipse (a cross around (-1, -1) and
    the anchor) pads two rows and columns of -inf above and left, pools,
    and takes the max with the anchor; a larger odd ellipse is the max
    over its rows of a centred 1 x (2r + 1) pool shifted by the row's dy
    (-inf shifted in); erosion is -max_pool2d(-x). Returns (result,
    PyTorch calls)."""
    import torch
    import torch.nn.functional as F
    from video_unscreen_tpu_torch.ops.kernels.morph_cases import se_offsets
    y = (x if dilate else -x)[None]
    h, w = x.shape[-2:]
    calls = 0 if dilate else 2
    rows = {}
    for dy, dx in se_offsets(se):
        rows[dy] = max(rows.get(dy, 0), abs(dx))
    for _ in range(iters):
        if se == "ellipse4":
            p = F.pad(y, (2, 0, 2, 0), value=float("-inf"))
            row = F.max_pool2d(p, (1, 3), stride=1)[..., 1:h + 1, :]
            col = F.max_pool2d(p, (3, 1), stride=1)[..., :, 1:w + 1]
            y = torch.maximum(torch.maximum(y, row), col)
            calls += 5
        elif se in ("ellipse3", "cross3"):
            y = torch.maximum(F.max_pool2d(y, (1, 3), stride=1,
                                           padding=(0, 1)),
                              F.max_pool2d(y, (3, 1), stride=1,
                                           padding=(1, 0)))
            calls += 3
        else:
            reach = max(rows)
            acc = None
            for dy, r in sorted(rows.items()):
                pooled = (F.max_pool2d(y, (1, 2 * r + 1), stride=1,
                                       padding=(0, r)) if r else y)
                # out[i] = pooled[i + dy], -inf beyond the border
                p = F.pad(pooled, (0, 0, reach, reach), value=float("-inf"))
                shifted = p[..., reach + dy:reach + dy + h, :]
                acc = shifted if acc is None else torch.maximum(acc, shifted)
                calls += 3 + (1 if r else 0)
            y = acc
    return (y[0] if dilate else -y[0]), calls


def pool_trimap(x, se, iters):
    """K1's select over the two pool chains; (result, PyTorch calls)."""
    import torch
    dil, n_d = pool_chain(x, se, iters, True)
    ero, n_e = pool_chain(x, se, iters, False)
    tri = torch.where(ero > 127.0, 255.0, torch.full_like(x, 128.0))
    return torch.where(dil < 128.0, 0.0, tri), n_d + n_e + 5


def morph_phase(device):
    """K1 and K2 at every call the paths make: bit-exact against the plain
    versions (K2 in both directions) on a soft mask, the hard masks and
    the call's batch (`MORPH_CALLS`: run_segmented's (S, H, W) calls, the
    fused bg regionfill's (3S, h, w), bg_offline stage 2's (32 x 3, H,
    W)), one launch a call; then timed beside the plain version and the
    max_pool2d chain (itself held bit-exact first), and the green, fused
    bg and stage-2 calls also at their batch. Returns the rows of K1 and
    K2."""
    import torch
    from video_unscreen_tpu_torch.ops.kernels import morph as km
    from video_unscreen_tpu_torch.ops.kernels.morph_cases import (
        MORPH_CALLS, MORPH_HARD_MASKS, morph_hard_mask, se_offsets)

    def run(kernel, x, offs, iters, dil):
        if kernel == "trimap":
            return km.trimap(x, offs, iters), km.trimap_plain(x, offs, iters)
        return (km.morph(x, offs, iters, dil),
                km.morph_plain(x, offs, iters, dil))

    rows = {k: dict(source="video_unscreen_tpu_torch/csrc/morph.cu",
                    replaces=f"video_unscreen_tpu/ops/pallas/morph.py:{ln}",
                    max_abs_err=0.0, by_call=[])
            for k, ln in (("trimap", 80), ("morph", 89))}
    n_checked = 0
    for i, (kernel, caller, (h, w), se, iters, n_batch) in enumerate(
            MORPH_CALLS):
        offs = se_offsets(se)
        counter = km.TRIMAP if kernel == "trimap" else km.MORPH
        soft = torch.from_numpy(soft_mask(h, w, SEED + 10 + i)).to(device)
        hard = [torch.from_numpy(morph_hard_mask(n, h, w)).to(device)
                for n in MORPH_HARD_MASKS]
        # the call's batch: the soft mask, the hard masks and more soft
        # masks
        batch = torch.stack([soft, *hard] + [
            torch.from_numpy(soft_mask(h, w, SEED + 100 * j + i)).to(device)
            for j in range(n_batch - 1 - len(hard))])
        before = (counter.calls, counter.launches)
        for x in [soft, *hard, batch]:
            for dil in ((True,) if kernel == "trimap" else (True, False)):
                got, want = run(kernel, x, offs, iters, dil)
                check(got.shape == want.shape and torch.equal(got, want),
                      f"{kernel} {caller} {tuple(x.shape)} dilate={dil}: "
                      f"differs from plain by "
                      f"{float((got - want).abs().max())}")
                n_checked += 1
        calls = counter.calls - before[0]
        launches = (counter.launches - before[1]) / calls
        check(launches == 1, f"{kernel} {caller}: {launches} launches a "
              f"call, want 1")
        # the yardstick, held to the plain version before it is timed
        if kernel == "trimap":
            lib_fn = lambda: pool_trimap(soft, se, iters)
            want = km.trimap_plain(soft, offs, iters)
        else:
            lib_fn = lambda: pool_chain(soft, se, iters, True)
            want = km.morph_plain(soft, offs, iters, True)
        got, n_lib = lib_fn()
        check(torch.equal(got, want), f"max_pool2d chain {caller}: differs "
              f"from plain by {float((got - want).abs().max())}")
        if kernel == "trimap":
            fn = lambda: km.trimap(soft, offs, iters)
            plain_fn = lambda: km.trimap_plain(soft, offs, iters)
        else:
            fn = lambda: km.morph(soft, offs, iters, True)
            plain_fn = lambda: km.morph_plain(soft, offs, iters, True)
        ms = cuda_ms(fn, 200)
        plain = cuda_ms(plain_fn, 2 if iters > 10 else 5, rounds=3)
        lib = cuda_ms(lambda: lib_fn()[0], 5 if iters > 10 else 20,
                      rounds=3)
        n_nb = len([o for o in offs if o != (0, 0)])
        chains = 2 if kernel == "trimap" else 1
        b, by = bound(2 * h * w * 4,
                      h * w * (chains * iters * n_nb + 2 * (chains - 1)))
        entry = dict(caller=caller, shape=[h, w], se=se, iters=iters,
                     launches_per_call=launches, ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, pool_chain_ms=lib,
                     pool_chain_calls=n_lib)
        rows[kernel]["by_call"].append(entry)
        print(f"  K{1 if kernel == 'trimap' else 2} {kernel} {h}x{w} {se} "
              f"iters={iters} ({caller}): {ms:.4f} ms, {launches:g} launch a "
              f"call (plain {plain:.4f} ms, max_pool2d chain of {n_lib} "
              f"calls {lib:.4f} ms, bound {b:.5f} ms by {by})", flush=True)
        # run_segmented's batches, and bg_offline stage 2's
        if caller.startswith(("green", "fused bg", "bg_offline stage 2 mask")):
            if kernel == "trimap":
                fn = lambda: km.trimap(batch, offs, iters)
                plain_fn = lambda: km.trimap_plain(batch, offs, iters)
                lib_b = lambda: pool_trimap(batch, se, iters)[0]
            else:
                fn = lambda: km.morph(batch, offs, iters, True)
                plain_fn = lambda: km.morph_plain(batch, offs, iters, True)
                lib_b = lambda: pool_chain(batch, se, iters, True)[0]
            n_b = batch.shape[0]
            entry.update(batch=n_b, batch_ms=cuda_ms(fn, 50 if n_b < 64
                                                     else 10),
                         batch_plain_ms=cuda_ms(plain_fn, 1, rounds=3),
                         batch_pool_chain_ms=cuda_ms(lib_b, 2, rounds=3),
                         batch_bound_ms=n_b * b)
            print(f"    at batch {n_b}: {entry['batch_ms']:.4f} ms, 1 "
                  f"launch (plain {entry['batch_plain_ms']:.4f} ms, "
                  f"max_pool2d chain {entry['batch_pool_chain_ms']:.4f} ms, "
                  f"bound {entry['batch_bound_ms']:.5f} ms by {by})",
                  flush=True)
    # chains longer than the paths run, untimed: K1 at 20 iterations (6
    # rows a thread) and 60 (a K2 head of 20, then the fused launch), K2 at
    # 60 (two launches)
    soft = torch.from_numpy(soft_mask(544, 960, SEED)).to(device)
    offs = se_offsets("ellipse3")
    for kernel, iters in (("trimap", 20), ("trimap", 60), ("morph", 60)):
        for dil in ((True,) if kernel == "trimap" else (True, False)):
            got, want = run(kernel, soft, offs, iters, dil)
            check(got.shape == want.shape and torch.equal(got, want),
                  f"{kernel} iters={iters} dilate={dil}: differs from "
                  f"plain by {float((got - want).abs().max())}")
            n_checked += 1
    for k in rows:  # the main numbers: green's trimap and its it2 chain
        main = rows[k]["by_call"][0]
        rows[k].update(ms=main["ms"], plain_ms=main["plain_ms"],
                       bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                       pool_chain_ms=main["pool_chain_ms"],
                       pool_chain_calls=main["pool_chain_calls"])
    print(f"  K1, K2: bit-exact in {n_checked} checks (the soft mask, "
          f"{', '.join(MORPH_HARD_MASKS)} and the call's batch at each "
          f"call; "
          f"K1 iters 20 and 60, K2 iters 60 on the soft mask)", flush=True)
    return rows


def kernel_phase(device):
    """K3 against its plain version on the card; returns rows."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import connected as kcc
    from video_unscreen_tpu_torch.ops.kernels.cc_masks import (HARD_MASKS,
                                                             hard_mask)

    h, w = 544, 960
    rows = {}

    def held(name, got, want):
        check(all(g.shape == t.shape and g.dtype == t.dtype
                  for g, t in zip(got, want)), f"{name}: shape/dtype")
        err = max(float((g.double() - t.double()).abs().max())
                  for g, t in zip(got, want))
        check(err == 0.0, f"{name}: kernel differs from plain by {err}")
        return err

    # K3: flood at 272x480 (object removal labels at work/2)
    hh, ww = h // 2, w // 2
    rng = np.random.RandomState(SEED)
    cases = [(soft_mask(hh, ww, SEED + 1) > 120).astype(np.float32) * 255,
             (rng.rand(hh, ww) < 0.45).astype(np.float32) * 255,
             (rng.rand(hh, ww) < 0.6).astype(np.float32) * 255]
    cases += [hard_mask(n, hh, ww) for n in HARD_MASKS]
    err = 0.0
    for i, c in enumerate(cases):
        m = torch.from_numpy(c).to(device)
        before = kcc.FLOOD.launches
        err = max(err, held(f"flood case {i}",
                            kcc.connected_components_compact(m),
                            kcc.cc_plain(m)))
        launches = kcc.FLOOD.launches - before
    m = torch.from_numpy(cases[0]).to(device)
    ms = cuda_ms(lambda: kcc.connected_components_compact(m), 200)
    plain = cuda_ms(lambda: kcc.cc_plain(m), 2, rounds=3)
    b, by = bound(hh * ww * (4 + 4 + 4), hh * ww * 2)
    rows["flood"] = dict(
        source="video_unscreen_tpu_torch/csrc/flood.cu",
        replaces="video_unscreen_tpu/ops/pallas/flood.py:102",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    print(f"  K3 flood 272x480: {ms:.4f} ms (plain {plain:.4f} ms, bound "
          f"{b:.4f} ms), {launches} launches a call; bit-exact on "
          f"{len(cases)} masks (3 seeded, {', '.join(HARD_MASKS)})",
          flush=True)
    return rows


def bg_kernel_phase(device, rows):
    """K3 at bg mode's full-resolution shape, and K4, against their plain
    versions; adds to `rows`."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka
    from video_unscreen_tpu_torch.ops.kernels import connected as kcc
    from video_unscreen_tpu_torch.ops.kernels.cc_masks import (HARD_MASKS,
                                                             hard_mask)

    h, w = FRAME_HW
    # K3: object removal's labels at 1080x1920
    rng = np.random.RandomState(SEED + 3)
    cases = [(soft_mask(h, w, SEED + 4) > 120).astype(np.float32) * 255,
             (rng.rand(h, w) < 0.45).astype(np.float32) * 255]
    cases += [hard_mask(n, h, w) for n in HARD_MASKS]
    for i, c in enumerate(cases):
        m = torch.from_numpy(c).to(device)
        before = kcc.FLOOD.launches
        for g, t in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
            check(torch.equal(g, t), f"flood 1080p case {i} differs")
        launches = kcc.FLOOD.launches - before
    m = torch.from_numpy(cases[0]).to(device)
    ms = cuda_ms(lambda: kcc.connected_components_compact(m), 50)
    plain = cuda_ms(lambda: kcc.cc_plain(m), 1, rounds=3)
    b, by = bound(h * w * 12, h * w * 2)
    rows["flood"]["bg_1080x1920"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                         bound_by=by)
    rows["flood"]["launches_per_call"] = launches
    print(f"  K3 flood 1080x1920: {ms:.4f} ms (plain {plain:.4f} ms, bound "
          f"{b:.4f} ms), {launches} launches a call; bit-exact on "
          f"{len(cases)} masks (2 seeded, {', '.join(HARD_MASKS)})",
          flush=True)

    # K4: the STM memory read; the modular bg path passes two frames, so
    # the bank is empty and only the last slot's keys are valid
    lq, lk, dk, dv = ATTN_LQ, ATTN_SLOTS * ATTN_LQ, ATTN_DK, ATTN_DV
    rng = np.random.RandomState(SEED + 5)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
               for s in ((lq, dk), (lk, dk), (lk, dv)))
    masks = {"stm": torch.zeros(lk, device=device),
             "all": torch.ones(lk, device=device),
             "none": torch.zeros(lk, device=device)}
    masks["stm"][-lq:] = 1.0
    err = rel = 0.0
    for name, mk in masks.items():
        out, lse = ka.masked_memory_attention(q, k, v, mk)
        for g, t in zip((out, lse), ka.attention_plain(q, k, v, mk)):
            e = held_close(f"attention mask={name}", g, t)
            err, rel = max(err, e[0]), max(rel, e[1])
        if name == "none":
            check(not out.any() and not lse.any(), "attention: no valid key "
                  "must give 0")
    mk = masks["stm"]
    ms = cuda_ms(lambda: ka.masked_memory_attention(q, k, v, mk), 50)
    ms_all = cuda_ms(lambda: ka.masked_memory_attention(q, k, v,
                                                        masks["all"]), 20)
    plain = cuda_ms(lambda: ka.attention_plain(q, k, v, mk), 5)
    lib = sdpa_fwd_ms(q, k, v, mk, 5)
    lib_all = sdpa_fwd_ms(q, k, v, masks["all"], 5)
    # the least work this input needs: the valid keys only
    n_valid = int(mk.sum())
    bd = attn_bounds("fwd", 1, lq, lk, n_valid, dk, dv)
    bd_all = attn_bounds("fwd", 1, lq, lk, lk, dk, dv)

    # K4 at the training shape: one read (Lq 64, Lk 128, every key valid)
    tq = (TRAIN_HW // 16) ** 2
    tk = (TRAIN_CLIP - 1) * tq
    qt, kt, vt = q[:tq].contiguous(), k[:tk].contiguous(), v[:tk].contiguous()
    mt = torch.ones(tk, device=device)
    for g, t in zip(ka.masked_memory_attention(qt, kt, vt, mt),
                    ka.attention_plain(qt, kt, vt, mt)):
        e = held_close("attention training shape", g, t)
        err, rel = max(err, e[0]), max(rel, e[1])
    ms_t = cuda_ms(lambda: ka.masked_memory_attention(qt, kt, vt, mt), 200)
    plain_t = cuda_ms(lambda: ka.attention_plain(qt, kt, vt, mt), 50)
    lib_t = sdpa_fwd_ms(qt, kt, vt, mt, 50)
    bd_t = attn_bounds("fwd", 1, tq, tk, tk, dk, dv)
    rows["attention"] = dict(
        source="video_unscreen_tpu_torch/csrc/attention.cu",
        replaces="video_unscreen_tpu/ops/pallas/attention.py:32",
        max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain,
        bound_ms=bd["3xtf32"][0], bound_by=bd["3xtf32"][1],
        bound_f32_ms=bd["f32"][0], library_ms=lib,
        all_valid=dict(ms=ms_all, bound_ms=bd_all["3xtf32"][0],
                       bound_f32_ms=bd_all["f32"][0], library_ms=lib_all),
        train_shape=dict(ms=ms_t, plain_ms=plain_t,
                         bound_ms=bd_t["3xtf32"][0],
                         bound_f32_ms=bd_t["f32"][0], library_ms=lib_t))
    print(f"  K4 attention Lq {lq} Lk {lk} dk {dk} dv {dv}, {n_valid} valid "
          f"keys: {ms:.4f} ms (plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
          f"bound {bd['3xtf32'][0]:.4f} ms at 3xTF32 / {bd['f32'][0]:.4f} "
          f"ms at f32 over the valid keys); all keys valid: {ms_all:.4f} ms "
          f"(SDPA {lib_all:.4f} ms, bound {bd_all['3xtf32'][0]:.4f} / "
          f"{bd_all['f32'][0]:.4f} ms); training shape (Lq {tq}, Lk {tk}): "
          f"{ms_t:.4f} ms (plain {plain_t:.4f} ms, SDPA {lib_t:.4f} ms, "
          f"bound {bd_t['3xtf32'][0]:.5f} / {bd_t['f32'][0]:.5f} ms); max "
          f"|diff| {err:.3g} (relative {rel:.3g})", flush=True)


def attention_bwd_phase(device, rows):
    """K5 and K6 against the plain backward at the training shape (one
    item) and at bg's shape; adds their rows' numbers of those shapes."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka

    rng = np.random.RandomState(SEED + 6)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device)

    dk, dv = ATTN_DK, ATTN_DV
    tq = (TRAIN_HW // 16) ** 2
    tk = (TRAIN_CLIP - 1) * tq
    lq, lk = ATTN_LQ, ATTN_SLOTS * ATTN_LQ
    q, k, v, do = randn(lq, dk), randn(lk, dk), randn(lk, dv), randn(lq, dv)
    stm = torch.zeros(lk, device=device)
    stm[-lq:] = 1.0
    cases = {"train": (randn(tq, dk), randn(tk, dk), randn(tk, dv),
                       torch.ones(tk, device=device), randn(tq, dv)),
             "stm": (q, k, v, stm, do),
             "all": (q, k, v, torch.ones(lk, device=device), do),
             "none": (q, k, v, torch.zeros(lk, device=device), do)}
    err = rel = 0.0
    args = {}
    for name, (q_, k_, v_, m_, do_) in cases.items():
        out, lse = ka.attention_plain(q_, k_, v_, m_)
        delta = (do_ * out).sum(dim=1)
        args[name] = (q_, k_, v_, m_, do_, lse, delta)
        got = (ka.attention_bwd_dq(*args[name]),
               *ka.attention_bwd_dkv(*args[name]))
        want = ka.attention_bwd_plain(q_, k_, v_, m_, out, lse, do_)
        e = held_bwd(f"attention backward mask={name}", got, want, m_, do_,
                     v_)
        err, rel = max(err, e[0]), max(rel, e[1])
    first = ka.attention_bwd_dq(*args["all"])
    check(torch.equal(first, ka.attention_bwd_dq(*args["all"])),
          "attention dQ: two calls differ")
    first = ka.attention_bwd_dkv(*args["all"])
    check(all(torch.equal(a, b) for a, b in zip(
        first, ka.attention_bwd_dkv(*args["all"]))),
          "attention dK/dV: two calls differ")

    times = {}
    for name, reps in (("train", 200), ("stm", 50), ("all", 5),
                       ("none", 200)):
        a = args[name]
        times[name] = (cuda_ms(lambda: ka.attention_bwd_dq(*a), reps),
                       cuda_ms(lambda: ka.attention_bwd_dkv(*a), reps))
    plain = {name: (cuda_ms(lambda: ka.attention_bwd_dq_plain(*args[name]),
                            reps, rounds=3),
                    cuda_ms(lambda: ka.attention_bwd_dkv_plain(*args[name]),
                            reps, rounds=3))
             for name, reps in (("train", 50), ("stm", 3))}
    lib = {name: sdpa_bwd_ms(*cases[name], reps)
           for name, reps in (("train", 50), ("stm", 3), ("all", 3))}
    n_valid = int(stm.sum())
    for i, (key, line) in enumerate((("attention_bwd_dq", "75"),
                                     ("attention_bwd_dkv", "106"))):
        kind = "dq" if i == 0 else "dkv"
        b_t = attn_bounds(kind, 1, tq, tk, tk, dk, dv)
        b_s = attn_bounds(kind, 1, lq, lk, n_valid, dk, dv)
        b_a = attn_bounds(kind, 1, lq, lk, lk, dk, dv)
        rows[key] = dict(
            source="video_unscreen_tpu_torch/csrc/attention.cu",
            replaces=f"video_unscreen_tpu/ops/pallas/attention.py:{line}",
            max_abs_err=err, max_rel_err=rel,
            train_shape=dict(ms=times["train"][i],
                             plain_ms=plain["train"][i],
                             bound_f32_ms=b_t["f32"][0],
                             bound_3xtf32_ms=b_t["3xtf32"][0],
                             library_ms=lib["train"]),
            bg_shape=dict(ms=times["stm"][i], plain_ms=plain["stm"][i],
                          bound_ms=b_s["3xtf32"][0],
                          bound_by=b_s["3xtf32"][1],
                          bound_f32_ms=b_s["f32"][0],
                          bound_3xtf32_ms=b_s["3xtf32"][0],
                          library_ms=lib["stm"],
                          all_valid_ms=times["all"][i],
                          all_valid_bound_f32_ms=b_a["f32"][0],
                          all_valid_bound_3xtf32_ms=b_a["3xtf32"][0],
                          all_valid_bound_ms=b_a["3xtf32"][0],
                          all_valid_library_ms=lib["all"],
                          no_valid_ms=times["none"][i]))
        if kind == "dkv":
            rows[key]["bg_shape"].update(
                bound_fma_tc_ms=b_s["fma_tc"][0],
                all_valid_bound_fma_tc_ms=b_a["fma_tc"][0])
        print(f"  K{5 + i} attention backward {kind}: training shape (Lq "
              f"{tq}, Lk {tk}): {times['train'][i]:.4f} ms (plain "
              f"{plain['train'][i]:.4f} ms, SDPA backward {lib['train']:.4f} "
              f"ms, bound {b_t['3xtf32'][0]:.5f} ms at 3xTF32 / "
              f"{b_t['f32'][0]:.5f} ms at f32); bg shape (Lq {lq}, Lk {lk}), "
              f"{n_valid} valid keys: {times['stm'][i]:.4f} ms (plain "
              f"{plain['stm'][i]:.4f} ms, SDPA backward {lib['stm']:.4f} ms, "
              f"bound {b_s['3xtf32'][0]:.4f} / {b_s['f32'][0]:.4f} ms over "
              f"the valid keys); all keys valid: {times['all'][i]:.4f} ms "
              f"(SDPA backward {lib['all']:.4f} ms, bound "
              f"{b_a['3xtf32'][0]:.4f} / {b_a['f32'][0]:.4f} ms"
              + (f"; {b_a['fma_tc'][0]:.4f} ms at this kernel's FMA/tensor-"
                 f"core split" if kind == "dkv" else "") + "); no valid "
              f"key: {times['none'][i]:.4f} ms; max |diff| {err:.3g} "
              f"(relative {rel:.3g})", flush=True)


def train_read_phase(device, rows):
    """The read as a train step makes it, one call each of K4, K5 and K6
    on the batch (8 items of Lq 64 over Lk 128, every key valid), against
    the batched plain versions and SDPA on the same (8, 1, Lq, d) batch:
    this sets the K4-K6 rows' main numbers. Then batched ragged reads (3
    items, mask kinds cycling) of K4, K5 and K6 against the plain ones."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    dk, dv, b = ATTN_DK, ATTN_DV, TRAIN_BATCH
    tq = (TRAIN_HW // 16) ** 2
    tk = (TRAIN_CLIP - 1) * tq

    def read(n_b, lq, lk, dk_, dv_):
        return [torch.randn(*s, generator=gen, device=device)
                for s in ((n_b, lq, dk_), (n_b, lk, dk_), (n_b, lk, dv_),
                          (n_b, lq, dv_))]

    q, k, v, do = read(b, tq, tk, dk, dv)
    mask = torch.ones(b, tk, device=device)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    errs = [held_close("batched training read out", out, want_out),
            held_close("batched training read lse", lse, want_lse)]
    delta = (do * want_out).sum(dim=-1)
    a = (q, k, v, mask, do, want_lse, delta)
    got = (ka.attention_bwd_dq(*a), *ka.attention_bwd_dkv(*a))
    want = ka.attention_bwd_plain(q, k, v, mask, want_out, want_lse, do)
    errs += [held_bwd(f"batched training read item {i}",
                      [g[i] for g in got], [w[i] for w in want], mask[i],
                      do[i], v[i]) for i in range(b)]

    # batched ragged reads: every mask kind, Lq and Lk not tile multiples
    kinds = ["stm", "all", "one", "none", "random", "mid_tile", "last_key"]
    rng = np.random.RandomState(SEED + 8)
    for shape in ((200, 600, 128, 512), (37, 70, 64, 36)):
        for first in (0, 3, 6):
            names = [kinds[(first + i) % len(kinds)] for i in range(3)]
            qr, kr, vr, dr = read(3, *shape)
            mr = torch.from_numpy(np.stack([item_mask(n, *shape[:2], rng)
                                            for n in names])).to(device)
            o, l_ = ka.masked_memory_attention(qr, kr, vr, mr)
            wo, wl = ka.attention_plain(qr, kr, vr, mr)
            errs += [held_close(f"ragged read {shape} {names} out", o, wo),
                     held_close(f"ragged read {shape} {names} lse", l_, wl)]
            for i, n in enumerate(names):
                if n == "none":
                    check(not o[i].any() and not l_[i].any(),
                          "ragged read: no valid key must give 0")
            ar = (qr, kr, vr, mr, dr, wl, (dr * wo).sum(dim=-1))
            gr = (ka.attention_bwd_dq(*ar), *ka.attention_bwd_dkv(*ar))
            wr = ka.attention_bwd_plain(qr, kr, vr, mr, wo, wl, dr)
            errs += [held_bwd(f"ragged read {shape} {names[i]}",
                              [g[i] for g in gr], [w[i] for w in wr],
                              mr[i], dr[i], vr[i]) for i in range(3)]
    # the `--sizes 256` training read: 256x256 clips of 3 frames, so Lq
    # 256 over Lk 512, every key valid
    sq = (256 // 16) ** 2
    sk = (TRAIN_CLIP - 1) * sq
    q2, k2, v2, do2 = read(b, sq, sk, dk, dv)
    m2 = torch.ones(b, sk, device=device)
    wo2, wl2 = ka.attention_plain(q2, k2, v2, m2)
    a2 = (q2, k2, v2, m2, do2, wl2, (do2 * wo2).sum(dim=-1))
    got2 = (ka.attention_bwd_dq(*a2), *ka.attention_bwd_dkv(*a2))
    want2 = ka.attention_bwd_plain(q2, k2, v2, m2, wo2, wl2, do2)
    errs += [held_bwd(f"--sizes 256 read item {i}", [g[i] for g in got2],
                      [w[i] for w in want2], m2[i], do2[i], v2[i])
             for i in range(b)]
    for a_ in (a, a2):
        check(all(torch.equal(x, y) for x, y in zip(
            ka.attention_bwd_dkv(*a_), ka.attention_bwd_dkv(*a_))),
              "attention dK/dV on a training batch: two calls differ")
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)

    sdpa2 = sdpa_bwd_ms(q2, k2, v2, m2, do2, 50)
    for key, kind, fn, plain_fn in (
            ("attention_bwd_dq", "dq", ka.attention_bwd_dq,
             ka.attention_bwd_dq_plain),
            ("attention_bwd_dkv", "dkv", ka.attention_bwd_dkv,
             ka.attention_bwd_dkv_plain)):
        ms = cuda_ms(lambda: fn(*a2), 100)
        plain = cuda_ms(lambda: plain_fn(*a2), 20)
        bd = attn_bounds(kind, b, sq, sk, sk, dk, dv)
        rows[key]["sizes256"] = dict(
            ms=ms, plain_ms=plain, bound_ms=bd["3xtf32"][0],
            bound_f32_ms=bd["f32"][0], bound_3xtf32_ms=bd["3xtf32"][0],
            library_ms=sdpa2)
        if kind == "dkv":
            rows[key]["sizes256"]["bound_fma_tc_ms"] = bd["fma_tc"][0]
        print(f"  {key} on the --sizes 256 training read ({b} x Lq {sq}, Lk "
              f"{sk}), one call: {ms:.4f} ms (plain {plain:.4f} ms, SDPA "
              f"backward {sdpa2:.4f} ms, bound {bd['3xtf32'][0]:.5f} ms at "
              f"3xTF32 / {bd['f32'][0]:.5f} ms at f32)", flush=True)

    sdpa_bwd = sdpa_bwd_ms(q, k, v, mask, do, 50)  # dQ, dK and dV
    times = {
        "attention": (cuda_ms(lambda: ka.masked_memory_attention(
            q, k, v, mask), 200), cuda_ms(lambda: ka.attention_plain(
                q, k, v, mask), 50), sdpa_fwd_ms(q, k, v, mask, 50)),
        "attention_bwd_dq": (cuda_ms(lambda: ka.attention_bwd_dq(*a), 200),
                             cuda_ms(lambda: ka.attention_bwd_dq_plain(*a),
                                     50), sdpa_bwd),
        "attention_bwd_dkv": (cuda_ms(lambda: ka.attention_bwd_dkv(*a), 200),
                              cuda_ms(lambda: ka.attention_bwd_dkv_plain(*a),
                                      50), sdpa_bwd)}
    for key, kind in (("attention", "fwd"), ("attention_bwd_dq", "dq"),
                      ("attention_bwd_dkv", "dkv")):
        ms, plain, lib = times[key]
        bd = attn_bounds(kind, b, tq, tk, tk, dk, dv)
        row = dict(ms=ms, plain_ms=plain, bound_ms=bd["3xtf32"][0],
                   bound_by=bd["3xtf32"][1], bound_f32_ms=bd["f32"][0],
                   bound_3xtf32_ms=bd["3xtf32"][0], library_ms=lib)
        if kind == "dkv":
            row["bound_fma_tc_ms"] = bd["fma_tc"][0]
        if key == "attention":   # the bg read stays K4's main number
            rows[key]["train_batch"] = row
        else:
            rows[key].update(row)
            rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
            rows[key]["max_rel_err"] = max(rows[key]["max_rel_err"], rel)
        print(f"  {key} on the training batch ({b} x Lq {tq}, Lk {tk}), "
              f"one call: {ms:.4f} ms (plain {plain:.4f} ms, SDPA "
              f"{'forward' if kind == 'fwd' else 'backward'} {lib:.4f} ms, "
              f"bound {bd['3xtf32'][0]:.5f} ms at 3xTF32 / "
              f"{bd['f32'][0]:.5f} ms at f32)", flush=True)
    rows["attention"]["max_abs_err"] = max(rows["attention"]["max_abs_err"],
                                           err)
    rows["attention"]["max_rel_err"] = max(rows["attention"]["max_rel_err"],
                                           rel)
    print(f"  batched reads (training batch, ragged 3-item batches): max "
          f"|diff| {err:.3g} (relative {rel:.3g})", flush=True)


def train_phases(stm_weights):
    """STM training on the card, then one step on the card against the
    same step on the host; returns the training path's kernel counts."""
    import tempfile

    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.ops.kernels import attention as ka
    from video_unscreen_tpu_torch.parallel import train_stm as ts
    from video_unscreen_tpu_torch.utils.checkpoint import load_stm, save_stm

    model = ts.make_stm_train_state("cuda", init_from=str(stm_weights))
    step = ts.make_stm_train_step(model, *ts.make_optimizer(
        model, TRAIN_LR, TRAIN_STEPS))
    rng = np.random.RandomState(SEED)
    batches = [ts.make_clip_batch(rng, TRAIN_BATCH, (TRAIN_HW, TRAIN_HW),
                                  TRAIN_CLIP) for _ in range(TRAIN_STEPS)]
    read = ("attention", "attention_bwd_dq", "attention_bwd_dkv")
    kernels.reset_counts()
    t0 = time.perf_counter()
    losses, secs, per_step = [], [], []
    for batch in batches:
        before = kernels.counts()
        t1 = time.perf_counter()
        loss = float(step(batch))   # reads the loss: synchronizes
        secs.append(time.perf_counter() - t1)
        after = kernels.counts()
        losses.append(loss)
        per_step.append({k: tuple(a - b for a, b in zip(after[k], before[k]))
                         for k in read})
    counts = kernels.counts()
    phase(f"stm train ({TRAIN_STEPS} steps)", t0)
    steps_per_s = (TRAIN_STEPS - 1) / sum(secs[1:])
    print(f"  stm train, batch {TRAIN_BATCH} at {TRAIN_HW}x{TRAIN_HW}, "
          f"clip_len {TRAIN_CLIP}: losses {losses}; step seconds "
          f"{[round(t, 4) for t in secs]}; {steps_per_s:.3f} steps/s over "
          f"steps 2-{TRAIN_STEPS} on {torch.cuda.get_device_name(0)}; "
          f"(calls, launches) per step {per_step}", flush=True)
    check(all(np.isfinite(losses)), f"stm train losses {losses}")
    # one call per step for the whole batch: K4 is the live-tile list and
    # K4, K5 (handed K4's list) the kernel and the sum of its key splits,
    # K6 one launch
    tq = (TRAIN_HW // 16) ** 2
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = {"attention": (1, 2),
            "attention_bwd_dq": (1, 1 + (ka.dq_splits(
                TRAIN_BATCH, tq, (TRAIN_CLIP - 1) * tq, n_sm) > 1)),
            "attention_bwd_dkv": (1, 1)}
    for n in per_step:
        for k in read:
            check(n[k] == want[k], f"stm train step launched {k} {n[k]}, "
                  f"want {want[k]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "stm.msgpack"
        save_stm(path, model)
        back = load_stm(path)
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            check(torch.equal(back[key], t.cpu()),
                  f"save_stm/load_stm changed {key}")

    t0 = time.perf_counter()
    batch = ts.make_clip_batch(np.random.RandomState(SEED + 1),
                               TRAIN_HOST["batch"], (TRAIN_HOST["hw"],) * 2,
                               TRAIN_CLIP)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = ts.make_stm_train_state(dev, init_from=str(stm_weights))
        loss = float(ts.make_stm_train_step(m, *ts.make_optimizer(
            m, TRAIN_LR, TRAIN_STEPS))(batch))
        runs[dev] = (m, loss)
    phase("stm train host step", t0)
    (card, c_loss), (host, h_loss) = runs["cuda"], runs["cpu"]
    check(abs(c_loss - h_loss) <= 1e-4 * abs(h_loss),
          f"stm train card loss {c_loss} vs host {h_loss}")
    # the rule of tests/test_torch_train_stm.py: where |g| is within the
    # gradient tolerance of 0, Adam's first step is about lr sign(g)
    grads = {n: p.grad for n, p in host.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads.values())
    worst = n_noise = 0
    for name, p in card.named_parameters():
        want = dict(host.named_parameters())[name].detach()
        got, g = p.detach().cpu(), grads[name]
        noise = g.abs() <= 1e-3 * float(g.abs().max()) + 2e-6 * gmax
        d = (got - want).abs()
        ratio = d / (1e-6 + 1e-4 * want.abs())
        worst = max(worst, float(ratio[~noise].max()) if (~noise).any()
                    else 0.0)
        n_noise += int(noise.sum())
        check(bool((d[noise] <= 2 * TRAIN_LR).all()),
              f"stm train card vs host {name}: max |diff| {float(d.max())}")
    check(worst <= 1.0, f"stm train card vs host parameters: worst "
          f"|diff| / (1e-6 + 1e-4 |p|) {worst}")
    stats_rel = 0.0
    host_bufs = dict(host.named_buffers())
    for name, b in card.named_buffers():
        if "running" in name:
            want = host_bufs[name]
            stats_rel = max(stats_rel, float((b.cpu() - want).abs().max()
                                             / want.abs().max()))
    check(stats_rel <= 1e-4, f"stm train card vs host BatchNorm statistics: "
          f"{stats_rel}")
    print(f"  stm train card vs host (batch {TRAIN_HOST['batch']}, "
          f"{TRAIN_HOST['hw']}x{TRAIN_HOST['hw']}): loss {c_loss} vs "
          f"{h_loss}; parameters: worst |diff| / (1e-6 + 1e-4 |p|) "
          f"{worst:.4f} ({n_noise} near-zero-gradient entries held to 2 lr); "
          f"statistics relative {stats_rel:.3g}", flush=True)
    return counts


def within_bound(got, want):
    import numpy as np
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 1).mean())


def bg_phases(frames, gts, stm_weights, matting_weights):
    """bg mode on the card, then card against host; returns the bg path's
    kernel counts."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.pipeline import bg

    cfg = bg_config(stm_weights, matting_weights)
    t0 = time.perf_counter()
    bg.run(cfg, frames[:2], device="cuda")  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    phase("bg warm-up (2 frames)", t0)

    kernels.reset_counts()
    t0 = time.perf_counter()
    res = bg.run(cfg, frames, device="cuda")
    torch.cuda.synchronize()
    counts = kernels.counts()
    phase("bg pipeline", t0)
    secs = res["frame_seconds"]
    fps = (N_FRAMES - 1) / sum(secs[1:])
    print(f"  bg 1080p (STM and matting at 544x960), {N_FRAMES} frames: "
          f"{fps:.3f} frames/s over frames 1-{N_FRAMES - 1} (tracked; frame "
          f"0, the seed frame, {secs[0] * 1e3:.1f} ms, excluded); per-frame "
          f"ms {[round(t * 1e3, 1) for t in secs]}; (calls, launches) "
          f"{counts}", flush=True)
    for k in ("trimap", "morph", "flood", "attention"):
        check(counts[k][1] > 0,
              f"kernel {k} was not launched on the bg path")
    check(counts["attention"][0] == N_FRAMES - 1,
          f"STM memory reads {counts['attention']}, want one per tracked "
          f"frame")
    check(len(res["alphas"]) == N_FRAMES and all(
        a.shape == FRAME_HW and a.dtype == np.uint8 for a in res["alphas"]),
        "bg alphas shape/dtype")
    check(all(f.shape == FRAME_HW + (3,) for f in res["fgs"]), "bg fg shape")
    ious = [iou(a, g) for a, g in zip(res["alphas"], gts)]
    print(f"  bg IoU with the synthetic ground truth: per frame "
          f"{[round(v, 4) for v in ious]}, mean {np.mean(ious):.4f}",
          flush=True)
    check(ious[0] > 0.8 and np.mean(ious) > 0.75,
          f"bg IoU with the ground truth {ious}")

    t0 = time.perf_counter()
    small, _ = green_clip(N_CPU_FRAMES, *BG_HOST_HW, seed=SEED)
    card = bg.run(cfg, small, device="cuda")["alphas"]
    host = bg.run(cfg, small, device="cpu")["alphas"]
    dmax, frac = within_bound(np.stack(card), np.stack(host))
    phase(f"bg host run ({N_CPU_FRAMES} frames at {BG_HOST_HW[0]}x"
          f"{BG_HOST_HW[1]})", t0)
    print(f"  bg card vs host alphas: max |diff| {dmax}, |diff| > 1 on "
          f"{frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"bg card vs host alphas: max {dmax}, frac>1 {frac}")
    return counts


def gt_ious(alphas, gts, hw):
    """IoU of each alpha >= 128 with its ground truth resized (nearest) to
    the work resolution `hw`."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.geometry import resize
    out = []
    for a, gt in zip(alphas, gts):
        g = resize(torch.from_numpy(gt.astype(np.float32)), hw,
                   "nearest").numpy() > 0
        p = a >= 128
        out.append(float((g & p).sum() / max((g | p).sum(), 1)))
    return out


def agreement(a, b):
    """Per frame, the share of pixels on which a >= 128 and b >= 128
    agree."""
    return [float(((x >= 128) == (y >= 128)).mean()) for x, y in zip(a, b)]


def seed_rows(segs, frame):
    """The seed's device ms a call on the (H, W, 3) work frame in float32
    and bfloat16 (`segs`: {"f32": agent, "bf16": agent}), beside its
    operations and their bound at each type's rate."""
    import torch
    from video_unscreen_tpu_torch.agents.binseg import _crop_grid
    from video_unscreen_tpu_torch.models.deeplab import build_deeplab
    h, w = frame.shape[:2]
    ch, cw = min(513, h), min(513, w)
    n_crops = len(_crop_grid(h, w, ch, cw, 0.5, True))
    flops = net_flops(build_deeplab, (n_crops, 3, ch, cw))
    out = {}
    for name, rate, reps in (("f32", F32_OPS_PER_S, 2),
                             ("bf16", BF16_OPS_PER_S, 10)):
        seg = segs[name]
        ms = cuda_ms(lambda: seg.predict_mask_impl(frame), reps, rounds=5)
        out[name] = dict(ms=ms, bound_ms=flops / rate * 1e3)
    print(f"  DeepLab seed at {h}x{w} ({n_crops} crops of {ch}x{cw}, "
          f"{flops / 1e12:.4f} TFLOP a call): float32 {out['f32']['ms']:.3f} "
          f"ms (bound {out['f32']['bound_ms']:.3f} ms at 67 TFLOP/s), "
          f"bfloat16 {out['bf16']['ms']:.3f} ms (bound "
          f"{out['bf16']['bound_ms']:.3f} ms at 989 TFLOP/s)", flush=True)
    return dict(flops=flops, crops=n_crops, **out)


def seed_phase(frame, matting_weights):
    """5a: the DeepLab seed at full width with seeded weights (no weights
    file: the default run's copy holds none), timed in float32 and
    bfloat16; card against host in float32 on a SEED_GRID_HW frame at crop
    SEED_GRID_CROP (2x3 overlapping locations and their flips); the
    MattingUNet's time at the work resolution in both types."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.agents.binseg import SegAgent, _crop_grid
    from video_unscreen_tpu_torch.agents.vmatting import VMattingAgent
    from video_unscreen_tpu_torch.models.matting_unet import MattingUNet

    t0 = time.perf_counter()
    segs = {"f32": SegAgent(device="cuda", seed=SEED),
            "bf16": SegAgent(device="cuda", seed=SEED, dtype=torch.bfloat16)}
    rows = seed_rows(segs, frame)
    s16 = segs["bf16"].predict_scores(frame)
    check(s16.dtype == torch.float32 and bool(torch.isfinite(s16).all()),
          "bfloat16 seed scores not finite float32")
    (gh, gw), gc = SEED_GRID_HW, SEED_GRID_CROP
    locs = _crop_grid(gh, gw, gc, gc, 0.5, True)
    check(len(locs) == 12 and len({l[:2] for l in locs}) == 6,
          f"seed card vs host: {len(locs)} crops, want 2x3 locations with "
          f"their flips")
    sub = frame[:gh, :gw]
    card = SegAgent(device="cuda", seed=SEED, crop_h=gc,
                    crop_w=gc).predict_scores(sub).cpu()
    host = SegAgent(device="cpu", seed=SEED, crop_h=gc,
                    crop_w=gc).predict_scores(sub.cpu())
    err = float((card - host).abs().max())
    check(err <= 1e-4, f"seed card vs host scores: max |diff| {err}")
    sure = (host[..., 1] - host[..., 0]).abs() > 1e-3
    same = card.argmax(-1) == host.argmax(-1)
    check(bool(same[sure].all()), "seed card vs host masks differ where "
          "|p_fg - p_bg| > 1e-3")
    print(f"  seed card vs host ({gh}x{gw}, {len(locs)} crops of {gc}x{gc}, "
          f"float32): scores max "
          f"|diff| {err:.3g}, masks equal on all {int(sure.sum())} decided "
          f"pixels ({int((~sure).sum())} within 1e-3)", flush=True)

    h, w = frame.shape[:2]
    rng = np.random.RandomState(SEED + 9)
    args = [torch.from_numpy(rng.uniform(0, 1, (1, c, h, w)).astype(
        np.float32)).cuda() for c in (3, 1, 3)]
    flops = net_flops(MattingUNet, *[a.shape for a in args])
    unet = {}
    for name, dt, rate in (("f32", torch.float32, F32_OPS_PER_S),
                           ("bf16", torch.bfloat16, BF16_OPS_PER_S)):
        net = VMattingAgent(str(matting_weights), device="cuda",
                            dtype=dt).model
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(*args), 10, rounds=5)
        unet[name] = dict(ms=ms, bound_ms=flops / rate * 1e3)
    rows["unet"] = dict(flops=flops, **unet)
    phase("seed and UNet, float32 and bfloat16", t0)
    print(f"  MattingUNet at {h}x{w} ({flops / 1e9:.2f} GFLOP): float32 "
          f"{unet['f32']['ms']:.3f} ms (bound {unet['f32']['bound_ms']:.3f} "
          f"ms), bfloat16 {unet['bf16']['ms']:.3f} ms (bound "
          f"{unet['bf16']['bound_ms']:.4f} ms)", flush=True)
    return rows


def timed_run(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` with the kernel counts reset just before and
    read just after; returns (result, seconds, counts)."""
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.counts()


def check_launched(counts, what, names=("trimap", "morph", "flood")):
    """Each kernel of `names` launched at least once in a path's run."""
    for k in names:
        check(counts[k][1] > 0, f"kernel {k} was not launched on the {what} "
              f"path")


def check_seed_log(pipe, before, what):
    """The seed ran on the first frame of every segment and exactly on the
    frames whose segment was not tracking: the agent's forward and frame
    counts since `before` against the tracking flags of each step."""
    steps = pipe.step_tracking
    check(not any(steps[0]), f"{what}: the seed did not run on frame 0 of "
          f"every segment")
    n_fwd = sum(1 for t in steps if not all(t))
    n_frames = sum(t.count(False) for t in steps)
    got = (pipe.seg.forwards - before[0], pipe.seg.frames - before[1])
    check(got == (n_fwd, n_frames), f"{what}: seed forwards and frames "
          f"{got}, want {(n_fwd, n_frames)} from the tracking flags")
    return n_fwd, n_frames


def green_bf16_phase(cfg, frames, gts, alphas32):
    """5b: the green path in bfloat16 (the pipeline's default) on the same
    frames as phase 4; returns (its kernel counts, the pipeline)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    pipe = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              device="cuda")
    check(pipe.vmat.model.enc_conv1.weight.dtype == torch.bfloat16,
          "the pipeline's default matting dtype is not bfloat16")
    pipe.run(frames[:2], **DEV_RESIZE)   # warm-up: cuDNN plans, bfloat16
    torch.cuda.synchronize()
    (alphas, _, _), secs, counts = timed_run(pipe.run, frames, **DEV_RESIZE)
    ious = gt_ious(alphas, gts, pipe.work_hw)
    agree = agreement(alphas, alphas32)
    print(f"  green bfloat16, {N_FRAMES} frames: {N_FRAMES / secs:.2f} "
          f"frames/s; {pipe.stats['syncs'] / N_FRAMES:.3f} host syncs a "
          f"frame; IoU min {min(ious):.4f} mean {np.mean(ious):.4f}; alpha "
          f">= 128 agrees with float32 on {min(agree):.6f} of pixels (worst "
          f"frame); (calls, launches) {counts}", flush=True)
    check(min(ious) > 0.75, f"green bfloat16 IoU {ious}")
    check(min(agree) >= BF16_ALPHA_AGREE,
          f"green bfloat16 vs float32 masks {agree}")
    check_launched(counts, "green bfloat16")
    return counts, pipe


def segmented_phase(pipe16, pipe32):
    """5c: `run_segmented` with S = 8 segments of 4 frames, bfloat16 then
    float32; returns the bfloat16 run's kernel counts."""
    import numpy as np
    import torch

    n = N_SEGMENTS * SEG_FRAMES
    frames, gts = green_clip(n, *FRAME_HW, seed=SEED + 1)
    t0 = time.perf_counter()
    fps = {}
    for label, pipe in (("bf16", pipe16), ("f32", pipe32)):
        # warm-up: one step of the batch of 8 (cuDNN plans)
        pipe.run_segmented(frames[:N_SEGMENTS], N_SEGMENTS, SEG_FRAMES,
                           **DEV_RESIZE)
        torch.cuda.synchronize()
        (alphas, _, _), secs, counts = timed_run(
            pipe.run_segmented, frames, N_SEGMENTS, SEG_FRAMES, **DEV_RESIZE)
        fps[label] = n / secs
        ious = gt_ious(alphas, gts, pipe.work_hw)
        print(f"  run_segmented {label}, S {N_SEGMENTS} x {SEG_FRAMES} "
              f"frames: {fps[label]:.2f} frames/s; "
              f"{pipe.stats['syncs'] / n:.3f} host syncs a frame "
              f"({pipe.stats['syncs']} for {n} frames); IoU min "
              f"{min(ious):.4f} mean {np.mean(ious):.4f}; (calls, launches) "
              f"{counts}", flush=True)
        check(min(ious) > 0.75, f"run_segmented {label} IoU {ious}")
        check_launched(counts, f"run_segmented {label}")
        check(counts["trimap"] == (SEG_FRAMES, SEG_FRAMES),
              f"run_segmented {label}: K1 (calls, launches) "
              f"{counts['trimap']}, want one launch a step for the batch of "
              f"{N_SEGMENTS}")
        if label == "bf16":
            seg_counts = counts
        else:
            seq = pipe.run(frames[:SEG_FRAMES], **DEV_RESIZE)[0]
            dmax, frac = within_bound(alphas[:SEG_FRAMES], seq)
            print(f"  float32 segment 0 vs the sequential run of its "
                  f"frames: max |diff| {dmax}, |diff| > 1 on {frac:.6f}",
                  flush=True)
            check(dmax <= 4 and frac < 1e-3,
                  f"segment 0 vs sequential: max {dmax}, frac>1 {frac}")
    phase(f"run_segmented (S {N_SEGMENTS}, {n} frames, bfloat16 and "
          f"float32)", t0)
    return seg_counts


def plain_wire_loop(pipe, frames, n_segments):
    """The wire run without the streamer: each step's I420 batch built on
    the host and uploaded synchronously from pageable memory, then
    `_step_batched`. Returns (alphas, fgs, screen colors) in clip order."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch import runtime
    n = len(frames)
    seg_len = -(-n // n_segments)
    padded = list(frames) + [frames[-1]] * (n_segments * seg_len - n)
    carries = pipe.init_carries(n_segments)
    steps = []
    with torch.inference_mode():
        for t in range(seg_len):
            batch = runtime.prep_batch(
                [padded[s * seg_len + t] for s in range(n_segments)],
                pipe.work_hw, True)
            carries, outs = pipe._step_batched(
                carries, torch.from_numpy(batch).to("cuda"))
            steps.append([o.cpu().numpy() for o in outs])
    return [np.stack([steps[t][k][s] for s in range(n_segments)
                      for t in range(seg_len)])[:n] for k in range(3)]


def wire_green_phase(cfg, pipe16):
    """5d: bench.py's green configuration: the chroma seed, bfloat16,
    `run_segmented` S = 8 x 4 frames in chunks of 4, the I420 wire and the
    host resize, beside the BGR wire with the device resize (`pipe16`, 5b's
    pipeline) on the same frames, in turns (bgr, yuv420, yuv420, bgr),
    counts reset just before each; the streamed run bit-equal to the plain
    loop; float32 card against host on 2 frames. Returns the wire run's
    kernel counts."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.pipeline.common import host_frames
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    t0 = time.perf_counter()
    n = N_SEGMENTS * SEG_FRAMES
    frames, gts = green_clip(n, *FRAME_HW, seed=SEED + 1)
    wire = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              wire="yuv420", device="cuda")
    runs = {"bgr": (pipe16, DEV_RESIZE), "yuv420": (wire, {})}
    for pipe, kw in runs.values():
        pipe.run_segmented(frames[:N_SEGMENTS], N_SEGMENTS, SEG_FRAMES, **kw)
    torch.cuda.synchronize()
    fps = {"bgr": [], "yuv420": []}
    for label in ("bgr", "yuv420", "yuv420", "bgr"):
        pipe, kw = runs[label]
        out, secs, c = timed_run(pipe.run_segmented, frames, N_SEGMENTS,
                                 SEG_FRAMES, **kw)
        fps[label].append(n / secs)
        if label == "yuv420":
            counts, outs = c, out
    h, w = wire.work_hw
    ious = gt_ious(outs[0], gts, wire.work_hw)
    print(f"  wire green (bfloat16, S {N_SEGMENTS} x {SEG_FRAMES}, chunks of "
          f"{SEG_FRAMES}): yuv420 with the host resize "
          f"{[round(v, 3) for v in fps['yuv420']]} frames/s, bgr with the "
          f"device resize {[round(v, 3) for v in fps['bgr']]} (turns bgr, "
          f"yuv420, yuv420, bgr); upload bytes a frame {h * w * 3 // 2} "
          f"against {FRAME_HW[0] * FRAME_HW[1] * 3}; "
          f"{wire.stats['syncs'] / n:.3f} host syncs a frame; IoU min "
          f"{min(ious):.4f} mean {np.mean(ious):.4f}; (calls, launches) "
          f"{counts}", flush=True)
    check(min(ious) > 0.75, f"wire green IoU {ious}")
    check_launched(counts, "wire green")

    plain = plain_wire_loop(wire, frames, N_SEGMENTS)
    plain_bgs = np.where(plain[0][..., None] < 128, host_frames(frames,
                                                                (h, w)),
                         plain[2][:, None, None, :].astype(np.uint8))
    for name, got, want in (("alpha", outs[0], plain[0]),
                            ("fg", outs[1], plain[1]),
                            ("bg", outs[2], plain_bgs)):
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"wire green streamed vs plain loop: {name} "
              f"differs on {n_diff} values")
    print(f"  wire green streamed run bit-equal to the plain synchronous "
          f"loop (alpha, fg, bg of {n} frames)", flush=True)
    phase(f"wire green (S {N_SEGMENTS}, {n} frames, yuv420 and bgr)", t0)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    small = {dev: FusedGreenPipeline(
        cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
        matting_dtype=torch.float32, seg_dtype=torch.float32, wire="yuv420",
        device=dev).run(frames[:N_CPU_FRAMES]) for dev in ("cuda", "cpu")}
    for k, name in enumerate(("alpha", "fg", "bg")):
        dmax, frac = within_bound(small["cuda"][k], small["cpu"][k])
        print(f"  wire green float32 card vs host {name}: max |diff| "
              f"{dmax}, |diff| > 1 on {frac:.6f}", flush=True)
        check(dmax <= 4 and frac < 1e-3,
              f"wire green card vs host {name}: max {dmax}, frac>1 {frac}")
    phase(f"wire green host run ({N_CPU_FRAMES} frames)", t0)
    return counts


def wire_fused_bg_phase(stm_weights, matting_weights):
    """7e: fused bg as bench.py runs bg: bfloat16, S = 8 x 8 frames in
    chunks of 4, the I420 wire and the host resize, chroma seed: frames/s
    and the IoU bars; float32 card against host on 2 frames of 270x480,
    the same wire. Returns the run's kernel counts."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline

    t0 = time.perf_counter()
    cfg = bg_config(stm_weights, matting_weights)
    n = N_SEGMENTS * BG_SEG_FRAMES
    frames, gts = green_clip(n, *FRAME_HW, seed=SEED + 1)
    pipe = FusedBgPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                           wire="yuv420", device="cuda")
    pipe.run_segmented(frames[:N_SEGMENTS], N_SEGMENTS, SEG_CHUNK)
    torch.cuda.synchronize()
    out, secs, counts = timed_run(pipe.run_segmented, frames, N_SEGMENTS,
                                  SEG_CHUNK)
    ious = gt_ious(out[0], gts, pipe.work_hw)
    st = pipe.stats
    print(f"  wire fused bg (bfloat16, yuv420 with the host resize, S "
          f"{N_SEGMENTS} x {BG_SEG_FRAMES}, chunks of {SEG_CHUNK}): "
          f"{n / secs:.3f} frames/s; {st['syncs'] / n:.3f} host syncs a "
          f"frame; tracked {st['tracked_frames']}, seeded "
          f"{st['seeded_frames']}; IoU frame 0 {ious[0]:.4f}, min "
          f"{min(ious):.4f}, mean {np.mean(ious):.4f}; (calls, launches) "
          f"{counts}", flush=True)
    check(ious[0] > 0.8 and np.mean(ious) > 0.75,
          f"wire fused bg IoU with the ground truth {ious}")
    check_launched(counts, "wire fused bg",
                   ("trimap", "morph", "flood", "attention"))
    phase(f"wire fused bg (S {N_SEGMENTS}, {n} frames)", t0)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    small, _ = green_clip(N_CPU_FRAMES, *BG_HOST_HW, seed=SEED)
    runs = {dev: FusedBgPipeline(
        cfg, BG_HOST_HW, work_long_side=BG_HOST_HW[1],
        matting_dtype=torch.float32, stm_dtype=torch.float32,
        seg_dtype=torch.float32, wire="yuv420", device=dev).run(small)
        for dev in ("cuda", "cpu")}
    dmax, frac = within_bound(runs["cuda"][0], runs["cpu"][0])
    phase(f"wire fused bg host run ({N_CPU_FRAMES} frames at "
          f"{BG_HOST_HW[0]}x{BG_HOST_HW[1]})", t0)
    print(f"  wire fused bg float32 card vs host alphas: max |diff| {dmax}, "
          f"|diff| > 1 on {frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"wire fused bg card vs host alphas: max {dmax}, frac>1 {frac}")
    return counts


def green_modular_phase(cfg, frames, gts):
    """5e: the modular green driver (`pipeline/green.py:run`, the agents
    frame by frame at 1080p, float32 matting) on the 8 frames, counts reset
    just before: K1-K3 launched, IoU > 0.75 on every frame, frames/s.
    Returns its kernel counts."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.pipeline import green

    t0 = time.perf_counter()
    green.run(cfg, frames[:2], save=False, device="cuda")  # warm-up
    torch.cuda.synchronize()
    res, secs, counts = timed_run(green.run, cfg, frames, save=False,
                                  device="cuda")
    ious = [iou(a, g) for a, g in zip(res["alphas"], gts)]
    stages = sum(res["runtime"].values())
    print(f"  green modular 1080p, {N_FRAMES} frames: {N_FRAMES / stages:.3f}"
          f" frames/s over the stages ({N_FRAMES / secs:.3f} with the agents' "
          f"build); tracking {res['tracking_count']} / {N_FRAMES}; IoU min "
          f"{min(ious):.4f} mean {np.mean(ious):.4f}; (calls, launches) "
          f"{counts}", flush=True)
    check(all(a.shape == FRAME_HW for a in res["alphas"]),
          "green modular alpha shapes")
    check(min(ious) > 0.75, f"green modular IoU {ious}")
    check_launched(counts, "green modular")
    phase(f"green modular ({N_FRAMES} frames)", t0)
    return counts


def disk_phase(green_cfg, stm_weights, matting_weights):
    """The drivers from disk: the 8 synthetic 1080p frames written as
    JPEGs, then `tools/unscreen/green_torch.py --fused --segments 8 --wire
    yuv420` and `bg_torch.py` likewise through their `main`; every
    artifact is there and the decoded alphamasks are within mean 8 of the
    returned alphas; frames/s with the read and the write. Runs only where
    the JPEG codec can build (libjpeg's header and library); returns
    whether it ran."""
    import importlib.util
    import tempfile
    import numpy as np
    from video_unscreen_tpu_torch import runtime

    missing = runtime.codec_missing()
    if missing:
        print(f"  disk phase did not run: the JPEG codec needs libjpeg-turbo "
              f"and this machine lacks {missing}", flush=True)
        return False
    t0 = time.perf_counter()
    frames, _ = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="vut_disk_") as root:
        src = Path(root, "src_img", "clip")
        src.mkdir(parents=True)
        runtime.encode_batch([str(src / f"frame_{i:06d}.jpg")
                              for i in range(N_FRAMES)], np.stack(frames))
        for mode, cfg in (("green", green_cfg),
                          ("bg", bg_config(stm_weights, matting_weights))):
            cfg_path = Path(root, f"{mode}.json")
            cfg_path.write_text(json.dumps(cfg))
            spec = importlib.util.spec_from_file_location(
                f"{mode}_torch", ROOT / "tools" / "unscreen" /
                f"{mode}_torch.py")
            cli = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(cli)
            t1 = time.perf_counter()
            out = cli.main(["--cfg", str(cfg_path), "-vid", "clip",
                            "--data_root", root, "--fused", "--segments",
                            str(N_SEGMENTS), "--wire", "yuv420"])
            secs = time.perf_counter() - t1
            dst = Path(root, f"test_{mode}_img", "clip")
            kinds = ("alphamask", "fg", "bg") + (
                ("segmask",) if mode == "bg" else ())
            for kind in kinds:
                got = sorted(dst.glob(f"{kind}_*.jpg"))
                check(len(got) == N_FRAMES,
                      f"disk {mode}: {len(got)} {kind} files")
            back = runtime.decode_batch(sorted(
                str(p) for p in dst.glob("alphamask_*.jpg")))[..., 0]
            err = float(np.abs(back.astype(np.float64)
                               - np.stack(out["alphas"])).mean())
            print(f"  disk {mode} (--fused --segments {N_SEGMENTS} --wire "
                  f"yuv420): {N_FRAMES / secs:.3f} frames/s with the read "
                  f"and the write; alphamask files within mean {err:.3f} "
                  f"of the alphas", flush=True)
            check(err < 8.0, f"disk {mode}: alphamask mean |diff| {err}")
    phase(f"disk ({N_FRAMES} frames, green and bg)", t0)
    return True


@contextlib.contextmanager
def float32_stage_pipelines():
    """bg_offline builds its FusedBgPipeline with the shipped bfloat16 STM,
    matting and seed; inside this block the class it looks up passes
    float32 for all three (the substitution the CPU tests make)."""
    import torch
    from video_unscreen_tpu_torch.pipeline import fused_bg
    base = fused_bg.FusedBgPipeline

    class Float32(base):
        def __init__(self, *args, **kw):
            kw.update(matting_dtype=torch.float32, stm_dtype=torch.float32,
                      seg_dtype=torch.float32)
            super().__init__(*args, **kw)

    fused_bg.FusedBgPipeline = Float32
    try:
        yield
    finally:
        fused_bg.FusedBgPipeline = base


def offline_config(stm_weights, matting_weights):
    """bg_config with the data section bg_offline reads (no store is
    written: save=False)."""
    cfg = bg_config(stm_weights, matting_weights)
    cfg["data"] = {"dst_img_dir": "unused", "dst_vid_dir": "unused",
                   "video_id": "smoke", "range": None}
    return cfg


def held_within_bound(what, got, want):
    """uint8 card and host outputs within the JAX suite's bound."""
    import numpy as np
    dmax, frac = within_bound(np.asarray(got), np.asarray(want))
    print(f"  {what}: max |diff| {dmax}, |diff| > 1 on {frac:.6f}",
          flush=True)
    check(dmax <= 4 and frac < 1e-3, f"{what}: max {dmax}, frac>1 {frac}")


def bg_offline_phase(frames, gts, stm_weights, matting_weights):
    """10. bg_offline (`pipeline/bg_offline.py:run`, fused, chunks of 4)
    on the 8 1080p frames in bfloat16 (counts reset just before) and in
    float32; stage 2 alone on 24 frames; float32 card against host at
    270x480, fused and modular. Returns (kernel counts by path, the
    bfloat16 run's result)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.pipeline import bg_offline

    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline

    cfg = offline_config(stm_weights, matting_weights)
    counts = {}
    t0 = time.perf_counter()
    FusedBgPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                    device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kw = dict(save=False, stages=(1, 2, 3), fused=True,
              chunk_size=BG_OFFLINE_CHUNK, device="cuda")
    res, _, counts["bg_offline"] = timed_run(bg_offline.run, cfg, frames,
                                             **kw)
    alphas, fgs = np.stack(res["alphas"]), np.stack(res["fgs"])
    check(alphas.shape == (N_FRAMES, 544, 960) and alphas.dtype == np.uint8
          and fgs.shape == alphas.shape + (3,), "bg_offline output shapes")
    check(res["always_bg"].shape == FRAME_HW + (3,)
          and res["ema"][1].shape == (544, 960), "bg_offline artifacts")
    ious = gt_ious(alphas, gts, (544, 960))
    secs = res["seconds"]
    print(f"  bg_offline bfloat16, {N_FRAMES} frames 1080p -> 544x960: "
          f"{N_FRAMES / sum(secs.values()):.3f} frames/s over the three "
          f"stages; seconds {({k: round(v, 4) for k, v in secs.items()})}; "
          f"stage 2 CG iterations {res['stage2_cg_iters']} (every pixel "
          f"was background in {N_FRAMES} <= 10 frames: the whole frame is "
          f"the hole, no boundary); IoU {[round(v, 4) for v in ious]}, "
          f"mean {np.mean(ious):.4f}; (calls, launches) "
          f"{counts['bg_offline']}; stage 1 includes building its "
          f"FusedBgPipeline (the weights read and copied to the card), "
          f"{build_s:.4f} s alone", flush=True)
    check(np.mean(ious) > 0.6, f"bg_offline IoU with the ground truth {ious}")
    check_launched(counts["bg_offline"], "bg_offline",
                   ("trimap", "morph", "flood", "attention"))
    with float32_stage_pipelines():
        res32, secs32, _ = timed_run(bg_offline.run, cfg, frames, **kw)
    agree = agreement(res["alphas"], res32["alphas"])
    print(f"  bg_offline float32: {N_FRAMES / secs32:.3f} frames/s; "
          f"bfloat16 vs float32 alpha >= 128 agrees on {min(agree):.6f} of "
          f"pixels (worst frame)", flush=True)
    check(min(agree) >= BG_BF16_ALPHA_AGREE,
          f"bg_offline bfloat16 vs float32 masks {agree}")
    phase(f"bg_offline ({N_FRAMES} frames, bfloat16 and float32)", t0)

    # stage 2 where the always-foreground hole has a boundary: the
    # ground-truth masks of 24 frames, in chunks of 16 (one K2 launch a
    # chunk, one for the hole, one for the CG perimeter)
    t0 = time.perf_counter()
    frames24, gts24 = green_clip(STAGE2_FRAMES, *FRAME_HW, seed=SEED + 2)
    masks24 = [np.repeat(g.astype(np.uint8)[..., None] * 255, 3, axis=2)
               for g in gts24]
    (bg2, iters), secs2, counts["bg_offline_stage2"] = timed_run(
        bg_offline._stage2, cfg, frames24, masks24, None, False,
        chunk_size=STAGE2_CHUNK, device="cuda")
    n_chunks = -(-STAGE2_FRAMES // STAGE2_CHUNK)
    c2 = counts["bg_offline_stage2"]["morph"]
    print(f"  bg_offline stage 2, {STAGE2_FRAMES} frames 1080p in chunks of "
          f"{STAGE2_CHUNK}: {secs2:.4f} s; CG iterations {iters}; K2 "
          f"(calls, launches) {c2}", flush=True)
    check(c2 == (n_chunks + 2, n_chunks + 2),
          f"stage 2 K2 {c2}: want one launch a chunk, the hole, the "
          f"perimeter")
    check(min(iters) > 0 and bg2.shape == FRAME_HW + (3,),
          f"stage 2 CG iterations {iters}")
    torch.set_num_threads(os.cpu_count() or 1)
    small24, sgts24 = green_clip(STAGE2_FRAMES, *BG_HOST_HW, seed=SEED + 2)
    smasks24 = [np.repeat(g.astype(np.uint8)[..., None] * 255, 3, axis=2)
                for g in sgts24]
    card, host = (bg_offline._stage2(cfg, small24, smasks24, None, False,
                                     chunk_size=STAGE2_CHUNK, device=d)
                  for d in ("cuda", "cpu"))
    d = int(np.abs(card[0].astype(int) - host[0].astype(int)).max())
    print(f"  stage 2 card vs host at {BG_HOST_HW[0]}x{BG_HOST_HW[1]}: "
          f"always_bg max |diff| {d}; CG iterations {card[1]} / {host[1]}",
          flush=True)
    check(d <= 1, f"stage 2 card vs host always_bg {d}")
    phase(f"bg_offline stage 2 ({STAGE2_FRAMES} frames)", t0)

    t0 = time.perf_counter()
    small, _ = green_clip(N_OFFLINE_HOST, *BG_HOST_HW, seed=SEED)
    for fused in (True, False):
        with float32_stage_pipelines():
            runs = {dev: bg_offline.run(
                cfg, small, save=False, fused=fused, chunk_size=2,
                work_long_side=BG_HOST_HW[1], device=dev)
                for dev in ("cuda", "cpu")}
        form = "fused" if fused else "modular"
        for key in ("alphas", "fgs"):
            held_within_bound(f"bg_offline {form} card vs host {key}",
                              np.stack(runs["cuda"][key]),
                              np.stack(runs["cpu"][key]))
        d = int(np.abs(runs["cuda"]["always_bg"].astype(int)
                       - runs["cpu"]["always_bg"].astype(int)).max())
        check(d <= 1, f"bg_offline {form} always_bg card vs host {d}")
        if fused:
            check(np.array_equal(runs["cuda"]["ema"][1],
                                 runs["cpu"]["ema"][1]),
                  "bg_offline ema_seen card vs host")
            d_ema = int(np.abs(runs["cuda"]["ema"][0].astype(int)
                               - runs["cpu"]["ema"][0].astype(int)).max())
            print(f"  fused: ema_seen equal, ema_bg max |diff| {d_ema}, "
                  f"always_bg max |diff| {d}", flush=True)
    phase(f"bg_offline host runs ({N_OFFLINE_HOST} frames at "
          f"{BG_HOST_HW[0]}x{BG_HOST_HW[1]}, fused and modular)", t0)
    return counts, res


def replace_and_agents_phase(frames, gts, offline):
    """10a. The replacement core (`pipeline/replace.py:compose_frames`) on
    bg_offline's alphas and fgs brought to 1080p over a seeded background,
    with and without harmonization, and `BackgroundAgent.forward` with
    each method at 1080p: float32 card against host within the JAX bound;
    K2 launched in every BackgroundAgent run. Returns kernel counts by
    path."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch import runtime
    from video_unscreen_tpu_torch.agents.bgmodel import BackgroundAgent
    from video_unscreen_tpu_torch.pipeline import replace

    t0 = time.perf_counter()
    counts = {}
    up = runtime.resize_batch(offline["alphas"], FRAME_HW)
    masks = [np.repeat(a[..., None], 3, axis=2) for a in up]
    fgs = list(runtime.resize_batch(offline["fgs"], FRAME_HW))
    rng = np.random.RandomState(SEED + 3)
    yy, xx = np.mgrid[0:FRAME_HW[0], 0:FRAME_HW[1]]
    bg = np.stack([xx * 0.1, yy * 0.2, (xx + yy) * 0.05], -1) + 30.0
    bg = (bg + rng.uniform(0, 40, bg.shape)).clip(0, 255).astype(np.uint8)
    # the source subject: the ground truth mirrored, so the shift is real
    src = [np.repeat(g[:, ::-1].astype(np.uint8)[..., None] * 255, 3, 2)
           for g in gts]
    shift = replace.centroid_offset(src, masks, device="cuda")
    shift_host = replace.centroid_offset(src[:N_OFFLINE_HOST],
                                         masks[:N_OFFLINE_HOST],
                                         device="cpu")
    shift_card3 = replace.centroid_offset(src[:N_OFFLINE_HOST],
                                          masks[:N_OFFLINE_HOST],
                                          device="cuda")
    check(np.allclose(shift_card3, shift_host, rtol=1e-4, atol=1e-3),
          f"centroid offset card {shift_card3} vs host {shift_host}")
    for harmonize in (False, True):
        name = "replace_harmonized" if harmonize else "replace"
        replace.compose_frames(fgs[:1], masks[:1], bg, shift, harmonize,
                               "cuda")  # warm-up
        out, secs, counts[name] = timed_run(
            replace.compose_frames, fgs, masks, bg, shift, harmonize, "cuda")
        print(f"  {name}, {N_FRAMES} frames 1080p, shift "
              f"({shift[0]:.3f}, {shift[1]:.3f}): "
              f"{secs / N_FRAMES * 1e3:.3f} ms a frame; (calls, launches) "
              f"{counts[name]}", flush=True)
        check(out.shape == (N_FRAMES,) + FRAME_HW + (3,), f"{name} shape")
        host = replace.compose_frames(fgs[:N_OFFLINE_HOST],
                                      masks[:N_OFFLINE_HOST], bg, shift,
                                      harmonize, "cpu")
        held_within_bound(f"{name} card vs host", out[:N_OFFLINE_HOST], host)
    mask = gts[0].astype(np.uint8) * 255
    for method in ("mean", "pcov", "rf"):
        agent = BackgroundAgent(device="cuda")
        agent.forward(frames[0], mask, method)  # warm-up
        name = f"bgmodel_{method}"
        got, secs, counts[name] = timed_run(agent.forward, frames[0], mask,
                                            method)
        host_agent = BackgroundAgent(device="cpu")
        want = host_agent.forward(frames[0], mask, method)
        extra = (f"; pcov iterations {agent.pcov_iters} (host "
                 f"{host_agent.pcov_iters})" if method == "pcov" else "")
        print(f"  BackgroundAgent {method} 1080p (work 303x540): "
              f"{secs * 1e3:.3f} ms; (calls, launches) {counts[name]}"
              f"{extra}", flush=True)
        check(got.shape == FRAME_HW + (3,), f"{name} shape")
        check(counts[name]["morph"][1] > 0, f"{name}: K2 was not launched")
        held_within_bound(f"BackgroundAgent {method} card vs host", got,
                          want)
        if method == "pcov":
            check(agent.pcov_iters == host_agent.pcov_iters,
                  f"pcov iterations {agent.pcov_iters} vs "
                  f"{host_agent.pcov_iters}")
    phase("replace and BackgroundAgent at 1080p", t0)
    return counts


def bg_offline_disk_phase(stm_weights, matting_weights):
    """10b. The CLIs from disk, where libjpeg is on the machine: the 8
    frames written as JPEGs, `tools/unscreen/bg_offline_torch.py` stages
    1,2,3 and then `--stages 3` (the resume from the store) through
    `main`, then `tools/replace/replace_torch.py` on the store, with and
    without `--harmonize`; every artifact written, both PNGs included.
    Else one line says why it did not run. Returns whether it ran."""
    import importlib.util
    import shutil
    import tempfile
    import numpy as np
    from video_unscreen_tpu_torch import runtime

    missing = runtime.codec_missing()
    if missing:
        print(f"  bg_offline disk phase did not run: the JPEG codec needs "
              f"libjpeg-turbo and this machine lacks {missing}", flush=True)
        return False

    def cli(rel):
        spec = importlib.util.spec_from_file_location(
            Path(rel).stem, ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    t0 = time.perf_counter()
    frames, _ = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="vut_offline_") as root:
        src = Path(root, "src_img", "clip")
        src.mkdir(parents=True)
        runtime.encode_batch([str(src / f"frame_{i:06d}.jpg")
                              for i in range(N_FRAMES)], np.stack(frames))
        cfg_path = Path(root, "bg.json")
        cfg_path.write_text(json.dumps(bg_config(stm_weights,
                                                 matting_weights)))
        offline = cli("tools/unscreen/bg_offline_torch.py")
        args = ["--cfg", str(cfg_path), "-vid", "clip", "--data_root", root]
        offline.main(args)
        resumed = offline.main(args + ["--stages", "3"])
        store = Path(root, "test_bg_step_img", "clip")
        for kind in ("segmask", "bg", "alphamask", "fg"):
            n = len(list(store.glob(f"{kind}_*.jpg")))
            check(n == N_FRAMES, f"bg_offline disk: {n} {kind} files")
        for name in ("always_bg.jpg", "ema_bg.png", "ema_seen.png"):
            check((store / name).is_file(), f"bg_offline disk: no {name}")
        check(len(resumed["alphas"]) == N_FRAMES, "stage-3 resume alphas")
        rep = Path(root, "rep")
        dirs = {"tgt": rep / "unscreenbg_img" / "out5",
                "src": rep / "unscreen_img" / "test5",
                "bg": rep / "unscreen_img" / "bg"}
        for d in dirs.values():
            d.mkdir(parents=True)
        for f in store.glob("*_*.jpg"):
            if f.name.startswith(("alphamask_", "fg_")):
                shutil.copy(f, dirs["tgt"] / f.name)
            if f.name.startswith("alphamask_"):
                shutil.copy(f, dirs["src"] / f.name)
        shutil.copy(store / "always_bg.jpg", dirs["bg"] / "bg_case.jpg")
        rep_cli = cli("tools/replace/replace_torch.py")
        for extra in ([], ["--harmonize"]):
            rep_cli.main(["--data_root", str(rep)] + extra)
            out = rep / "merge_test_img" / "test5_out5"
            for kind in ("res", "compare"):
                n = len(list(out.glob(f"{kind}_*.jpg")))
                check(n == N_FRAMES, f"replace disk {extra}: {n} {kind}")
    phase(f"bg_offline and replace from disk ({N_FRAMES} frames)", t0)
    return True


def fused_bg_read_phase(device, rows):
    """(a) K4 at the fused bg read: B segments of Lq 2040 over a ring bank
    of FUSED_BANK slots plus the previous frame (Lk 6120), the first
    bank_n slots valid; against the plain version, timed beside SDPA and
    the bound over the valid keys. Adds rows["attention"]["fused_bg"]."""
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka

    lq, dk, dv = ATTN_LQ, ATTN_DK, ATTN_DV
    lk = (FUSED_BANK + 1) * lq
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    out = {}
    err = rel = 0.0
    for b in (1, N_SEGMENTS):
        q, k, v = (torch.randn(*s, generator=gen, device=device)
                   for s in ((b, lq, dk), (b, lk, dk), (b, lk, dv)))
        for bank_n in range(FUSED_BANK + 1):
            valid = torch.tensor([s < bank_n or s == FUSED_BANK
                                  for s in range(FUSED_BANK + 1)],
                                 device=device)
            mask = valid.float().repeat_interleave(lq).expand(
                b, -1).contiguous()
            for g, t in zip(ka.masked_memory_attention(q, k, v, mask),
                            ka.attention_plain(q, k, v, mask)):
                e = held_close(f"fused bg read B {b} bank_n {bank_n}", g, t)
                err, rel = max(err, e[0]), max(rel, e[1])
            n_valid = int(mask[0].sum())
            bd = attn_bounds("fwd", b, lq, lk, n_valid, dk, dv)
            ms = cuda_ms(lambda: ka.masked_memory_attention(q, k, v, mask),
                         20)
            plain = cuda_ms(lambda: ka.attention_plain(q, k, v, mask), 3,
                            rounds=3)
            lib = sdpa_fwd_ms(q, k, v, mask, 3)
            out[f"b{b}_bank{bank_n}"] = dict(
                batch=b, lq=lq, lk=lk, valid_keys=n_valid, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bd["3xtf32"][0],
                bound_by=bd["3xtf32"][1], bound_f32_ms=bd["f32"][0])
            print(f"  K4 fused bg read B {b} x Lq {lq}, Lk {lk}, bank_n "
                  f"{bank_n} ({n_valid} valid keys): {ms:.4f} ms (plain "
                  f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound "
                  f"{bd['3xtf32'][0]:.4f} ms at 3xTF32 / {bd['f32'][0]:.4f} "
                  f"ms at f32)", flush=True)
    rows["attention"]["fused_bg"] = out
    rows["attention"]["max_abs_err"] = max(rows["attention"]["max_abs_err"],
                                           err)
    rows["attention"]["max_rel_err"] = max(rows["attention"]["max_rel_err"],
                                           rel)
    print(f"  fused bg reads: max |diff| {err:.3g} (relative {rel:.3g})",
          flush=True)


def fused_bg_pipes(cfg, types=("bf16", "f32"), **kw):
    """{"bf16": the shipped types, "f32": every net in float32} fused bg
    pipelines at 1080p -> 544x960 on the card."""
    import torch
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    f32 = dict(matting_dtype=torch.float32, stm_dtype=torch.float32,
               seg_dtype=torch.float32)
    return {k: FusedBgPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                               device="cuda", **(f32 if k == "f32" else {}),
                               **kw) for k in types}


def fused_bg_phase(frames, gts, stm_weights, matting_weights):
    """(b) fused bg (configs/bg.json with the chroma seed) on the 8 1080p
    frames in bfloat16 and float32, counts reset just before the bfloat16
    run; then float32 card against host on 2 smaller frames. Returns (the
    bfloat16 run's kernel counts, its pipeline)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    cfg = bg_config(stm_weights, matting_weights)
    pipes = fused_bg_pipes(cfg)
    check(pipes["bf16"].stm.model.kv_q.convs[0].weight.dtype
          == torch.bfloat16, "the fused bg STM is not bfloat16")
    alphas, counts = {}, None
    for k, pipe in pipes.items():
        pipe.run(frames[:2], **DEV_RESIZE)   # warm-up: cuDNN plans
        torch.cuda.synchronize()
        (a, segm, fg, bgs), secs, c = timed_run(pipe.run, frames,
                                                **DEV_RESIZE)
        if k == "bf16":
            counts = c
        check(a.shape == (N_FRAMES,) + pipe.work_hw and a.dtype == np.uint8
              and fg.shape == bgs.shape == a.shape + (3,)
              and segm.shape == a.shape, f"fused bg {k} output shapes")
        ious = gt_ious(a, gts, pipe.work_hw)
        st = pipe.stats
        print(f"  fused bg {k}, {N_FRAMES} frames 1080p -> 544x960: "
              f"{N_FRAMES / secs:.3f} frames/s; {st['syncs'] / N_FRAMES:.3f} "
              f"host syncs a frame ({st['cg_syncs']} CG checks, "
              f"{st['cg_iters']} CG iterations over {3 * N_FRAMES} "
              f"channel solves); tracked {st['tracked_frames']}, seeded "
              f"{st['seeded_frames']}, ballooned {st['ballooned_frames']}; "
              f"IoU {[round(v, 4) for v in ious]}, mean {np.mean(ious):.4f}; "
              f"(calls, launches) {c}", flush=True)
        check(ious[0] > 0.8 and np.mean(ious) > 0.75,
              f"fused bg {k} IoU with the ground truth {ious}")
        alphas[k] = a
    check_launched(counts, "fused bg", ("trimap", "morph", "flood",
                                        "attention"))
    agree = agreement(alphas["bf16"], alphas["f32"])
    print(f"  fused bg bfloat16 vs float32: alpha >= 128 agrees on "
          f"{min(agree):.6f} of pixels (worst frame)", flush=True)
    check(min(agree) >= BG_BF16_ALPHA_AGREE,
          f"fused bg bfloat16 vs float32 masks {agree}")
    phase(f"fused bg ({N_FRAMES} frames, bfloat16 and float32)", t0)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    small, _ = green_clip(N_CPU_FRAMES, *BG_HOST_HW, seed=SEED)
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    runs = {dev: FusedBgPipeline(
        cfg, BG_HOST_HW, work_long_side=BG_HOST_HW[1],
        matting_dtype=torch.float32, stm_dtype=torch.float32,
        seg_dtype=torch.float32, device=dev).run(small, **DEV_RESIZE)
        for dev in ("cuda", "cpu")}
    dmax, frac = within_bound(runs["cuda"][0], runs["cpu"][0])
    phase(f"fused bg host run ({N_CPU_FRAMES} frames at {BG_HOST_HW[0]}x"
          f"{BG_HOST_HW[1]})", t0)
    print(f"  fused bg float32 card vs host alphas: max |diff| {dmax}, "
          f"|diff| > 1 on {frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"fused bg card vs host alphas: max {dmax}, frac>1 {frac}")
    return counts, pipes["bf16"]


def fused_bg_segmented_run(pipe, frames, gts, label):
    """`run_segmented` with S = 8, chunks of 4 (bench.py's bg setting) on
    `frames`, after a one-step warm-up; returns (outputs, IoUs, kernel
    counts, the seed's forwards and frames in the timed run)."""
    import numpy as np
    import torch
    n = len(frames)
    pipe.run_segmented(frames[:N_SEGMENTS], N_SEGMENTS, SEG_CHUNK,
                       **DEV_RESIZE)
    torch.cuda.synchronize()
    seed = pipe.seg
    before = (seed.forwards, seed.frames) if seed is not None else (0, 0)
    out, secs, counts = timed_run(pipe.run_segmented, frames, N_SEGMENTS,
                                  SEG_CHUNK, **DEV_RESIZE)
    seeded = ((seed.forwards - before[0], seed.frames - before[1])
              if seed is not None else None)
    ious = gt_ious(out[0], gts, pipe.work_hw)
    st = pipe.stats
    seg_len = n // N_SEGMENTS
    print(f"  fused bg run_segmented {label}, S {N_SEGMENTS} x {seg_len} "
          f"frames, chunks of {SEG_CHUNK}: {n / secs:.3f} "
          f"frames/s; {st['syncs'] / n:.3f} host syncs a frame; tracked "
          f"{st['tracked_frames']}, seeded {st['seeded_frames']} in "
          f"{st['seed_steps']} seed steps, ballooned "
          f"{st['ballooned_frames']}; IoU min {min(ious):.4f} mean "
          f"{np.mean(ious):.4f}; (calls, launches) {counts}", flush=True)
    return out, ious, counts, seeded


def fused_bg_segmented_phase(pipe16, stm_weights, matting_weights):
    """(c) `run_segmented` as bench.py runs bg: S = 8, chunks of 4, 64
    frames (8-frame segments), bfloat16; then float32 with pass 1 at full
    resolution, segment 0 held to the sequential run of its frames within
    the JAX bound. Returns the bfloat16 run's kernel counts."""
    import numpy as np

    t0 = time.perf_counter()
    n = N_SEGMENTS * BG_SEG_FRAMES
    frames, gts = green_clip(n, *FRAME_HW, seed=SEED + 1)
    _, ious, counts, _ = fused_bg_segmented_run(pipe16, frames, gts,
                                                "bf16")
    check(ious[0] > 0.8 and np.mean(ious) > 0.75,
          f"fused bg run_segmented IoU {ious}")
    check_launched(counts, "fused bg run_segmented",
                   ("trimap", "morph", "flood", "attention"))
    cfg = bg_config(stm_weights, matting_weights)
    pipe32 = fused_bg_pipes(cfg, ("f32",), pass1_downscale=1)["f32"]
    (a_seg, _, _, _), _, _, _ = fused_bg_segmented_run(
        pipe32, frames, gts, "f32 pass 1 at 1")
    seq = pipe32.run(frames[:BG_SEG_FRAMES], **DEV_RESIZE)[0]
    dmax, frac = within_bound(a_seg[:BG_SEG_FRAMES], seq)
    print(f"  fused bg float32 segment 0 vs the sequential run of its "
          f"frames: max |diff| {dmax}, |diff| > 1 on {frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"fused bg segment 0 vs sequential: max {dmax}, frac>1 {frac}")
    phase(f"fused bg run_segmented (S {N_SEGMENTS}, {n} frames)", t0)
    return counts


def schp_phase(frame, stm_weights, matting_weights, rows):
    """(d) the SCHP seed at full width on seeded weights (the copy cannot
    hold the shipped ones): its time in float32 and bfloat16 at the work
    frame (each in its shipped layout), beside its operations and bound; card
    against host in float32 on a 270x480 frame at crop 473; then (c) with
    `binseg: human` on those weights, the seed's forwards against the
    frames that were not tracking or ballooned. Returns that run's kernel
    counts."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.agents.binseg import HumanSegAgent
    from video_unscreen_tpu_torch.models import human_parse

    t0 = time.perf_counter()
    agents = {"f32": HumanSegAgent(device="cuda", seed=SEED),
              "bf16": HumanSegAgent(device="cuda", seed=SEED,
                                    dtype=torch.bfloat16)}
    h, w = frame.shape[:2]
    crop = agents["f32"].input_size
    flops = net_flops(human_parse.SCHPHumanParser, (1, 3) + crop)
    out = dict(flops=flops, frame=[h, w], crop=list(crop))
    for name, rate in (("f32", F32_OPS_PER_S), ("bf16", BF16_OPS_PER_S)):
        agent = agents[name]
        ms = cuda_ms(lambda: agent.predict_mask_impl(frame), 5, rounds=5)
        out[name] = dict(ms=ms, bound_ms=flops / rate * 1e3)
        print(f"  SCHP seed {name} at {h}x{w} -> {crop[0]}x{crop[1]} "
              f"({flops / 1e9:.2f} GFLOP a frame): {ms:.3f} ms (bound "
              f"{flops / rate * 1e3:.3f} ms at {rate / 1e12:.0f} TFLOP/s)",
              flush=True)
    rows["schp"] = out
    m16 = agents["bf16"].predict_mask_impl(frame)
    check(m16.dtype == torch.float32 and bool(torch.isfinite(m16).all()),
          "bfloat16 SCHP masks not finite float32")

    torch.set_num_threads(os.cpu_count() or 1)
    small = torch.from_numpy(green_clip(1, *BG_HOST_HW, seed=SEED)[0][0])
    card = agents["f32"].predict_logits(small.to(torch.float32).cuda()).cpu()
    host = HumanSegAgent(device="cpu", seed=SEED).predict_logits(
        small.to(torch.float32))
    err = float((card - host).abs().max())
    scale = max(1.0, float(host.abs().max()))
    check(err <= 1e-4 * scale, f"SCHP card vs host logits: max |diff| "
          f"{err} (scale {scale})")
    top2 = host.topk(2, dim=0).values
    sure = (top2[0] - top2[1]) > 1e-3
    same = (card.argmax(0) > 0) == (host.argmax(0) > 0)
    check(bool(same[sure].all()), "SCHP card vs host masks differ where "
          "the top-two margin > 1e-3")
    print(f"  SCHP card vs host ({BG_HOST_HW[0]}x{BG_HOST_HW[1]} -> "
          f"{crop[0]}x{crop[1]}, float32): logits max |diff| {err:.3g} "
          f"(scale {scale:.3g}); masks equal on all {int(sure.sum())} "
          f"decided pixels ({int((~sure).sum())} within 1e-3)", flush=True)
    phase("SCHP seed (seeded weights), float32 and bfloat16", t0)

    t0 = time.perf_counter()
    cfg = bg_config(stm_weights, matting_weights)
    cfg["binseg"] = {"type": "human", "seed": SEED}
    pipe = fused_bg_pipes(cfg, ("bf16",))["bf16"]
    check(isinstance(pipe.seg, HumanSegAgent), "the fused bg seed is not "
          "SCHP")
    n = N_SEGMENTS * BG_SEG_FRAMES
    frames, gts = green_clip(n, *FRAME_HW, seed=SEED + 1)
    _, _, counts, got = fused_bg_segmented_run(
        pipe, frames, gts, "bf16, SCHP on seeded weights")
    seeded = pipe.step_seeded
    want = (sum(1 for t in seeded if any(t)), sum(sum(t) for t in seeded))
    check(got == want, f"SCHP seed forwards, frames {got}, want {want} from "
          f"the frames not tracking or ballooned")
    check(all(seeded[0]), "the SCHP seed did not run on every segment's "
          "first frame")
    print(f"  SCHP seed forwards, frames {got} (the steps with a segment "
          f"not tracking or ballooned, and those segments); random SCHP "
          f"masks change how often STM tracks, so these frames/s are not "
          f"the shipped weights' rate", flush=True)
    check_launched(counts, "fused bg with SCHP", ("trimap", "morph",
                                                  "flood"))
    phase(f"fused bg run_segmented with SCHP (S {N_SEGMENTS}, {n} frames)",
          t0)
    return counts


def scores_close(what, got, want, rtol=EVAL_RTOL):
    """Five (or more) scores of the card against the host's: |got - want|
    <= rtol * max(|want|, 1e-6) each; returns the largest relative
    difference."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    check(bool((rel <= rtol).all()), f"{what}: card {got.tolist()} vs host "
          f"{want.tolist()} (relative {rel.tolist()})")
    return float(rel.max())


def tie_pair(h, w):
    """Two components of equal area (tests/test_torch_metrics.py's tie,
    scaled): A, a 2 x 50 bar from the top, ends after B, a 10 x 10 square,
    so B has the smaller label and wins; A's prediction 100 leaves it at
    threshold 0.4. Returns (gt, pred, CONN if B wins, CONN if A wins)."""
    import numpy as np
    gt = np.zeros((h, w), np.float32)
    gt[0:50, 5:7] = 255.0
    gt[10:20, 60:70] = 255.0
    pred = gt.copy()
    pred[0:50, 5:7] = 100.0
    return gt, pred, 100 * (1.0 - 100.0 / 255.0) / 1000.0, 0.07


def evaluation_phase(device, alphas, gts, rows):
    """The evaluation protocol's device work on the green path's alphas
    against their GTs at 1080x1920 (`pipeline/evaluate.py:score_pair` and
    `ops/metrics.py:roi_sad`), counts reset just before: K3 11 calls a
    frame (4 launches a call), K2 2 (one launch each); K3 bit-exact on the
    thresholded intersections; ms a scored frame beside K3's 11 calls;
    the resize path (a 544x960 prediction) equal to the pre-resized pair;
    the equal-area tie; card vs host at 270x480. Returns the kernel
    counts of the scored frames."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch import runtime
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.ops import metrics as M
    from video_unscreen_tpu_torch.ops.kernels import connected as kcc
    from video_unscreen_tpu_torch.pipeline import evaluate

    t0 = time.perf_counter()
    gt8 = [g.astype(np.uint8) * 255 for g in gts]
    pred8 = list(runtime.resize_batch(
        [np.ascontiguousarray(a) for a in alphas], FRAME_HW))
    dev_pairs = [(torch.from_numpy(g).to(device, torch.float32),
                  torch.from_numpy(p).to(device, torch.float32))
                 for g, p in zip(gt8, pred8)]

    def score(g, p):
        return torch.cat([evaluate.score_pair(g, p),
                          M.roi_sad(g, p)[None]]).cpu().numpy()

    score(*dev_pairs[0])   # warm-up: cuDNN's plan of the 9x9 correlation
    torch.cuda.synchronize()
    (card, secs, counts) = timed_run(
        lambda: [score(g, p) for g, p in dev_pairs])
    n = len(dev_pairs)
    check(counts["flood"] == (11 * n, 44 * n),
          f"evaluation: K3 (calls, launches) {counts['flood']}, want "
          f"{(11 * n, 44 * n)}")
    check(counts["morph"] == (2 * n, 2 * n),
          f"evaluation: K2 (calls, launches) {counts['morph']}, want "
          f"{(2 * n, 2 * n)}")
    check(all(np.isfinite(c).all() for c in card), "evaluation: a score "
          "is not finite")
    check(all(0.0 <= c[0] <= 1.0 for c in card), "evaluation: MIOU outside "
          "[0, 1]")
    # K3 against its plain version on conn's 11 intersections of frame 0
    g, p = dev_pairs[0]
    inters = [((g / 255.0 >= float(t)) & (p / 255.0 >= float(t))).to(
        torch.float32) for t in M.thresholds()]
    for i, m in enumerate(inters):
        for got, want in zip(kcc.connected_components_compact(m),
                             kcc.cc_plain(m)):
            check(torch.equal(got, want), f"K3 differs from plain on conn's "
                  f"threshold {i} intersection at 1080x1920")
    k3_ms = cuda_ms(lambda: [kcc.connected_components_compact(m)
                             for m in inters], 5)
    b, by = bound(11 * FRAME_HW[0] * FRAME_HW[1] * 12,
                  11 * FRAME_HW[0] * FRAME_HW[1] * 2)
    rows["flood"]["evaluation"] = dict(
        calls_per_frame=11, launches_per_call=4, ms_11_calls=k3_ms,
        bound_ms_11_calls=b, bound_by=by)
    # the resize path: a 544x960 prediction against the 1080p GT, held to
    # the same pair resized beforehand
    small = runtime.resize_batch([pred8[0]], (544, 960))[0]
    big = torch.from_numpy(runtime.resize_batch([small], FRAME_HW)[0]).to(
        device, torch.float32)
    scores_close("evaluation: the resize path",
                 evaluate.evaluate_pair(gt8[0], small, device),
                 evaluate.score_pair(dev_pairs[0][0], big).cpu().numpy(),
                 rtol=1e-6)
    # the equal-area tie, at 1080x1920
    tg, tp, b_wins, a_wins = tie_pair(*FRAME_HW)
    tie = float(M.connectivity_error(torch.from_numpy(tg).to(device),
                                     torch.from_numpy(tp).to(device)))
    check(abs(tie - b_wins) < 1e-5 and abs(tie - a_wins) > 5e-3,
          f"evaluation: the tie's CONN {tie}, want {b_wins}")
    ms_frame = secs / n * 1e3
    phase(f"evaluation ({n} frames at {FRAME_HW[0]}x{FRAME_HW[1]})", t0)
    print(f"  evaluation at {FRAME_HW[0]}x{FRAME_HW[1]}: {ms_frame:.2f} ms a "
          f"scored frame (MIOU, SAD, MSE, GRAD, CONN and ROI SAD, one fetch), "
          f"K3's 11 calls {k3_ms:.3f} ms of device time (bound {b:.4f} ms "
          f"by {by}); mean scores {np.mean(card, axis=0).tolist()}; "
          f"(calls, launches) {counts}; tie CONN {tie:.6f}", flush=True)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    worst = 0.0
    for i in range(N_CPU_FRAMES):
        g = runtime.resize_batch([gt8[i]], EVAL_HOST_HW)[0]
        p = runtime.resize_batch([pred8[i]], EVAL_HOST_HW)[0]
        c = evaluate.evaluate_pair(g, p, "cuda")
        h_ = evaluate.evaluate_pair(g, p, "cpu")
        worst = max(worst, scores_close(f"evaluation frame {i}", c, h_))
    tg, tp, b_wins, _ = tie_pair(*EVAL_HOST_HW)
    c, h_ = (float(M.connectivity_error(torch.from_numpy(tg).to(d),
                                        torch.from_numpy(tp).to(d)))
             for d in (device, "cpu"))
    worst = max(worst, scores_close("evaluation tie", [c], [h_]))
    phase(f"evaluation host run ({N_CPU_FRAMES} frames and the tie at "
          f"{EVAL_HOST_HW[0]}x{EVAL_HOST_HW[1]})", t0)
    print(f"  evaluation card vs host: scores within {worst:.3g} relative "
          f"(bound {EVAL_RTOL})", flush=True)
    return counts, dict(ms_a_frame=ms_frame, k3_11_calls_ms=k3_ms,
                        card_vs_host_rel=worst)


def iseg_scene():
    """tests/test_iseg.py's BRS scene without cv2: a blue ellipse on
    bicubic noise, 128x128, and its adversarial clicks (a negative one
    inside the subject)."""
    import numpy as np
    from video_unscreen_tpu_torch.parallel.data_synth import (_fill_ellipse,
                                                              _resize_cubic)
    rng = np.random.RandomState(3)
    bg = _resize_cubic(rng.rand(16, 16, 3).astype(np.float32), 128,
                       128).clip(0, 1)
    mask = np.zeros((128, 128), np.float32)
    _fill_ellipse(mask, (64, 64), (36, 28), 20, 0, 360, 1.0)
    img = (mask[..., None] * np.array([0.2, 0.5, 0.8], np.float32)
           + (1 - mask[..., None]) * bg)
    return (img.clip(0, 1) * 255).astype(np.uint8), [(True, 64, 50),
                                                      (False, 64, 88)]


def timed_probs(agent, img, clicks, use_brs, reps=3):
    """(probabilities, mean wall ms a call after one warm-up call)."""
    import torch
    agent.predict_probs(img, clicks, use_brs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        probs = agent.predict_probs(img, clicks, use_brs)
    torch.cuda.synchronize()
    return probs, (time.perf_counter() - t0) / reps * 1e3


def iseg_phase(device, weights=None):
    """ISegAgent at its shipped input_long_side 800 with flip TTA on a 1080p
    frame: plain, and BRS at each insertion point (ms a call, L-BFGS
    iterations, evaluations, host syncs); card vs host at
    input_long_side 320 (plain and one-step BRS probabilities within 1e-3,
    masks on >= 99.9%; 20-step BRS masks on >= 99%); the MobileNetV2
    DeepLab's logits card vs host. `weights`: weights/iseg.msgpack, or
    None for seeded weights. Returns its numbers."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.agents.iseg import ISegAgent
    from video_unscreen_tpu_torch.models.deeplab import build_deeplab
    from video_unscreen_tpu_torch.models.precision import empty_module
    from video_unscreen_tpu_torch.parallel.train_stm import init_flax_like

    t0 = time.perf_counter()
    label = "shipped" if weights else "seeded"
    frames, gts = green_clip(1, *FRAME_HW, seed=SEED + 2)
    img, gt = frames[0], gts[0]
    ys, xs = np.nonzero(gt)
    clicks = [(True, int(ys.mean()), int(xs.mean())), (False, 80, 120)]
    out = {"weights": label}
    agents = {m: ISegAgent(weights, input_long_side=ISEG_LONG, with_brs=True,
                           insertion_mode=m, device=device)
              for m in ISEG_MODES}
    probs, ms = timed_probs(agents["after_aspp"], img, clicks, False)
    check(probs.shape == FRAME_HW and np.isfinite(probs).all(),
          f"ISeg plain probabilities {probs.shape}")
    out["plain_ms"] = ms
    print(f"  ISeg ({label} weights) {FRAME_HW[0]}x{FRAME_HW[1]} at "
          f"input_long_side {ISEG_LONG}, flip TTA: plain {ms:.2f} ms a call; "
          f"mask IoU with the GT {iou((probs * 255).astype(np.uint8), gt):.4f}",
          flush=True)
    for m, agent in agents.items():
        probs, ms = timed_probs(agent, img, clicks, True, reps=1)
        check(np.isfinite(probs).all(), f"ISeg BRS {m}: not finite")
        st = agent.brs_stats
        check(st["iterations"] == agent.brs_maxiter
              and st["syncs"] == st["iterations"] + st["linesearch_steps"],
              f"ISeg BRS {m}: stats {st}")
        out[f"brs_{m}"] = dict(ms=ms, **st)
        print(f"  ISeg BRS {m}: {ms:.2f} ms a call; {st['iterations']} "
              f"L-BFGS iterations, {st['evaluations']} function evaluations, "
              f"{st['syncs']} host syncs", flush=True)
    del agents
    phase(f"ISeg at input_long_side {ISEG_LONG} ({label} weights)", t0)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    agree = {}
    for kind, brs, iters in (("plain", False, 1), ("brs1", True, 1),
                             ("brs20", True, 20)):
        p = {d: ISegAgent(weights, input_long_side=ISEG_HOST_LONG,
                          brs_maxiter=iters, device=d).predict_probs(
                              img, clicks, brs) for d in ("cuda", "cpu")}
        diff = float(np.abs(p["cuda"] - p["cpu"]).max())
        same = float(((p["cuda"] > 0.5) == (p["cpu"] > 0.5)).mean())
        agree[kind] = dict(max_abs_diff=diff, mask_agree=same)
        if kind == "brs20":
            check(same >= ISEG_BRS20_AGREE, f"ISeg {kind} card vs host "
                  f"masks agree on {same}")
        else:
            check(diff <= 1e-3 and same >= ISEG_MASK_AGREE,
                  f"ISeg {kind} card vs host: max |diff| {diff}, masks "
                  f"agree on {same}")
    out["card_vs_host"] = agree
    # the MobileNetV2 DeepLab, seeded, at the seed's 513 crop
    net = empty_module(lambda: build_deeplab(variant="mobilenet"))
    init_flax_like(net, torch.Generator().manual_seed(SEED))
    net.eval()
    x = torch.from_numpy(np.random.RandomState(SEED).randn(
        1, 3, 513, 513).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(device)(x.to(device)).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(((got - want).abs() <= 1e-4 * want.abs()
                + 1e-4 * scale).all()),
          f"MobileNetV2 DeepLab card vs host: max |diff| {err} (scale "
          f"{scale})")
    out["mobilenet_deeplab"] = dict(max_abs_diff=err, scale=scale)
    phase(f"ISeg card vs host (input_long_side {ISEG_HOST_LONG}) and the "
          f"MobileNetV2 DeepLab", t0)
    print(f"  ISeg card vs host: {agree}; MobileNetV2 DeepLab logits max "
          f"|diff| {err:.3g} of {scale:.3g}", flush=True)
    return out


def click_contract_phase(weights):
    """tests/test_iseg.py:64-96 on the card with the shipped weights: the
    negative click inside the subject is missed by the plain prediction
    and met after 20 BRS steps, the click-miss loss falls, and the subject
    around the positive click stays foreground."""
    import numpy as np
    from video_unscreen_tpu_torch.agents.iseg import ISegAgent
    img, clicks = iseg_scene()
    agent = ISegAgent(weights, input_long_side=128, with_brs=True,
                      with_flip=False, brs_maxiter=20, device="cuda")
    p_plain = agent.predict_probs(img, clicks, use_brs=False)
    p_brs = agent.predict_probs(img, clicks, use_brs=True)

    def miss(p):
        return (1.0 - p[64, 50]) ** 2 + p[64, 88] ** 2

    mask = agent.forward(img, clicks)
    print(f"  click contract: plain p(neg) {p_plain[64, 88]:.4f}, BRS "
          f"p(pos) {p_brs[64, 50]:.4f} p(neg) {p_brs[64, 88]:.4f}, miss "
          f"loss {miss(p_plain):.4f} -> {miss(p_brs):.4f}, subject kept on "
          f"{(mask[56:72, 44:58] == 255).mean():.3f}; {agent.brs_stats}",
          flush=True)
    check(p_plain[64, 88] > 0.5, "click contract: the plain prediction "
          "already meets the negative click")
    check(p_brs[64, 50] > 0.5 and p_brs[64, 88] < 0.5,
          "click contract: BRS does not meet the clicks")
    check(miss(p_brs) < miss(p_plain), "click contract: BRS did not lower "
          "the click-miss loss")
    check((mask[56:72, 44:58] == 255).mean() > 0.8
          and set(np.unique(mask)) <= {0, 255},
          "click contract: the subject around the positive click is lost")


def app_protocol_phase(stm_weights, iseg_weights):
    """Scenario 3 of tools/run_app_protocol_torch.py on the card (STM
    propagation through a hard cut, ISeg re-seeding, scored), counts reset
    just before: K4 and K3 launched. Returns its counts."""
    import importlib.util
    import numpy as np
    spec = importlib.util.spec_from_file_location(
        "run_app_protocol_torch", ROOT / "tools" / "run_app_protocol_torch.py")
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    t0 = time.perf_counter()
    (rows, _), secs, counts = timed_run(
        proto.run_stm_iseg, "cuda", stm_weights or "none",
        iseg_weights or "none")
    phase(f"app protocol scenario 3 (STM {'shipped' if stm_weights else 'seeded'}, "
          f"ISeg {'shipped' if iseg_weights else 'seeded'})", t0)
    print(f"  scenario 3: {secs:.2f} s; (calls, launches) {counts}", flush=True)
    for name, mean, _ in rows:
        check(np.isfinite(mean).all(), f"scenario 3 {name}: scores {mean}")
    check_launched(counts, "scenario 3", ("flood", "attention"))
    return counts


def default_paths(device):
    """The default run: every phase but the DeepLab weights; returns
    (kernel counts by path, kernel rows)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    t0 = time.perf_counter()
    cfg = load_config(str(ROOT / "configs" / "green.json"))
    cfg["binseg"] = {"type": "chroma"}
    weights = ROOT / "weights" / "matting_unet.msgpack"
    check(weights.is_file(), f"the MattingUNet weights {weights} are missing")
    stm_weights = ROOT / "weights" / "stm.msgpack"
    check(stm_weights.is_file(), f"the STM weights {stm_weights} are missing")
    cfg["vmatting"]["model_path"] = str(weights)
    f32 = dict(matting_dtype=torch.float32, seg_dtype=torch.float32)
    pipe = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              device="cuda", **f32)
    check(pipe.work_hw == (544, 960), f"work res {pipe.work_hw}")
    phase(f"weights ({weights.relative_to(ROOT)})", t0)

    t0 = time.perf_counter()
    rows = morph_phase(device)
    rows.update(kernel_phase(device))
    bg_kernel_phase(device, rows)
    attention_bwd_phase(device, rows)
    train_read_phase(device, rows)
    phase("kernels vs plain", t0)

    t0 = time.perf_counter()
    frames, gts = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    phase("frames", t0)

    t0 = time.perf_counter()
    pipe.run(frames[:2], **DEV_RESIZE)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    phase("pipeline warm-up (2 frames)", t0)

    kernels.reset_counts()
    t0 = time.perf_counter()
    alphas, fgs, bgs = pipe.run(frames, **DEV_RESIZE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"green": kernels.counts()}
    phase("pipeline", t0)
    fps = N_FRAMES / dt
    print(f"  green 1080p -> 544x960, {N_FRAMES} frames: {fps:.2f} "
          f"frames/s; {pipe.stats['syncs'] / N_FRAMES:.3f} host syncs a "
          f"frame; (calls, launches) {counts['green']}", flush=True)
    check_launched(counts["green"], "green")
    check(alphas.shape == (N_FRAMES, 544, 960) and alphas.dtype == np.uint8,
          f"alphas {alphas.shape} {alphas.dtype}")
    check(fgs.shape == bgs.shape == (N_FRAMES, 544, 960, 3), "fg/bg shape")
    ious = gt_ious(alphas, gts, (544, 960))
    print(f"  IoU with the synthetic ground truth: min {min(ious):.4f} "
          f"mean {np.mean(ious):.4f}", flush=True)
    check(min(ious) > 0.75, f"IoU with the ground truth {ious}")

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    host = FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              device="cpu", **f32)
    h_alphas, _, _ = host.run(frames[:N_CPU_FRAMES], **DEV_RESIZE)
    dmax, frac = within_bound(alphas[:N_CPU_FRAMES], h_alphas)
    phase(f"host run ({N_CPU_FRAMES} frames)", t0)
    print(f"  card vs host alphas: max |diff| {dmax}, |diff| > 1 on "
          f"{frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"card vs host alphas: max {dmax}, frac>1 {frac}")
    counts["evaluation"], rows["evaluation"] = evaluation_phase(
        device, alphas, gts, rows)

    work = pipe._prep_frames(torch.from_numpy(frames[0][None]).to(device))[0]
    rows["seed"] = seed_phase(work, weights)
    t0 = time.perf_counter()
    counts["green_bf16"], pipe16 = green_bf16_phase(cfg, frames, gts, alphas)
    phase("green bfloat16", t0)
    counts["segmented"] = segmented_phase(pipe16, pipe)
    counts["wire_green"] = wire_green_phase(cfg, pipe16)
    del pipe16
    counts["green_modular"] = green_modular_phase(cfg, frames, gts)

    counts["bg"] = bg_phases(frames, gts, stm_weights, weights)
    t0 = time.perf_counter()
    fused_bg_read_phase(device, rows)
    phase("K4 at the fused bg read", t0)
    counts["fused_bg"], pipe_bg = fused_bg_phase(frames, gts, stm_weights,
                                                 weights)
    counts["fused_bg_segmented"] = fused_bg_segmented_phase(
        pipe_bg, stm_weights, weights)
    del pipe_bg
    counts["fused_bg_schp"] = schp_phase(work, stm_weights, weights, rows)
    counts["wire_fused_bg"] = wire_fused_bg_phase(stm_weights, weights)
    disk_phase(cfg, stm_weights, weights)
    offline_counts, offline = bg_offline_phase(frames, gts, stm_weights,
                                               weights)
    counts.update(offline_counts)
    counts.update(replace_and_agents_phase(frames, gts, offline))
    del offline
    bg_offline_disk_phase(stm_weights, weights)
    rows["iseg"] = iseg_phase(device)
    counts["app_stm_iseg"] = app_protocol_phase(str(stm_weights), None)
    counts["train"] = train_phases(stm_weights)
    return counts, rows


def iseg_paths(device):
    """`--paths iseg`: interactive segmentation with the shipped
    weights/iseg.msgpack (and no other weights file): K2-K4 against their
    plain versions, the ISeg phase, the click contract, the evaluation of
    ISeg's masks of the 8 green-screen frames against their GTs, and
    scenario 3 with seeded STM weights. Returns (kernel counts by path,
    kernel rows of K2-K4)."""
    import numpy as np
    from video_unscreen_tpu_torch.agents.iseg import ISegAgent

    weights = ROOT / "weights" / "iseg.msgpack"
    check(weights.is_file(), f"the ISeg weights {weights} are missing")
    t0 = time.perf_counter()
    rows = morph_phase(device)
    del rows["trimap"]   # no path of this run calls K1
    rows.update(kernel_phase(device))
    bg_kernel_phase(device, rows)
    phase("kernels vs plain (K2-K4)", t0)
    rows["iseg"] = iseg_phase(device, str(weights))
    t0 = time.perf_counter()
    click_contract_phase(str(weights))
    phase("click contract (shipped weights, 20 BRS steps)", t0)

    t0 = time.perf_counter()
    frames, gts = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    agent = ISegAgent(str(weights), input_long_side=ISEG_LONG, device=device)
    masks = []
    for f, g in zip(frames, gts):
        ys, xs = np.nonzero(g)
        masks.append(agent.forward(f, [(True, int(ys.mean()),
                                        int(xs.mean())), (False, 80, 120)]))
    ious = [iou(m, g) for m, g in zip(masks, gts)]
    phase(f"ISeg masks of {N_FRAMES} frames", t0)
    print(f"  ISeg masks (two clicks a frame) IoU with the GT: min "
          f"{min(ious):.4f} mean {np.mean(ious):.4f}", flush=True)
    counts = {}
    counts["evaluation"], rows["evaluation"] = evaluation_phase(
        device, np.stack(masks), gts, rows)
    counts["app_stm_iseg"] = app_protocol_phase(None, str(weights))
    return counts, rows


def green_deeplab_paths(device):
    """`--paths green_deeplab`: configs/green.json as shipped (the DeepLab
    seed, bfloat16) beside float32; returns (kernel counts by path, kernel
    rows of K1-K3)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.agents.binseg import SegAgent
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    t0 = time.perf_counter()
    cfg = load_config(str(ROOT / "configs" / "green.json"))
    seed_weights = ROOT / "weights" / "deeplab_binseg.msgpack"
    weights = ROOT / "weights" / "matting_unet.msgpack"
    for p in (seed_weights, weights):
        check(p.is_file(), f"the weights {p} are missing")
    check("type" not in cfg["binseg"] and cfg["binseg"]["model_path"],
          "configs/green.json no longer ships the DeepLab seed")
    cfg["binseg"]["model_path"] = str(seed_weights)
    cfg["vmatting"]["model_path"] = str(weights)
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    pipes = {k: FusedGreenPipeline(cfg, FRAME_HW,
                                   work_long_side=WORK_LONG_SIDE,
                                   matting_dtype=dt, seg_dtype=dt,
                                   device="cuda")
             for k, dt in types.items()}
    for k, pipe in pipes.items():
        check(isinstance(pipe.seg, SegAgent)
              and pipe.seg.model.cls_out.weight.dtype == types[k],
              f"{k}: the pipeline's seed is not the {k} DeepLab")
    phase(f"weights ({seed_weights.relative_to(ROOT)}, "
          f"{weights.relative_to(ROOT)})", t0)

    t0 = time.perf_counter()
    rows = morph_phase(device)
    rows.update(kernel_phase(device))
    phase("kernels vs plain (K1-K3)", t0)

    frames, gts = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    counts, alphas = {}, {}
    for k, pipe in pipes.items():
        t0 = time.perf_counter()
        pipe.run(frames[:2], **DEV_RESIZE)   # warm-up: cuDNN plans
        torch.cuda.synchronize()
        before = (pipe.seg.forwards, pipe.seg.frames)
        (a, _, _), secs, counts[f"deeplab_{k}"] = timed_run(
            pipe.run, frames, **DEV_RESIZE)
        seeded = check_seed_log(pipe, before, f"green_deeplab {k}")
        ious = gt_ious(a, gts, pipe.work_hw)
        alphas[k] = a
        phase(f"green DeepLab {k} ({N_FRAMES} frames)", t0)
        print(f"  green DeepLab {k}, {N_FRAMES} frames: "
              f"{N_FRAMES / secs:.2f} frames/s; seed forwards, frames "
              f"{seeded}; tracking by step {pipe.step_tracking}; IoU min "
              f"{min(ious):.4f} mean {np.mean(ious):.4f}; (calls, "
              f"launches) {counts[f'deeplab_{k}']}", flush=True)
        check(min(ious) > 0.75, f"green DeepLab {k} IoU {ious}")
        check_launched(counts[f"deeplab_{k}"], f"green DeepLab {k}")
    agree = agreement(alphas["bf16"], alphas["f32"])
    work = pipes["f32"]._prep_frames(
        torch.from_numpy(frames[0][None]).to(device))[0]
    seeds = {k: p.seg.predict_mask_impl(work).cpu().numpy()
             for k, p in pipes.items()}
    seed_agree = float((seeds["bf16"] == seeds["f32"]).mean())
    print(f"  bfloat16 vs float32 on the card: seed masks agree on "
          f"{seed_agree:.6f} of pixels, alpha >= 128 on {min(agree):.6f} "
          f"(worst frame)", flush=True)
    check(seed_agree >= BF16_SEED_AGREE,
          f"seed masks bf16 vs f32 {seed_agree}")
    check(min(agree) >= BF16_ALPHA_AGREE, f"alpha masks bf16 vs f32 {agree}")
    rows["seed"] = seed_rows({k: p.seg for k, p in pipes.items()}, work)

    t0 = time.perf_counter()
    n = N_SEGMENTS * SEG_FRAMES
    frames_s, gts_s = green_clip(n, *FRAME_HW, seed=SEED + 1)
    for k, pipe in pipes.items():
        pipe.run_segmented(frames_s[:N_SEGMENTS], N_SEGMENTS, SEG_FRAMES,
                           **DEV_RESIZE)
        torch.cuda.synchronize()
        before = (pipe.seg.forwards, pipe.seg.frames)
        (a, _, _), secs, counts[f"deeplab_segmented_{k}"] = timed_run(
            pipe.run_segmented, frames_s, N_SEGMENTS, SEG_FRAMES,
            **DEV_RESIZE)
        seeded = check_seed_log(pipe, before, f"green_deeplab S=8 {k}")
        ious = gt_ious(a, gts_s, pipe.work_hw)
        print(f"  run_segmented DeepLab {k}, S {N_SEGMENTS} x {SEG_FRAMES} "
              f"frames: {n / secs:.2f} frames/s; "
              f"{pipe.stats['syncs'] / n:.3f} host syncs a frame; seed "
              f"forwards, frames {seeded}; IoU min {min(ious):.4f} mean "
              f"{np.mean(ious):.4f}", flush=True)
        check(min(ious) > 0.75, f"run_segmented DeepLab {k} IoU {ious}")
        check_launched(counts[f"deeplab_segmented_{k}"],
                       f"run_segmented DeepLab {k}")
    phase(f"run_segmented DeepLab (S {N_SEGMENTS}, {n} frames)", t0)

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    small, _ = green_clip(N_CPU_FRAMES, *DEEPLAB_HOST_HW, seed=SEED)
    runs = {dev: FusedGreenPipeline(
        cfg, DEEPLAB_HOST_HW, work_long_side=DEEPLAB_HOST_LONG,
        matting_dtype=torch.float32, seg_dtype=torch.float32,
        device=dev).run(small, **DEV_RESIZE)[0] for dev in ("cuda", "cpu")}
    dmax, frac = within_bound(runs["cuda"], runs["cpu"])
    phase(f"DeepLab host run ({N_CPU_FRAMES} frames at "
          f"{DEEPLAB_HOST_HW[0]}x{DEEPLAB_HOST_HW[1]})", t0)
    print(f"  DeepLab float32 card vs host alphas: max |diff| {dmax}, "
          f"|diff| > 1 on {frac:.6f}", flush=True)
    check(dmax <= 4 and frac < 1e-3,
          f"DeepLab card vs host alphas: max {dmax}, frac>1 {frac}")
    return counts, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", choices=("default", "green_deeplab", "iseg"),
                    default="default")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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

    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.ops.kernels import build

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; paths "
          f"{args.paths}", flush=True)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    phase(f"build ({lib_path.name})", t0)

    if args.paths == "green_deeplab":
        counts, rows = green_deeplab_paths(device)
    elif args.paths == "iseg":
        counts, rows = iseg_paths(device)
    else:
        counts, rows = default_paths(device)

    for path, c in counts.items():
        for k in ("trimap", "morph"):
            check(c[k][0] == c[k][1], f"{path} path: {k} (calls, launches) "
                  f"{c[k]}, want one launch a call")
    print("  K1, K2 (calls, launches) per path: " + "; ".join(
        f"{path} trimap {c['trimap']}, morph {c['morph']}"
        for path, c in counts.items()), flush=True)

    out = []
    for c in kernels.COUNTERS:
        if c.name not in rows:
            continue
        row = {"library_ms": None, **rows[c.name]}
        by_path = {p: dict(zip(("calls", "launches"), n[c.name]))
                   for p, n in counts.items()}
        out.append(dict(name=c.name, route="cuda",
                        launches=sum(n["launches"] for n in by_path.values()),
                        calls=sum(n["calls"] for n in by_path.values()),
                        by_path=by_path, **row))
        check(out[-1]["launches"] > 0, f"kernel {c.name} was launched on "
              f"none of the paths")
    print(json.dumps({k: rows[k] for k in ("seed", "schp", "evaluation",
                                           "iseg") if k in rows}))
    print(f"total wall seconds: {time.perf_counter() - t_start:.1f}",
          flush=True)
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
