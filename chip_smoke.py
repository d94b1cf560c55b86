#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--paths default|green_deeplab|iseg|train|ranks|
                                   train_ranks|host_fetch|disk|protocol]

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
  15. the host fetch (after 7e): green (chroma seed, bfloat16, 1080p ->
     544x960, 16 frames; `run` in chunks of 8 and `run_segmented` S = 8 x
     2) and fused bg (configs/bg.json with the chroma seed, 8 frames,
     chunks of 4), each in the device, host and host-packed fetch
     (`fetch_fg`/`fetch`, `pack_d2h`), cuDNN deterministic, counts reset
     just before each run: alphas (and segmasks) bit-equal across the
     modes, packed artifacts bit-equal to unpacked, host fg and bg within
     a mean |diff| of 6 of the device's (printed); D2H bytes a frame,
     overflow fallbacks, the host reconstruction's ms a frame and frames/s
     on a line each; green's host-packed fetch also at a band budget of
     the whole plane (no overflow fallback, every plane unpacked on the
     host) beside the default budget (which the synthetic frames overflow,
     fallbacks > 0); `process_chunk` on one chunk uploaded by hand against
     `run` on its frames, outputs and carry bit-equal; K1-K3 launched on
     green and K1-K4 on bg; `tools/link_probe_torch.py`'s figures at 8 and
     64 MB;
  13. segments over ranks (after 15): the kernel library built above,
     two ranks spawned (`parallel/launch.py`) over `gloo`, both on the
     one card with their collectives on CUDA tensors: green (float32,
     chroma seed) and fused bg (bfloat16, STM on) `process_segments` of
     S = 4 segments x 2 frames at 1080p -> 544x960 on (data 2, model 1),
     counts reset in each rank just before its timed call: every rank's
     gathered outputs bit-equal to this process running the same two
     blocks, K1-K3 launched on every rank and K4 on every bg rank,
     frames/s by rank and overall; the DeepLab seed (seeded weights, 12
     crops of 513 at 544x960, float32) split over (data 1, model 2):
     scores within 1e-4 of the unsharded, masks equal wherever |p_fg -
     p_bg| > 1e-3, ms a call by rank; then one NCCL rank: green on the
     (1, 1) mesh, bit-equal to this process; the card's name and power
     limit beside each line; a rank that fails, dies or outlives the
     deadline fails the run;
  7g. the port's JPEG codec (`runtime/loader.cpp`, no library) on the
     card's host: the 8 frames encoded at quality 95 and decoded, the
     sha256 of the frames, the files and the decoded frames against
     CODEC_SHA256 (libjpeg's, pinned by tests/test_torch_codec.py), and
     the ms a 1080p frame of each at 1 thread and at `runtime.THREADS`;
  7f. disk: the 8 frames written as JPEGs, then
     `tools/unscreen/green_torch.py` (`--fused --segments 8 --wire
     yuv420`) and `bg_torch.py` (`--fused --segments 2 --wire yuv420`)
     through their `main`, counts reset just before each: K1-K3 launched
     (and K4 by bg), every artifact written,
     the decoded alphamasks within mean 8 of the returned alphas, frames/s
     with the read and the write;
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
  10b. the CLIs from disk: `tools/unscreen/bg_offline_torch.py` stages
     1,2,3 and then `--stages 3` (the store's resume) through `main`, counts
     reset just before (K1-K4 launched), then
     `tools/replace/replace_torch.py` on the store with and without
     `--harmonize`: every artifact written (both PNGs included), frames/s
     with the read and the write, and each MJPEG `.mp4` (the fg store's
     and the replacement's) read back by the port's probes with the
     expected frame count and size;
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
     64x64, clip_len 3), held by `card_vs_host`: the loss to 1e-4
     relative, the float32 gradients by their L2 error (GRAD_L2), the
     parameters to AdamW's first step on each device's own gradients,
     the BatchNorm statistics to 1e-4, and a TF32 control that must
     break the float32 bound;
  12. the four other trainers at their tools' defaults (`tool_defaults`,
     read from `tools/train_<family>_torch.py`: the MattingUNet (2, 2,
     2, 2), batch 16 at 128; DeepLabV3+ ResNet-50, 8 at 128; SCHP
     ResNet-101, 8 at 224 with `raw_uint8`; DistMaps ResNet-50, 8 at 128)
     from flax-like seeded weights (no weights file), 6 steps each on the
     port's batches, counts reset just before: every loss finite, steps/s
     over steps 2-6, peak memory and the card's name and power limit on
     one JSON line a family, each path's kernel counts all 0 (no TPU
     kernel's counterpart runs there); the checkpoint written by
     `save_variables`, read back by `read_msgpack` and the family's
     `load_*`, and the reloaded model's eval forward equal to the trained
     one's bit for bit (cuDNN deterministic for the two forwards); then
     each family's card-vs-host step (`family_card_vs_host`) at its
     tool's batch and size on stages (1, 1, 1, 1) (the ISeg's fixed
     ResNet-50 whole), dropout off, held as phase 9's and with the
     float64 gradients of the card to the host's to 1e-6;
  14. training over ranks (after 12): K4-K6 against their plain versions
     at an STM rank's read (4 items), then four ranks spawned over `gloo`
     on the one card as (data 2, model 2) (`parallel/tensor_parallel.py`:
     every leaf `param_shardings` splits held as its half), cuDNN
     deterministic and TF32 off: each family (the four above and the STM)
     at its tool's defaults (`tool_args`) from seeded weights, dropout on,
     3 steps on the batches every rank makes from SEED, counts reset in
     each rank just before; every rank's first-step loss to 1e-5 relative
     of this process stepping the whole batch; rank 0's whole gradients
     by GRAD_L2 and its BatchNorm statistics to 1e-5 of each tensor's max,
     against a float64 step of the same weights and batch (on the card;
     the STM's on the host, whose read is float32 only on the card) with
     each bound widened by twice this process's float32 error from it,
     and a planted fault, the first step with `sync_data_axis` undone
     (per-rank BatchNorm statistics and dropout draws), beyond that bound;
     K4, K5 and K6 one call a step on every STM rank, no kernel on the
     others; steps/s and peak memory by rank, the bytes of parameters and
     AdamW state each rank holds against one process's; then one NCCL
     rank on the (1, 1) mesh whose STM step is bit-equal to the mesh-less
     step it takes before (loss, gradients, statistics, updated
     parameters); the card's name and power limit beside each line.

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

`--paths protocol` runs the evaluation protocol's green rows at the
operating point of the JAX tables of record (results/protocol_960.md,
BGR wire; results/protocol_960_yuv420.md, I420 wire) and reads the same
two weights files as `--paths green_deeplab`: the build, K1-K3 against
their plain versions (K2's calls include the scoring's roi_sad), the 5
green clips of tools/make_eval_set_torch.py at 1080p, 12 frames each,
made here by the port's clip maker (one process a clip) and written as
JPEGs and PNG GTs, then for each wire every clip through
tools/run_eval_protocol_torch.py's own `run_mode` (fused green,
configs/green.json as shipped: the DeepLab seed, bfloat16; work long
side 960, chunks of 4; its alphas written as JPEGs) and `score_mode`
(`pipeline/evaluate.py:run` on the card), counts reset just before each
wire. One line a clip and wire (MIOU, SAD, MSE, GRAD, CONN, wall
seconds of the run) beside the JAX row (`PROTOCOL_JAX`); a clip more
than PROTOCOL_MIOU_TOL from its JAX row's MIOU fails the run. Its
kernels row lists K1-K3.

`--paths train` runs only the build and phase 12 (no weights file); its
kernels row is empty, since the trainers launch none of K1-K6.

`--paths ranks` runs the build, K1-K4 against their plain versions and
phase 13 alone (the matting and STM weights).

`--paths host_fetch` runs the build, K1-K4 against their plain versions
and phase 15 alone (the matting and STM weights).

`--paths disk` runs the build, K1-K4 against their plain versions, the
codec phase, 7f and 10b (the matting and STM weights).

`--paths train_ranks` runs the build, K4-K6 against their plain versions
(the bg and training reads of phase 3) and phase 14 alone; it needs no
weights file.

`--paths iseg` reads weights/iseg.msgpack and no other weights file: K2
(with the roi_sad call) and K3 and K4 against their plain versions, phase
11 with the shipped weights, the click contract of tests/test_iseg.py:
64-96 (20 BRS steps at 128), the evaluation phase on the ISeg masks of
the 8 frames (two clicks a frame) against their GTs, the bfloat16 agent's
masks of those frames against float32's (plain, flip TTA; agreement on
>= ISEG_BF16_AGREE of every frame), and scenario 3 with the shipped ISeg
and seeded STM weights. Its kernels row lists K2-K4.
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
ISEG_BF16_AGREE = 0.99      # bfloat16 against float32 masks on the card
EVAL_RTOL = 1e-4            # card vs host scores, relative
# the codec phase: the N_FRAMES frames of green_clip(..., seed=SEED) at
# FRAME_HW, their JPEG files at CODEC_QUALITY (cv2.imwrite's default) and
# those files decoded, each as sha256; libjpeg's, as
# tests/test_torch_codec.py checks against the JAX package's runtime
CODEC_QUALITY = 95
CODEC_SHA256 = {
    "frames": "8f845f52e51fe9fa5576b061490638268e"
              "8f0fe1937652f9c56a8f984cc4992a",
    "encoded": "08f166a9c0bba282df28b8cf65b94cc2fd"
               "b320a37cacb85d293c046537a2c102",
    "decoded": "3d2f44df8cbfb976d411e816a7cf734b2f"
               "1940a5632bf545f6beb3bfdb0159d2"}
CODEC_REPS = 3
# the green rows of the JAX package's tables of record at 1080p, work
# long side 960, 12 frames a clip: (MIOU, SAD, MSE, GRAD, CONN) by wire and
# clip, as results/protocol_960.md (BGR) and results/protocol_960_yuv420.md
# (I420) print them (tests/test_torch_eval_protocol.py holds this copy to
# them)
PROTOCOL_JAX = {
    "bgr": {
        "green1": (0.9884, 5.784, 2.0756, 17.802, 6.797),
        "green2": (0.9855, 6.569, 2.8020, 20.992, 7.972),
        "green_mblur": (0.7805, 31.448, 19.1237, 9.438, 46.904),
        "green_jpeg": (0.9751, 7.641, 3.4648, 28.352, 9.322),
        "green_twop": (0.9798, 8.924, 4.4790, 30.752, 11.243),
        "ALL": (0.9419, 12.073, 6.3890, 21.467, 16.448)},
    "yuv420": {
        "green1": (0.9798, 5.530, 2.5616, 20.415, 6.273),
        "green2": (0.9774, 6.940, 3.7082, 27.897, 8.484),
        "green_mblur": (0.7785, 31.772, 19.4589, 9.442, 47.391),
        "green_jpeg": (0.9650, 7.544, 3.8745, 28.934, 8.967),
        "green_twop": (0.9689, 10.690, 6.8567, 40.649, 13.556),
        "ALL": (0.9339, 12.495, 7.2920, 25.467, 16.934)}}
PROTOCOL_MIOU_TOL = 0.01    # a clip's MIOU against its JAX row
PROTOCOL_HW, PROTOCOL_FRAMES, PROTOCOL_CHUNK = (1080, 1920), 12, 4
PROTOCOL_WIRES = ("bgr", "yuv420")


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
    from video_unscreen_tpu_torch.parallel.train import make_optimizer
    from video_unscreen_tpu_torch.utils.checkpoint import load_stm, save_stm

    model = ts.make_stm_train_state("cuda", init_from=str(stm_weights))
    step = ts.make_stm_train_step(model, *make_optimizer(
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
    r = stm_card_vs_host(stm_weights)
    phase("stm train host step", t0)
    host_line("stm train", f"batch {TRAIN_HOST['batch']}, "
              f"{TRAIN_HOST['hw']}x{TRAIN_HOST['hw']}", r)
    return counts


# the four other trainers run at their tools' defaults (`tool_defaults`),
# TRAINER_STEPS steps each, the first a warm-up
TRAINERS = ("matting", "binseg", "human", "iseg")
TRAINER_STEPS = 6
# card vs host, float32 gradients (`card_vs_host`): (each tensor's L2
# error over its L2 norm, the whole gradient's), 2.2-3.2 times the largest
# of four seeds' readings (`tests/test_torch_train_cuda.py` on NVIDIA H100
# 80GB HBM3, 700 W); the card's step with TF32 on breaks the second by
# 4.7-18 times
GRAD_L2 = {"stm": (0.02, 6e-4), "matting": (0.05, 3e-3),
           "binseg": (0.02, 7.5e-3), "human": (0.025, 1.1e-2),
           "iseg": (0.15, 7.5e-2)}


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def tool_args(name):
    """The defaults of tools/train_<name>_torch.py, read from its own
    `parse_args([])`."""
    import importlib.util
    path = ROOT / "tools" / f"train_{name}_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.parse_args([])


def tool_defaults(name):
    """(batch, size, lr, steps): the defaults of
    tools/train_<name>_torch.py."""
    args = tool_args(name)
    return args.batch, args.size, args.lr, args.steps


@contextlib.contextmanager
def tf32_on():
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def card_vs_host(what, make, step_of, batch, lr, bounds, float64=None):
    """One train step on the card and on the host from the same weights
    on the same batch (`make(device)`: the model, dropout off; TF32 off,
    as `utils/device.py` keeps it), held together:
    - the loss to 1e-4 relative;
    - the float32 gradients (after the step's clip): each tensor's L2
      error within `bounds[0]` of its L2 norm plus 2e-6 of the model's
      largest |g| an entry, and the whole gradient's within `bounds[1]`
      of its norm (GRAD_L2). The max-norm rule of
      `tests/test_torch_train_stm.py:_grad_tol` does not hold here: the
      two devices' float32 gradients are each up to ~170 times it from
      float64 at these shapes, in tensors where TF32 lands no further
      off (a ReLU or max-pool decided differently by a rounding is a
      discrete change), while an L2 error sums over every entry;
    - the parameters after the step, entry by entry, to AdamW's first
      step on each device's own gradient: |p_card - p_host| <= 1e-6 +
      1e-4 |p| + lr |u(g_card) - u(g_host)|, u(g) = g / (|g| + 1e-8),
      Adam's first direction; no entry exempt (`flips` counts the entries
      whose directions differ beyond 1e-6 + 1e-4 |p|);
    - the BatchNorm statistics to 1e-4 of each tensor's max;
    - with `float64` (device -> its float64 gradients by name): the
      card's to the host's, each tensor to 1e-6 of its max;
    - the control: the card's step with TF32 on must break the whole
      gradient's bound.
    Returns the readings; a miss fails the run."""
    import torch

    def run(dev, control=False):
        model = make(dev)
        with tf32_on() if control else contextlib.nullcontext():
            loss = float(step_of(model)(batch))
        return model, loss, {n: p.grad.detach().cpu().double()
                             for n, p in model.named_parameters()}

    (card, c_loss, g_card), (host, h_loss, g_host) = run("cuda"), run("cpu")
    check(abs(c_loss - h_loss) <= 1e-4 * abs(h_loss),
          f"{what}: card loss {c_loss} vs host {h_loss}")
    gmax = max(float(g.abs().max()) for g in g_host.values())
    norm = sum(float(g.square().sum()) for g in g_host.values()) ** 0.5

    def whole(grads):
        return sum(float((grads[n] - g).square().sum())
                   for n, g in g_host.items()) ** 0.5 / norm

    out = dict(card_loss=c_loss, host_loss=h_loss, tensors=0.0,
               whole=whole(g_card) / bounds[1], flips=0, params=0.0,
               stats=0.0, float64=0.0)
    for n, g in g_host.items():
        tol = bounds[0] * float(g.norm()) + 2e-6 * gmax * g.numel() ** 0.5
        out["tensors"] = max(out["tensors"],
                             float((g_card[n] - g).norm()) / tol)
    host_p = dict(host.named_parameters())
    for n, p in card.named_parameters():
        want = host_p[n].detach().double()
        d = (p.detach().cpu().double() - want).abs()
        tight = 1e-6 + 1e-4 * want.abs()
        turn = lr * (g_card[n] / (g_card[n].abs() + 1e-8)
                     - g_host[n] / (g_host[n].abs() + 1e-8)).abs()
        out["flips"] += int((turn > tight).sum())
        out["params"] = max(out["params"], float((d / (tight + turn)).max()))
    host_b = dict(host.named_buffers())
    for n, b in card.named_buffers():
        if "running" in n:
            want = host_b[n]
            out["stats"] = max(out["stats"], float(
                (b.cpu() - want).abs().max() / want.abs().max()) / 1e-4)
    if float64 is not None:
        exact = {dev: float64(dev) for dev in ("cuda", "cpu")}
        for n, want in exact["cpu"].items():
            scale = float(want.abs().max())
            tol = 1e-6 * scale if scale > 0 else 1e-300
            out["float64"] = max(out["float64"], float(
                (exact["cuda"][n].cpu() - want).abs().max()) / tol)
    out["tf32_whole"] = whole(run("cuda", control=True)[2]) / bounds[1]
    torch.cuda.empty_cache()
    for key in ("tensors", "whole", "params", "stats", "float64"):
        check(out[key] <= 1.0, f"{what}: card vs host {key} beyond the "
              f"bound: {out}")
    check(out["tf32_whole"] > 1.0, f"{what}: the TF32 control stays "
          f"within the float32 bound: {out}")
    return out


def family_card_vs_host(name, seed=SEED):
    """The family's card-vs-host step (`card_vs_host`) at its tool's batch
    and size on the reduced model (`families.family(name).reduced`:
    stages (1, 1, 1, 1), the ISeg's fixed ResNet-50 whole), dropout off,
    with the float64 check. The batch is the family's maker's with float
    images (SCHP's normalized, not `raw_uint8`) given noise of 1e-2: a
    max-pool window whose maxima tie (a letterbox band, a clipped flat
    background) has no unique gradient, and torch's CPU and CUDA kernels
    route it to different elements."""
    import numpy as np
    from video_unscreen_tpu_torch.models.dropout import dropouts
    from video_unscreen_tpu_torch.parallel import families, train
    from video_unscreen_tpu_torch.parallel.train_human import CLIP_NORM

    fam = families.family(name)
    batch_size, size, lr, steps = tool_defaults(name)
    rng = np.random.RandomState(seed + 1)
    batch = fam.float_batch(rng, batch_size, (size, size))
    batch["img"] = batch["img"] + rng.randn(*batch["img"].shape).astype(
        np.float32) * 1e-2

    def make(dev):
        model = fam.state(dev, seed=seed, model=fam.reduced())
        for d in dropouts(model):
            d.rate = 0.0
        return model

    def float64(dev):
        model = make(dev).double()
        fam.loss(model, {k: v.double() if v.is_floating_point() else v
                         for k, v in train.batch_to_device(
                             batch, dev).items()}).backward()
        train.fill_missing_grads(model)
        if name == "human":
            train.clip_by_global_norm_(model, CLIP_NORM)
        return {n: p.grad.cpu() for n, p in model.named_parameters()}

    return card_vs_host(
        name, make, lambda m: fam.step(m, *train.make_optimizer(
            m, lr, steps), seed), batch, lr, GRAD_L2[name], float64)


def stm_card_vs_host(stm_weights, seed=SEED):
    """The STM's card-vs-host step (`card_vs_host`) from
    weights/stm.msgpack at TRAIN_HOST (its read runs K4-K6 on the card,
    float32 only: no float64 check)."""
    import numpy as np
    from video_unscreen_tpu_torch.parallel import train_stm as ts
    from video_unscreen_tpu_torch.parallel.train import make_optimizer

    batch = ts.make_clip_batch(np.random.RandomState(seed + 1),
                               TRAIN_HOST["batch"], (TRAIN_HOST["hw"],) * 2,
                               TRAIN_CLIP)
    return card_vs_host(
        "stm", lambda dev: ts.make_stm_train_state(
            dev, init_from=str(stm_weights)),
        lambda m: ts.make_stm_train_step(m, *make_optimizer(
            m, TRAIN_LR, TRAIN_STEPS)), batch, TRAIN_LR, GRAD_L2["stm"])


def host_line(what, shape, r):
    print(f"  {what} card vs host ({shape}): loss {r['card_loss']} vs "
          f"{r['host_loss']}; readings / bounds: float32 gradients, worst "
          f"tensor {r['tensors']:.4f}, whole {r['whole']:.4f} (TF32 on "
          f"{r['tf32_whole']:.2f}); float64 gradients {r['float64']:.4f}; "
          f"parameters {r['params']:.4f} ({r['flips']} entries whose Adam "
          f"direction differs); statistics {r['stats']:.4f}", flush=True)


def trainer_phase(name):
    """One family's trainer on the card at its tool's defaults: flax-like
    seeded weights, TRAINER_STEPS steps on the port's batches (made
    beforehand; the maker's own time is reported beside), every loss
    finite, steps/s over steps 2 on, peak memory; then `save_variables`,
    `read_msgpack` and the family's `load_*` into a fresh model, whose
    eval forward must equal the trained model's bit for bit (cuDNN in
    its deterministic mode for the two forwards). Returns the
    path's kernel counts, which must all be 0 (no TPU kernel's
    counterpart runs here)."""
    import tempfile

    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.parallel import families
    from video_unscreen_tpu_torch.parallel.train import (batch_to_device,
                                                         make_optimizer)
    from video_unscreen_tpu_torch.utils.checkpoint import (read_msgpack,
                                                           save_variables)

    fam = families.family(name)
    batch_size, size, lr, steps = tool_defaults(name)
    t0 = time.perf_counter()
    model = fam.state("cuda", seed=SEED, model=fam.full())
    step = fam.step(model, *make_optimizer(model, lr, steps), SEED)
    rng = np.random.RandomState(SEED)
    t1 = time.perf_counter()
    batches = [fam.make_batch(rng, batch_size, (size, size))
               for _ in range(TRAINER_STEPS)]
    maker_ms = (time.perf_counter() - t1) / TRAINER_STEPS * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses, secs = [], []
    for batch in batches:
        t1 = time.perf_counter()
        losses.append(float(step(batch)))   # reads the loss: synchronizes
        secs.append(time.perf_counter() - t1)
    counts = kernels.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"{name} train losses {losses}")
    steps_per_s = (TRAINER_STEPS - 1) / sum(secs[1:])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"{name}.msgpack"
        save_variables(path, model)
        mb = path.stat().st_size / 2 ** 20
        back = fam.full()
        back.load_state_dict(fam.load(read_msgpack(path)))
    back = back.to("cuda").eval()
    model.eval()
    sample = batch_to_device(batches[-1], "cuda")
    # cuDNN's deterministic algorithms: its default for a transposed
    # convolution (the MattingUNet's upsampling) sums with atomics, so two
    # forwards of one model can differ in the last bits
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        same = torch.equal(fam.forward(back, sample),
                           fam.forward(model, sample))
    check(same, f"{name}: the reloaded checkpoint's eval forward differs")
    phase(f"{name} train ({TRAINER_STEPS} steps, batch {batch_size} at "
          f"{size}x{size})", t0)
    print(json.dumps({
        "trainer": name, "batch": batch_size, "size": size,
        "steps_per_s": steps_per_s, "step_s": secs, "losses": losses,
        "peak_gib": peak, "maker_ms_per_batch": maker_ms,
        "checkpoint_mib": mb, "device": torch.cuda.get_device_name(0),
        "card": smi_line()}), flush=True)
    del model, back, step
    torch.cuda.empty_cache()
    return counts


def trainers_phases():
    """The MattingUNet, DeepLab, SCHP and DistMaps trainers on the card,
    each followed by its card-vs-host step; returns each path's counts."""
    import torch
    counts = {}
    torch.set_num_threads(os.cpu_count() or 1)
    for name in TRAINERS:
        counts[f"train_{name}"] = trainer_phase(name)
        check(all(n == (0, 0) for n in counts[f"train_{name}"].values()),
              f"the {name} trainer launched a kernel: "
              f"{counts[f'train_{name}']}")
        t0 = time.perf_counter()
        r = family_card_vs_host(name)
        phase(f"{name} train card vs host step", t0)
        host_line(name, "batch and size of the tool, stages (1, 1, 1, 1)"
                  if name != "iseg" else "batch and size of the tool", r)
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


HOST_FETCH_FRAMES, HOST_FETCH_BG_FRAMES = 16, 8
HOST_FETCH_S = 8                 # run_segmented: S = 8 x 2 frames
HOST_FETCH_MEAN_DIFF = 6.0       # host fg/bg against device: mean |diff|
FETCH_MODES = (("device", dict(pack_d2h=False)),
               ("host", dict(pack_d2h=False)),
               ("host_packed", dict(pack_d2h=True)))
# green's host-packed fetch again with a band budget of the whole plane:
# every frame unpacks on the host (the default budget of n / 16 overflows
# on the synthetic frames, and each plane is then fetched whole)
PACKED_WHOLE = "host_packed_whole"
LINK_PROBE_MB = (8, 64)


def add_counts(total, counts):
    """Kernel (calls, launches) of two runs added."""
    return {k: tuple(a + b for a, b in zip(total.get(k, (0, 0)), v))
            for k, v in counts.items()}


def fetch_run(pipe, fn, *args, **kwargs):
    """One run of a fetch mode, counts reset just before: (artifacts,
    seconds, kernel counts, the run's `StageTimer`)."""
    from video_unscreen_tpu_torch.utils.profiling import StageTimer
    timer = StageTimer()
    out, secs, counts = timed_run(fn, *args, timer=timer, **kwargs)
    return out, secs, counts, timer


def fetch_lines(what, n, secs, pipe, timer):
    """The mode's lines: frames/s, D2H bytes a frame, overflow fallbacks,
    the host reconstruction's ms a frame."""
    st = pipe.stats
    print(f"  {what}: {n / secs:.3f} frames/s", flush=True)
    print(f"  {what}: D2H bytes a frame {st['d2h_bytes'] / n:.1f}",
          flush=True)
    print(f"  {what}: overflow fallbacks {st['fallbacks']}", flush=True)
    print(f"  {what}: host reconstruction "
          f"{timer.times['reconstruct'] * 1e3 / n:.3f} ms a frame (unpack "
          f"{timer.times['fetch'] * 1e3 / n:.3f} ms a frame with the "
          f"fetch)", flush=True)


def mean_diff(a, b):
    import numpy as np
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).mean())


def fetch_checks(what, outs, n_alpha):
    """Across the fetch modes of one run: the first `n_alpha` artifacts
    (alpha, and segmask in bg) bit-equal, packed bit-equal to unpacked,
    host fg and bg within HOST_FETCH_MEAN_DIFF of the device's."""
    import numpy as np
    dev, host, packed = (outs[m] for m, _ in FETCH_MODES)
    for i in range(n_alpha):
        for m, o in (("host", host), ("host_packed", packed)):
            check(np.array_equal(o[i], dev[i]),
                  f"{what}: {m} artifact {i} differs from the device "
                  f"fetch's")
    for i, (a, b) in enumerate(zip(packed, host)):
        check(np.array_equal(a, b), f"{what}: packed artifact {i} differs "
              f"from unpacked")
    a = dev[0]
    print(f"  {what}: unknown band (0 < alpha < 255) "
          f"{float(((a > 0) & (a < 255)).mean()):.4f} of the pixels "
          f"(the packed budget {1 / 16:.4f} of a plane)", flush=True)
    diffs = [mean_diff(host[i], dev[i]) for i in range(n_alpha, len(dev))]
    print(f"  {what}: host against device fg, bg mean |diff| "
          f"{', '.join(f'{d:.4f}' for d in diffs)}", flush=True)
    check(max(diffs) < HOST_FETCH_MEAN_DIFF,
          f"{what}: host fg/bg mean |diff| {diffs}")


def carry_equal(what, got, want):
    import torch
    from torch.utils._pytree import tree_leaves
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        check(torch.equal(g, w), f"{what}: the carry differs from run's")


def host_fetch_phase(cfg, stm_weights, matting_weights):
    """15: the host fetch and the packed download. Green (chroma seed,
    bfloat16, 1080p -> 544x960, 16 frames; `run` in chunks of 8 and
    `run_segmented` S = 8 x 2) and fused bg (8 frames, chunks of 4), each
    in the device, host and host-packed fetch, cuDNN deterministic: alphas
    (and segmasks) bit-equal across the modes, packed artifacts bit-equal
    to unpacked, host fg and bg within a mean |diff| of 6 of the device's;
    D2H bytes a frame, overflow fallbacks, the host reconstruction's ms a
    frame and frames/s. Green host-packed twice: at the default band
    budget, which the synthetic frames overflow (fallbacks > 0), and at a
    budget of the whole plane (no fallback: every plane unpacked on the
    host), both bit-equal to unpacked. `process_chunk` on one chunk
    against `run` on its frames, bit-equal, carry included. The link probe
    at 8 and 64 MB.
    Returns the kernel counts of each pipeline's runs."""
    import importlib.util
    import numpy as np
    import torch
    from video_unscreen_tpu_torch import runtime
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline

    t0 = time.perf_counter()
    n, n_bg = HOST_FETCH_FRAMES, HOST_FETCH_BG_FRAMES
    frames, _ = green_clip(n, *FRAME_HW, seed=SEED + 2)
    bg_cfg = bg_config(stm_weights, matting_weights)
    counts = {"host_fetch_green": {}, "host_fetch_bg": {}}
    card = smi_line()
    with cudnn_exact():
        green = {m: FusedGreenPipeline(cfg, FRAME_HW,
                                       work_long_side=WORK_LONG_SIDE,
                                       fetch_fg=m.split("_")[0],
                                       device="cuda", **kw)
                 for m, kw in FETCH_MODES + ((PACKED_WHOLE,
                                              dict(pack_d2h=True)),)}
        h, w = green[PACKED_WHOLE].work_hw
        green[PACKED_WHOLE]._pack_capacity = h * w
        green["device"].run(frames[:2])   # warm-up: cuDNN plans
        for how, fn_args in (("run, chunks of 8", (n // 2,)),
                             (f"run_segmented S {HOST_FETCH_S} x "
                              f"{n // HOST_FETCH_S}", None)):
            outs, fallbacks = {}, {}
            for m, pipe in green.items():
                if fn_args is None:
                    out, secs, c, timer = fetch_run(
                        pipe, pipe.run_segmented, frames, HOST_FETCH_S,
                        n // HOST_FETCH_S)
                else:
                    out, secs, c, timer = fetch_run(pipe, pipe.run, frames,
                                                    *fn_args)
                counts["host_fetch_green"] = add_counts(
                    counts["host_fetch_green"], c)
                outs[m], fallbacks[m] = out, pipe.stats["fallbacks"]
                fetch_lines(f"green {how}, fetch {m}", n, secs, pipe, timer)
            fetch_checks(f"green {how}", outs, 1)
            check(all(np.array_equal(a, b) for a, b in zip(
                outs[PACKED_WHOLE], outs["host"])),
                f"green {how}: {PACKED_WHOLE} differs from unpacked")
            check(fallbacks[PACKED_WHOLE] == 0 < fallbacks["host_packed"],
                  f"green {how}: overflow fallbacks {fallbacks}: the whole "
                  f"budget must unpack every frame, the default overflow")

        ref = green["device"]
        work = torch.from_numpy(runtime.resize_batch(
            frames[:n // 2], ref.work_hw)).to("cuda")
        alphas, fgs, _ = ref.run(frames[:n // 2], n // 2)
        carry, outs = ref.process_chunk(ref.init_carry(), work)
        got = outs[0].cpu().numpy()
        check((got[..., 0] == alphas).all() and (got[..., 1:4] == fgs).all(),
              "green process_chunk differs from run")
        carry_equal("green process_chunk", carry, ref.carries[0])
        del green

        bg = {m: FusedBgPipeline(bg_cfg, FRAME_HW,
                                 work_long_side=WORK_LONG_SIDE,
                                 fetch=m.split("_")[0], device="cuda", **kw)
              for m, kw in FETCH_MODES}
        bg["device"].run(frames[:2])
        outs = {}
        for m, _ in FETCH_MODES:
            pipe = bg[m]
            out, secs, c, timer = fetch_run(pipe, pipe.run, frames[:n_bg], 4)
            counts["host_fetch_bg"] = add_counts(counts["host_fetch_bg"], c)
            outs[m] = out
            fetch_lines(f"fused bg run, chunks of 4, fetch {m}", n_bg, secs,
                        pipe, timer)
        fetch_checks("fused bg", outs, 2)
        ref = bg["device"]
        carry, (packed, _) = ref.process_chunk(ref.init_carry(), work[:4])
        got = packed.cpu().numpy()
        want = ref.run(frames[:4], 4)
        check(all((got[..., sl] == w).all() for sl, w in zip(
            (0, 1, slice(2, 5), slice(5, 8)), want)),
            "fused bg process_chunk differs from run")
        carry_equal("fused bg process_chunk", carry, ref.carries)
        del bg
    phase(f"host fetch (green {n} frames x 8 runs, fused bg {n_bg} x 3)",
          t0)
    print(f"  host fetch on {card}", flush=True)

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "link_probe_torch", ROOT / "tools" / "link_probe_torch.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for mb in LINK_PROBE_MB:
        r = probe.probe(mb, 5, "cuda")
        for line in probe.report(r).splitlines():
            print(f"  link probe {mb} MB: {line}", flush=True)
    phase("link probe", t0)
    for path, c in counts.items():
        check_launched(c, path, ("trimap", "morph", "flood") + (
            ("attention",) if path == "host_fetch_bg" else ()))
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


def sha256(data):
    import hashlib
    return hashlib.sha256(data).hexdigest()


def codec_phase():
    """7g. The port's JPEG codec on the card's host: the N_FRAMES frames
    encoded at CODEC_QUALITY and decoded, each stage's sha256 against
    CODEC_SHA256, and the ms a 1080p frame of the encode and the decode
    at 1 thread and at `runtime.THREADS` (the best of CODEC_REPS), on a
    JSON line with the card's name and power limit. Returns the line's
    figures."""
    import tempfile
    import numpy as np
    from video_unscreen_tpu_torch import runtime

    t0 = time.perf_counter()
    frames = np.stack(green_clip(N_FRAMES, *FRAME_HW, seed=SEED)[0])
    got = {"frames": sha256(frames.tobytes())}
    rows = {}
    with tempfile.TemporaryDirectory(prefix="vut_codec_") as d:
        paths = [str(Path(d, f"frame_{i:06d}.jpg")) for i in range(N_FRAMES)]
        runtime.encode_batch(paths, frames, quality=CODEC_QUALITY)
        phase("codec build and first encode", t0)
        got["encoded"] = sha256(b"".join(Path(p).read_bytes()
                                         for p in paths))
        got["decoded"] = sha256(runtime.decode_batch(paths).tobytes())
        for name, want in CODEC_SHA256.items():
            check(got[name] == want, f"codec: sha256 of the {name} "
                  f"{got[name]}, want libjpeg's {want}")
        for threads in sorted({1, runtime.THREADS}):
            enc, dec = [], []
            for _ in range(CODEC_REPS):
                t1 = time.perf_counter()
                runtime.encode_batch(paths, frames, quality=CODEC_QUALITY,
                                     threads=threads)
                enc.append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                runtime.decode_batch(paths, threads=threads)
                dec.append(time.perf_counter() - t1)
            rows[f"threads_{threads}"] = {
                "encode_ms_a_frame": min(enc) * 1e3 / N_FRAMES,
                "decode_ms_a_frame": min(dec) * 1e3 / N_FRAMES}
        rows["bytes_a_frame"] = sum(Path(p).stat().st_size
                                    for p in paths) / N_FRAMES
    print(json.dumps({"codec": rows, "frames": N_FRAMES, "hw": FRAME_HW,
                      "quality": CODEC_QUALITY, "sha256_equal": True,
                      "host_cpus": os.cpu_count(), "card": smi_line()}),
          flush=True)
    phase(f"codec ({N_FRAMES} frames at 1080p)", t0)
    return rows


def load_cli(rel):
    """A tool script of the repo as a module (its `main` takes argv)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_twice(main, args):
    """A CLI's `main(args)` run twice on the same clip: the first run
    cold (its wall seconds include the first weight read, the cuDNN plan
    builds and the cold file cache), then, counts reset just before, the
    timed one. Returns (the second run's result, cold seconds, warm
    seconds, its kernel counts)."""
    from video_unscreen_tpu_torch.ops import kernels
    t1 = time.perf_counter()
    main(args)
    cold = time.perf_counter() - t1
    kernels.reset_counts()
    t1 = time.perf_counter()
    out = main(args)
    return out, cold, time.perf_counter() - t1, kernels.counts()


def write_clip(root):
    """The N_FRAMES synthetic 1080p frames as JPEGs under
    root/src_img/clip."""
    import numpy as np
    from video_unscreen_tpu_torch import runtime
    frames, _ = green_clip(N_FRAMES, *FRAME_HW, seed=SEED)
    src = Path(root, "src_img", "clip")
    src.mkdir(parents=True)
    runtime.encode_batch([str(src / f"frame_{i:06d}.jpg")
                          for i in range(N_FRAMES)], np.stack(frames))


def disk_phase(green_cfg, stm_weights, matting_weights):
    """7f. The drivers from disk: the 8 synthetic 1080p frames written as
    JPEGs, then `tools/unscreen/green_torch.py --fused --segments 8 --wire
    yuv420` and `bg_torch.py` likewise with 2 segments through their
    `main`, counts reset just before each: K1-K3 launched (K1-K4 by bg,
    whose segments of 4 frames read STM's memory), every artifact there,
    the decoded alphamasks within mean 8 of the returned alphas, each
    CLI's cold wall seconds and its warm frames/s with the read and the
    write (`cli_twice`). Returns the counts by path."""
    import tempfile
    import numpy as np
    from video_unscreen_tpu_torch import runtime

    t0 = time.perf_counter()
    counts = {}
    # bg's segments of 4 frames, so that STM reads its memory (K4)
    segments = {"green": N_SEGMENTS, "bg": N_FRAMES // 4}
    with tempfile.TemporaryDirectory(prefix="vut_disk_") as root:
        write_clip(root)
        for mode, cfg in (("green", green_cfg),
                          ("bg", bg_config(stm_weights, matting_weights))):
            cfg_path = Path(root, f"{mode}.json")
            cfg_path.write_text(json.dumps(cfg))
            cli = load_cli(f"tools/unscreen/{mode}_torch.py")
            out, cold, secs, counts[f"disk_{mode}"] = cli_twice(
                cli.main, ["--cfg", str(cfg_path), "-vid", "clip",
                           "--data_root", root, "--fused", "--segments",
                           str(segments[mode]), "--wire", "yuv420"])
            check_launched(counts[f"disk_{mode}"], f"disk {mode}",
                           ("trimap", "morph", "flood") + (
                               ("attention",) if mode == "bg" else ()))
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
            print(f"  disk {mode} (--fused --segments {segments[mode]} --wire "
                  f"yuv420): cold {cold:.3f} s wall; warm "
                  f"{N_FRAMES / secs:.3f} frames/s with the read and the "
                  f"write; alphamask files within mean {err:.3f} "
                  f"of the alphas; (calls, launches) {counts[f'disk_{mode}']}"
                  f"; {smi_line()}", flush=True)
            check(err < 8.0, f"disk {mode}: alphamask mean |diff| {err}")
    phase(f"disk ({N_FRAMES} frames, green and bg)", t0)
    return counts


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


def check_video(path, frame_dir):
    """An MJPEG MP4 that `save_video` wrote of `frame_dir`, read back by
    the port's probes: as many frames as the directory has images of its
    first image's size (by name, each side rounded down to even), at that
    size."""
    from video_unscreen_tpu_torch.utils import video
    from video_unscreen_tpu_torch.utils.fileio import frame_hw
    sizes = [tuple(v & ~1 for v in frame_hw(str(f)))
             for f in sorted(Path(frame_dir).iterdir())
             if f.suffix in (".jpg", ".png")]
    n, hw = sizes.count(sizes[0]), sizes[0]
    check(Path(path).is_file(), f"no video {path}")
    got = (video.get_frame_count(str(path)), video.get_frame_size(str(path)))
    check(got == (n, hw), f"{path}: {got[0]} frames of {got[1]}, want {n} "
          f"of {hw}")
    print(f"  {Path(path).name}: {got[0]} frames of {hw[0]}x{hw[1]}, "
          f"{video.get_duration(str(path)):.3f} s, "
          f"{Path(path).stat().st_size} bytes", flush=True)


def bg_offline_disk_phase(stm_weights, matting_weights):
    """10b. The CLIs from disk: the 8 frames written as JPEGs,
    `tools/unscreen/bg_offline_torch.py` stages 1,2,3 and then `--stages
    3` (the resume from the store) through `main`, counts reset just
    before (K1-K4 launched), then `tools/replace/replace_torch.py` on the
    store, with and without `--harmonize`; every artifact written, both
    PNGs included, each CLI's cold wall seconds and its warm frames/s with
    the read and the write (`cli_twice`; the resume is timed warm once),
    and each `.mp4` read back by the port's probes. Returns the counts by
    path."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory(prefix="vut_offline_") as root:
        write_clip(root)
        cfg_path = Path(root, "bg.json")
        cfg_path.write_text(json.dumps(bg_config(stm_weights,
                                                 matting_weights)))
        offline = load_cli("tools/unscreen/bg_offline_torch.py")
        args = ["--cfg", str(cfg_path), "-vid", "clip", "--data_root", root]
        _, cold, secs, counts["disk_bg_offline"] = cli_twice(offline.main,
                                                             args)
        check_launched(counts["disk_bg_offline"], "disk bg_offline",
                       ("trimap", "morph", "flood", "attention"))
        t1 = time.perf_counter()
        resumed = offline.main(args + ["--stages", "3"])
        secs3 = time.perf_counter() - t1
        print(f"  disk bg_offline (stages 1,2,3): cold {cold:.3f} s wall; "
              f"warm {N_FRAMES / secs:.3f} frames/s with the read and the "
              f"write; the stage-3 resume "
              f"{N_FRAMES / secs3:.3f} frames/s; (calls, launches) "
              f"{counts['disk_bg_offline']}; {smi_line()}", flush=True)
        store = Path(root, "test_bg_step_img", "clip")
        for kind in ("segmask", "bg", "alphamask", "fg"):
            n = len(list(store.glob(f"{kind}_*.jpg")))
            check(n == N_FRAMES, f"bg_offline disk: {n} {kind} files")
        for name in ("always_bg.jpg", "ema_bg.png", "ema_seen.png"):
            check((store / name).is_file(), f"bg_offline disk: no {name}")
        check(len(resumed["alphas"]) == N_FRAMES, "stage-3 resume alphas")
        check_video(Path(root, "video", "clip_fg.mp4"), store)
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
        rep_cli = load_cli("tools/replace/replace_torch.py")
        for extra in ([], ["--harmonize"]):
            _, cold, secs, _ = cli_twice(rep_cli.main,
                                         ["--data_root", str(rep)] + extra)
            out = rep / "merge_test_img" / "test5_out5"
            for kind in ("res", "compare"):
                n = len(list(out.glob(f"{kind}_*.jpg")))
                check(n == N_FRAMES, f"replace disk {extra}: {n} {kind}")
            print(f"  disk replace {' '.join(extra) or '(plain)'}: cold "
                  f"{cold:.3f} s wall; warm {N_FRAMES / secs:.3f} frames/s "
                  f"with the read and the write", flush=True)
            # compare_* (twice as wide) sort first: res_* are left out
            check_video(rep / "video" / "compare_test5_out5.mp4", out)
    phase(f"bg_offline and replace from disk ({N_FRAMES} frames)", t0)
    return counts


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
    from video_unscreen_tpu_torch.parallel.train import init_flax_like

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


# segments over ranks: S x L 1080p frames; two gloo ranks share the card
RANK_SEGMENTS, RANK_SEG_LEN, N_RANKS = 4, 2, 2
RANKS_TIMEOUT = 420   # the parent's deadline for a spawn, seconds


def rank_clip():
    """The phase's (S, L, 1080, 1920, 3) uint8 segments, made from a seed
    (each rank makes its own copy)."""
    import numpy as np
    frames, _ = green_clip(RANK_SEGMENTS * RANK_SEG_LEN, *FRAME_HW,
                           seed=SEED + 3)
    return np.stack(frames).reshape(RANK_SEGMENTS, RANK_SEG_LEN, *FRAME_HW,
                                    3)


def ranks_pipe(kind):
    """The phase's pipelines: green float32 with the chroma seed (the
    default run's phase-4 configuration) or fused bg as shipped (bfloat16,
    STM on) with the chroma seed, at 1080p -> 544x960 on the card."""
    import torch
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline
    weights = ROOT / "weights" / "matting_unet.msgpack"
    if kind == "bg":
        cfg = bg_config(ROOT / "weights" / "stm.msgpack", weights)
        return FusedBgPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                               device="cuda")
    cfg = load_config(str(ROOT / "configs" / "green.json"))
    cfg["binseg"] = {"type": "chroma"}
    cfg["vmatting"]["model_path"] = str(weights)
    return FusedGreenPipeline(cfg, FRAME_HW, work_long_side=WORK_LONG_SIDE,
                              matting_dtype=torch.float32,
                              seg_dtype=torch.float32, device="cuda")


def cudnn_exact():
    """cuDNN's deterministic algorithms, for runs held bit for bit: its
    default float32 transposed convolution (the MattingUNet's upsampling)
    sums with atomics, and two runs of one process then differ at about
    one pixel in 10^7 (one fg value of S = 4 x 2 frames at 544x960)."""
    import torch
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def timed_segments(pipe, mesh, segments):
    """`process_segments` after a one-step warm-up (cuDNN plans), the
    counts reset just before the timed call and read just after; returns
    (outputs in numpy, seconds, kernel counts)."""
    import torch
    pipe.process_segments(mesh, segments[:, :1])
    torch.cuda.synchronize()
    outs, secs, counts = timed_run(pipe.process_segments, mesh, segments)
    return [o.cpu().numpy() for o in outs], secs, counts


def segments_rank(rank, n_ranks):
    """One gloo rank of the phase, on cuda:0 beside the other: green and
    fused bg `process_segments` on (data n, model 1), and the DeepLab
    seed's scores on (data 1, model n) (seeded weights, 12 crops of 513
    at 544x960), split over the model axis; cuDNN deterministic."""
    with cudnn_exact():
        return _segments_rank(n_ranks)


def _segments_rank(n_ranks):
    import torch
    from video_unscreen_tpu_torch.agents.binseg import SegAgent
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh

    segments = rank_clip()
    by_data = make_mesh(n_ranks, model_parallel=1)
    by_model = make_mesh(n_ranks)
    check(by_model.shape == {"data": 1, "model": n_ranks},
          f"make_mesh({n_ranks}) is {by_model.shape}")
    green = ranks_pipe("green")
    out = {"green": timed_segments(green, by_data, segments)}
    frame = green._prep_frames(torch.from_numpy(segments[0, :1]).cuda())
    seg = SegAgent(device="cuda", seed=SEED)
    axis = by_model.axis("model")
    seg.predict_scores(frame, axis)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = seg.predict_scores(frame, axis)
    torch.cuda.synchronize()
    out["deeplab"] = (scores.cpu().numpy(), time.perf_counter() - t0)
    del green, seg
    out["bg"] = timed_segments(ranks_pipe("bg"), by_data, segments)
    return out


def nccl_rank(rank):
    """The NCCL rank: green `process_segments` on the (1, 1) mesh of a
    one-rank NCCL job (the gathers run over NCCL)."""
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh
    with cudnn_exact():
        return timed_segments(ranks_pipe("green"), make_mesh(1),
                              rank_clip())


def one_process_blocks(pipe, segments, n_data):
    """The blocks of `segments` that the ranks of a data axis of `n_data`
    take, each run by `process_segments` on this process's one-rank mesh
    (no process group: from `init_carries` through `_step_batched`, no
    collective), cuDNN deterministic as the ranks run; in numpy."""
    import numpy as np
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1)
    with cudnn_exact():
        blocks = [[o.cpu().numpy() for o in pipe.process_segments(mesh, b)]
                  for b in np.split(segments, n_data)]
    return [np.concatenate(o) for o in zip(*blocks)]


def check_ranks_equal(what, got, want):
    import numpy as np
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what} output {i}: {g.shape} {g.dtype}, want {w.shape} "
              f"{w.dtype}")
        if not np.array_equal(g, w):
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            raise RuntimeError(f"{what} output {i} differs from the one-"
                               f"process run: max |diff| {d.max()} on "
                               f"{int((d > 0).sum())} values")


def ranks_phase(device):
    """13: segments over ranks. (a) two `gloo` ranks sharing the card,
    their collectives on CUDA tensors: green (float32, chroma seed) and
    fused bg (bfloat16, STM on, the shipped STM weights) `process_segments`
    of S = 4 segments x 2 frames at 1080p -> 544x960 on (data 2, model
    1), each rank's gathered outputs bit-equal to this process running the
    same two blocks; the DeepLab seed (seeded weights, 12 crops of 513 at
    544x960, float32) split over (data 1, model 2), each rank's scores
    within 1e-4 of the unsharded scores and the masks equal wherever
    |p_fg - p_bg| > 1e-3; K1-K3 launched on every rank, and K4 on every bg
    rank. (b) one NCCL rank: green on the (1, 1) mesh, equal to this
    process's run. Returns (kernel counts by rank path, the phase's
    numbers)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.agents.binseg import SegAgent
    from video_unscreen_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    card = smi_line()
    got = run_ranks(segments_rank, N_RANKS, (N_RANKS,), backend="gloo",
                    timeout=RANKS_TIMEOUT, collective_timeout=300,
                    threads=2)
    spawn_s = time.perf_counter() - t0
    phase(f"segments over {N_RANKS} gloo ranks on one card", t0)

    t0 = time.perf_counter()
    segments = rank_clip()
    n_frames = RANK_SEGMENTS * RANK_SEG_LEN
    counts, report = {}, {"card": card, "gloo_wall_s": spawn_s}
    for kind, names in (("green", ("trimap", "morph", "flood")),
                        ("bg", ("trimap", "morph", "flood", "attention"))):
        pipe = ranks_pipe(kind)
        want = one_process_blocks(pipe, segments, N_RANKS)
        del pipe
        fps = []
        for r, res in enumerate(got):
            outs, secs, c = res[kind]
            check_ranks_equal(f"{kind} rank {r}", outs, want)
            check_launched(c, f"{kind} rank {r}", names)
            counts[f"ranks_{kind}_r{r}"] = c
            fps.append(n_frames / N_RANKS / secs)
        overall = n_frames / max(res[kind][1] for res in got)
        report[kind] = {"fps_by_rank": fps, "fps": overall}
        print(f"  {kind} over {N_RANKS} gloo ranks on one card, S "
              f"{RANK_SEGMENTS} x {RANK_SEG_LEN} frames at 1080p -> "
              f"544x960: bit-equal to one process; frames/s by rank "
              f"{[round(f, 3) for f in fps]}, overall {overall:.3f}; (calls,"
              f" launches) by rank "
              f"{[counts[f'ranks_{kind}_r{r}'] for r in range(N_RANKS)]}; "
              f"{card}", flush=True)

    pipe = ranks_pipe("green")
    frame = pipe._prep_frames(torch.from_numpy(segments[0, :1]).cuda())
    del pipe
    seg = SegAgent(device="cuda", seed=SEED)
    seg.predict_scores(frame)   # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    whole = seg.predict_scores(frame)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t1
    whole = whole.cpu().numpy()
    sure = np.abs(whole[..., 1] - whole[..., 0]) > 1e-3
    errs = []
    for r, res in enumerate(got):
        scores, _ = res["deeplab"]
        err = float(np.abs(scores - whole).max())
        errs.append(err)
        check(err <= 1e-4 * max(1.0, float(np.abs(whole).max())),
              f"DeepLab rank {r}: sharded scores max |diff| {err}")
        same = scores.argmax(-1) == whole.argmax(-1)
        check(bool(same[sure].all()), f"DeepLab rank {r}: masks differ "
              f"where |p_fg - p_bg| > 1e-3")
    ms = [1e3 * res["deeplab"][1] for res in got]
    report["deeplab"] = {"ms_by_rank": ms, "ms_one_process": 1e3 * whole_s,
                         "max_abs_err": max(errs)}
    print(f"  DeepLab seed (seeded weights, 12 crops of 513 at 544x960, "
          f"float32) over {N_RANKS} model ranks: scores max |diff| "
          f"{max(errs):.3g} from the unsharded, masks equal on all "
          f"{int(sure.sum())} decided pixels; ms a call by rank "
          f"{[round(m, 2) for m in ms]}, one process {1e3 * whole_s:.2f}; "
          f"{card}", flush=True)
    del seg
    phase("segments over ranks: one-process references", t0)

    t0 = time.perf_counter()
    (outs, secs, c), = run_ranks(nccl_rank, 1, backend="nccl",
                                 timeout=RANKS_TIMEOUT)
    pipe = ranks_pipe("green")
    check_ranks_equal("green NCCL rank", outs,
                      one_process_blocks(pipe, segments, 1))
    del pipe
    check_launched(c, "green NCCL rank")
    counts["ranks_nccl_green_r0"] = c
    report["nccl_green"] = {"fps": n_frames / secs,
                            "wall_s": time.perf_counter() - t0}
    print(f"  green on a one-rank NCCL mesh: bit-equal to one process; "
          f"{n_frames / secs:.3f} frames/s; (calls, launches) {c}; {card}",
          flush=True)
    phase("segments over one NCCL rank", t0)
    return counts, report


# training over ranks (phase 14): four gloo ranks share the card as
# (data 2, model 2); every family at its tool's defaults from seeded
# weights, dropout on, TRAIN_RANK_STEPS steps, the first a warm-up
TRAIN_RANKS, TRAIN_RANK_STEPS = 4, 3
TRAIN_RANK_FAMILIES = ("matting", "binseg", "human", "iseg", "stm")
TRAIN_RANKS_TIMEOUT = 600   # the parent's deadline for a spawn, seconds
READ = ("attention", "attention_bwd_dq", "attention_bwd_dkv")


def rank_family(name):
    """(family, the phase's batches, lr, steps, batch size, size) at the
    family's tool's defaults, the batches made from SEED (every rank makes
    the whole batch, as the tool does)."""
    import numpy as np
    from video_unscreen_tpu_torch.parallel import families
    fam = families.family(name)
    args = tool_args(name)
    kw = {"clip_len": args.clip_len} if name == "stm" else {}
    rng = np.random.RandomState(SEED)
    batches = [fam.make_batch(rng, args.batch, (args.size, args.size), **kw)
               for _ in range(TRAIN_RANK_STEPS)]
    return fam, batches, args.lr, args.steps, args.batch, args.size


def family_steps(name, mesh=None, whole=True, stepped=False):
    """The family's TRAIN_RANK_STEPS steps on the card, over `mesh` (this
    rank's part) or in this process, counts reset just before the first:
    the first step's loss, and with `whole` its gradients (gathered whole)
    and BatchNorm statistics, on the host; with `stepped` the parameters
    and statistics after its update; every loss, the step seconds, the
    kernel counts (per step and in all), peak memory, and the bytes of
    parameters and AdamW state held."""
    import torch
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.parallel.tensor_parallel import (
        full_grads, full_state_dict, held_bytes)
    from video_unscreen_tpu_torch.parallel.train import make_optimizer

    fam, batches, lr, steps, _, _ = rank_family(name)
    model = fam.state("cuda", seed=SEED, model=fam.full(), mesh=mesh)
    opt, sched = make_optimizer(model, lr, steps)
    step = fam.step(model, opt, sched, SEED, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    out, secs, per_step = {}, [], []
    for i, batch in enumerate(batches):
        before = kernels.counts()
        t0 = time.perf_counter()
        if i == 0:
            loss = float(step.value_and_grad(batch))
            grads = full_grads(model)
            if whole:   # copies, in numpy: a rank's tensors die with it
                out["grads"] = {n: host_copy(g) for n, g in grads.items()}
                out["stats"] = {n: host_copy(b)
                                for n, b in model.named_buffers()
                                if "running" in n}
            del grads
            step.apply()
            if stepped:
                out["stepped"] = {n: host_copy(t) for n, t in
                                  full_state_dict(model).items()}
            out["held"] = held_bytes(model, opt)
            torch.cuda.synchronize()
            out["loss"], out["losses"] = loss, [loss]
        else:
            out["losses"].append(float(step(batch)))   # synchronizes
        secs.append(time.perf_counter() - t0)
        after = kernels.counts()
        per_step.append({k: tuple(a - b for a, b in zip(after[k], before[k]))
                         for k in READ})
    out.update(counts=kernels.counts(), secs=secs, per_step=per_step,
               steps_per_s=(len(secs) - 1) / sum(secs[1:]),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def host_copy(t):
    return t.detach().to("cpu", copy=True).numpy()


def unsynced_grads(name, mesh, whole):
    """Phase 14's planted fault: the family's first step over `mesh` with
    `sync_data_axis` undone (every BatchNorm's statistics over this rank's
    block alone, as DDP takes them, and every dropout drawing for its block
    alone); with `whole`, its gradients gathered whole, on the host."""
    from video_unscreen_tpu_torch.models.batchnorm import FlaxBatchNorm2d
    from video_unscreen_tpu_torch.models.dropout import dropouts
    from video_unscreen_tpu_torch.parallel.tensor_parallel import full_grads
    from video_unscreen_tpu_torch.parallel.train import make_optimizer
    fam, batches, lr, steps, _, _ = rank_family(name)
    model = fam.state("cuda", seed=SEED, model=fam.full(), mesh=mesh)
    for mod in model.modules():
        if isinstance(mod, FlaxBatchNorm2d):
            mod.data_sum, mod.data_ranks = None, 1
    for mod in dropouts(model):
        mod.data_block = (0, 1)
    step = fam.step(model, *make_optimizer(model, lr, steps), SEED,
                    mesh=mesh)
    step.value_and_grad(batches[0])
    grads = full_grads(model)
    out = {n: host_copy(g) for n, g in grads.items()} if whole else None
    del model, step, grads
    return out


def train_ranks_rank(rank, n_ranks, names):
    """One gloo rank of phase 14, on cuda:0 beside the others: the
    families' steps on the (data 2, model 2) mesh, cuDNN deterministic,
    then each family's planted fault (`unsynced_grads`); rank 0 returns
    the first step's whole gradients and statistics, and the fault's
    gradients."""
    import torch
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh
    with cudnn_exact():
        mesh = make_mesh(n_ranks)
        out = {"mesh": dict(mesh.shape), "coords": dict(mesh.coords)}
        for name in names:
            out[name] = family_steps(name, mesh, whole=rank == 0)
        for name in names:
            out[name]["unsynced"] = unsynced_grads(name, mesh, rank == 0)
            torch.cuda.empty_cache()
        return out


def nccl_train_rank(rank):
    """The NCCL rank: the STM's steps without a mesh, then on the (1, 1)
    mesh of this one-rank NCCL job, in this one process. Returns the
    meshed run's readings, both first-step losses, and the names whose
    gradients, statistics or updated parameters differ by a bit."""
    import numpy as np
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh
    with cudnn_exact():
        plain = family_steps("stm", stepped=True)
        meshed = family_steps("stm", make_mesh(1), stepped=True)
    differ = {key: [n for n, w in plain[key].items()
                    if not np.array_equal(meshed[key][n], w)]
              for key in ("grads", "stats", "stepped")}
    return {"loss": meshed["loss"], "plain_loss": plain["loss"],
            "differ": differ, "n_grads": len(plain["grads"]),
            "steps_per_s": meshed["steps_per_s"], "counts": meshed["counts"]}


def grads_l2(got, want, bounds, exact=None):
    """(worst tensor, whole) L2 error of the gradients `got` against
    `want` over `card_vs_host`'s bounds (GRAD_L2): each tensor's within
    bounds[0] of its norm plus 2e-6 of the largest |g| an entry, the whole
    within bounds[1] of its norm. With `exact` (float64 gradients of the
    same step) both are held to `exact` instead, each bound widened by
    twice `want`'s own error from it (`tests/torch_train_util.py`'s rule:
    a float32 result within float32's noise of the float64 one)."""
    import numpy as np
    ref = want if exact is None else exact
    gmax = max(float(np.abs(g).max()) for g in ref.values())
    norm = sum(float(np.square(g, dtype=np.float64).sum())
               for g in ref.values()) ** 0.5
    worst = whole = own = 0.0
    for n, w in ref.items():
        w = w.astype(np.float64)
        d = float(np.linalg.norm(got[n].astype(np.float64) - w))
        e = 0.0 if exact is None else float(np.linalg.norm(
            want[n].astype(np.float64) - w))
        whole, own = whole + d * d, own + e * e
        tol = bounds[0] * float(np.linalg.norm(w)) \
            + 2e-6 * gmax * w.size ** 0.5 + 2 * e
        worst = max(worst, d / tol)
    return worst, whole ** 0.5 / (bounds[1] * norm + 2 * own ** 0.5)


def stats_rel(got, want, exact=None):
    """The largest |got - want| of a statistic over 1e-5 of its max
    |want|; with `exact` (the float64 step's), |got - exact| over 1e-5 of
    max |exact| plus twice `want`'s own largest error from it."""
    import numpy as np
    if exact is None:
        return max(float(np.abs(got[n] - w).max() / np.abs(w).max())
                   for n, w in want.items()) / 1e-5
    return max(float(np.abs(got[n] - x).max()) / (
        1e-5 * float(np.abs(x).max())
        + 2 * float(np.abs(want[n] - x).max())) for n, x in exact.items())


def float64_step(name):
    """The family's first step in float64 in this process (the float32
    steps' reference): its gradients and statistics. On the card, but the
    STM's on the host: its read on the card (K4-K6) is float32 only."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.parallel.train import make_optimizer
    fam, batches, lr, steps, _, _ = rank_family(name)
    device = "cpu" if name == "stm" else "cuda"
    if device == "cpu":
        torch.set_num_threads(os.cpu_count() or 1)
    model = fam.state(device, seed=SEED, model=fam.full()).double()
    step = fam.step(model, *make_optimizer(model, lr, steps), SEED)
    step.value_and_grad({k: v.astype(np.float64) if v.dtype == np.float32
                         else v for k, v in batches[0].items()})
    out = {"grads": {n: host_copy(p.grad)
                     for n, p in model.named_parameters()},
           "stats": {n: host_copy(b) for n, b in model.named_buffers()
                     if "running" in n}}
    del model, step
    torch.cuda.empty_cache()
    return out


def rank_read_check(device):
    """K4, K5 and K6 at an STM rank's read (the batch over the data axis:
    TRAIN_BATCH / 2 items of Lq 64 over Lk 128, every key valid) against
    their plain versions."""
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    b = TRAIN_BATCH // 2
    tq = (TRAIN_HW // 16) ** 2
    tk = (TRAIN_CLIP - 1) * tq
    q, k, v, do = (torch.randn(*s, generator=gen, device=device)
                   for s in ((b, tq, ATTN_DK), (b, tk, ATTN_DK),
                             (b, tk, ATTN_DV), (b, tq, ATTN_DV)))
    mask = torch.ones(b, tk, device=device)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    errs = [held_close("rank read out", out, want_out),
            held_close("rank read lse", lse, want_lse)]
    a = (q, k, v, mask, do, want_lse, (do * want_out).sum(dim=-1))
    got = (ka.attention_bwd_dq(*a), *ka.attention_bwd_dkv(*a))
    want = ka.attention_bwd_plain(q, k, v, mask, want_out, want_lse, do)
    errs += [held_bwd(f"rank read item {i}", [g[i] for g in got],
                      [w[i] for w in want], mask[i], do[i], v[i])
             for i in range(b)]
    return max(e[0] for e in errs)


def train_ranks_phase(device, names=TRAIN_RANK_FAMILIES):
    """14: training over ranks. (a) four `gloo` ranks sharing the card as
    (data 2, model 2): each family of `names` (the STM among them) at its
    tool's defaults (`tool_args`) from seeded weights, dropout on,
    TRAIN_RANK_STEPS steps, against this process stepping the whole batch
    from the same weights (cuDNN deterministic, TF32 off in both): every
    rank's first-step loss to 1e-5 relative; rank 0's whole gradients by
    GRAD_L2 and its BatchNorm statistics to 1e-5 of each tensor's max,
    against the float64 step of the same weights and batch (`float64_step`)
    with each bound widened by twice one process's float32 error from it
    (`grads_l2`, `stats_rel`: at the tools' full widths, and for the STM
    on seeded weights, one process's float32 gradients are themselves
    beyond GRAD_L2 from float64), and the same first step with
    `sync_data_axis` undone (`unsynced_grads`) beyond that bound; K4, K5
    and K6 one call a step on every STM rank, no kernel on the others; steps/s and peak memory by rank,
    the bytes of parameters and AdamW state each rank holds against one
    process's. (b) one NCCL rank on the (1, 1) mesh: the STM's first step
    (loss, gradients, statistics, updated parameters) bit-equal to the
    mesh-less step of the same process (`nccl_train_rank`). Returns
    (kernel counts by rank path, the phase's numbers)."""
    import numpy as np
    import torch
    from video_unscreen_tpu_torch.ops.kernels import attention as ka
    from video_unscreen_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    card = smi_line()
    tq = (TRAIN_HW // 16) ** 2
    tk = (TRAIN_CLIP - 1) * tq
    read_err = rank_read_check(device)
    print(f"  K4-K6 at an STM rank's read ({TRAIN_BATCH // 2} x Lq {tq}, "
          f"Lk {tk}): max |diff| from plain {read_err:.3g}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = run_ranks(train_ranks_rank, TRAIN_RANKS, (TRAIN_RANKS, names),
                    backend="gloo", timeout=TRAIN_RANKS_TIMEOUT,
                    collective_timeout=300, threads=2)
    gloo_s = time.perf_counter() - t0
    phase(f"training over {TRAIN_RANKS} gloo ranks on one card", t0)
    check(all(r["mesh"] == {"data": 2, "model": 2} for r in got),
          f"phase 14 mesh {got[0]['mesh']}")

    counts, report = {}, {"card": card, "gloo_wall_s": gloo_s}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name in names:
        t0 = time.perf_counter()
        with cudnn_exact():
            one = family_steps(name)
        r0 = got[0][name]
        for r, res in enumerate(got):
            loss = res[name]["loss"]
            check(abs(loss - one["loss"]) <= 1e-5 * abs(one["loss"]),
                  f"{name} rank {r}: loss {loss} vs one process "
                  f"{one['loss']}")
            check(all(np.isfinite(res[name]["losses"])),
                  f"{name} rank {r} losses {res[name]['losses']}")
            counts[f"train_ranks_{name}_r{r}"] = res[name]["counts"]
        exact = float64_step(name)
        worst, whole = grads_l2(r0["grads"], one["grads"], GRAD_L2[name],
                                exact["grads"])
        plain = grads_l2(r0["grads"], one["grads"], GRAD_L2[name])
        stats = stats_rel(r0["stats"], one["stats"], exact["stats"])
        check(worst <= 1.0 and whole <= 1.0, f"{name}: rank 0's gradients "
              f"beyond the bound: worst tensor {worst}, whole {whole}")
        check(stats <= 1.0, f"{name}: rank 0's statistics {stats} of the "
              f"bound")
        fault = grads_l2(r0["unsynced"], one["grads"], GRAD_L2[name],
                         exact["grads"])
        check(max(fault) > 1.0, f"{name}: the planted fault (sync_data_axis "
              f"undone) reads {fault} of the bound: the check cannot see it")
        if name == "stm":
            want = {"attention": (1, 2),
                    "attention_bwd_dq": (1, 1 + (ka.dq_splits(
                        TRAIN_BATCH // 2, tq, tk, n_sm) > 1)),
                    "attention_bwd_dkv": (1, 1)}
            for r, res in enumerate(got):
                for n in res[name]["per_step"]:
                    check(n == want, f"stm rank {r} step launched {n}, "
                          f"want {want} a step")
        else:
            for r, res in enumerate(got):
                check(all(c == (0, 0) for c in res[name]["counts"].values()),
                      f"{name} rank {r} launched a kernel")
        row = {"steps_per_s_by_rank": [res[name]["steps_per_s"]
                                       for res in got],
               "steps_per_s_one_process": one["steps_per_s"],
               "peak_gib_by_rank": [res[name]["peak_gib"] for res in got],
               "peak_gib_one_process": one["peak_gib"],
               "held_bytes_by_rank": [res[name]["held"] for res in got],
               "held_bytes_one_process": one["held"],
               "loss": r0["loss"], "loss_one_process": one["loss"],
               "grads_worst_tensor": worst, "grads_whole": whole,
               "grads_vs_one_process_grad_l2": plain, "stats": stats,
               "unsynced_fault": fault}
        report[name] = row
        print(f"  {name} over (data 2, model 2), 4 gloo ranks on one card, "
              f"batch {tool_args(name).batch} at {tool_args(name).size}: "
              f"steps/s by rank "
              f"{[round(v, 3) for v in row['steps_per_s_by_rank']]} (one "
              f"process {one['steps_per_s']:.3f}); peak GiB by rank "
              f"{[round(v, 3) for v in row['peak_gib_by_rank']]} (one "
              f"process {one['peak_gib']:.3f}); parameters + AdamW bytes "
              f"by rank {row['held_bytes_by_rank']} (one process "
              f"{one['held']}); first-step loss {r0['loss']} vs "
              f"{one['loss']}; readings / bounds against the float64 "
              f"step: gradients worst tensor "
              f"{worst:.4f}, whole {whole:.4f}, statistics {stats:.4f} "
              f"(against one process by GRAD_L2 alone: {plain[0]:.4f}, "
              f"{plain[1]:.4f}); the planted fault (sync_data_axis undone) "
              f"reads worst tensor {fault[0]:.4f}, whole {fault[1]:.4f}; "
              f"{card}", flush=True)
        phase(f"{name}: one-process reference steps", t0)
        del one, exact

    t0 = time.perf_counter()
    (nccl,) = run_ranks(nccl_train_rank, 1, backend="nccl",
                        timeout=TRAIN_RANKS_TIMEOUT)
    check(nccl["loss"] == nccl["plain_loss"], f"stm NCCL rank loss "
          f"{nccl['loss']} vs the mesh-less step's {nccl['plain_loss']}")
    check(not any(nccl["differ"].values()), f"stm NCCL rank: differs "
          f"from the mesh-less step at {nccl['differ']}")
    counts["train_ranks_nccl_stm_r0"] = nccl["counts"]
    report["nccl_stm"] = {"steps_per_s": nccl["steps_per_s"],
                          "wall_s": time.perf_counter() - t0}
    print(f"  stm on a one-rank NCCL (1, 1) mesh: first step bit-equal to "
          f"the mesh-less step in the same process (loss, "
          f"{nccl['n_grads']} gradients, statistics, updated parameters); "
          f"{nccl['steps_per_s']:.3f} steps/s; (calls, launches) "
          f"{nccl['counts']}; {card}", flush=True)
    phase("training over one NCCL rank", t0)
    report["phase_s"] = time.perf_counter() - t_phase
    return counts, report


def train_ranks_paths(device):
    """`--paths train_ranks`: K4-K6 against their plain versions (the
    kernels phase's reads), then phase 14 alone. Returns (kernel counts
    by rank path, kernel rows of K4-K6)."""
    t0 = time.perf_counter()
    rows = kernel_phase(device)
    bg_kernel_phase(device, rows)
    del rows["flood"]   # no path of this run calls K3
    attention_bwd_phase(device, rows)
    train_read_phase(device, rows)
    phase("kernels vs plain (K4-K6)", t0)
    counts, rows["train_ranks"] = train_ranks_phase(device)
    return counts, rows


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
    counts.update(host_fetch_phase(cfg, stm_weights, weights))
    ranks_counts, rows["ranks"] = ranks_phase(device)
    counts.update(ranks_counts)
    rows["codec"] = codec_phase()
    counts.update(disk_phase(cfg, stm_weights, weights))
    offline_counts, offline = bg_offline_phase(frames, gts, stm_weights,
                                               weights)
    counts.update(offline_counts)
    counts.update(replace_and_agents_phase(frames, gts, offline))
    del offline
    counts.update(bg_offline_disk_phase(stm_weights, weights))
    rows["iseg"] = iseg_phase(device)
    counts["app_stm_iseg"] = app_protocol_phase(str(stm_weights), None)
    counts["train"] = train_phases(stm_weights)
    counts.update(trainers_phases())
    train_counts, rows["train_ranks"] = train_ranks_phase(device)
    counts.update(train_counts)
    return counts, rows


def ranks_paths(device):
    """`--paths ranks`: K1-K4 against their plain versions, then phase 13
    alone. Returns (kernel counts by rank path, kernel rows of K1-K4)."""
    t0 = time.perf_counter()
    rows = morph_phase(device)
    rows.update(kernel_phase(device))
    bg_kernel_phase(device, rows)
    phase("kernels vs plain (K1-K4)", t0)
    counts, rows["ranks"] = ranks_phase(device)
    return counts, rows


def matting_paths_setup(device):
    """What `--paths disk` and `--paths host_fetch` share: the green config
    with chroma binseg and the shipped matting weights, the STM weights,
    and K1-K4 against their plain versions. Returns (cfg, STM weights,
    matting weights, kernel rows of K1-K4)."""
    from video_unscreen_tpu_torch.config import load_config
    t0 = time.perf_counter()
    cfg = load_config(str(ROOT / "configs" / "green.json"))
    cfg["binseg"] = {"type": "chroma"}
    weights = ROOT / "weights" / "matting_unet.msgpack"
    stm_weights = ROOT / "weights" / "stm.msgpack"
    for w in (weights, stm_weights):
        check(w.is_file(), f"the weights {w} are missing")
    cfg["vmatting"]["model_path"] = str(weights)
    rows = morph_phase(device)
    rows.update(kernel_phase(device))
    bg_kernel_phase(device, rows)
    phase("kernels vs plain (K1-K4)", t0)
    return cfg, stm_weights, weights, rows


def disk_paths(device):
    """`--paths disk`: K1-K4 against their plain versions, the codec phase,
    7f and 10b. Returns (kernel counts by path, kernel rows of K1-K4)."""
    cfg, stm_weights, weights, rows = matting_paths_setup(device)
    rows["codec"] = codec_phase()
    counts = disk_phase(cfg, stm_weights, weights)
    counts.update(bg_offline_disk_phase(stm_weights, weights))
    return counts, rows


def host_fetch_paths(device):
    """`--paths host_fetch`: K1-K4 against their plain versions, then
    phase 15 alone. Returns (kernel counts by path, kernel rows of
    K1-K4)."""
    cfg, stm_weights, weights, rows = matting_paths_setup(device)
    return host_fetch_phase(cfg, stm_weights, weights), rows


def iseg_paths(device):
    """`--paths iseg`: interactive segmentation with the shipped
    weights/iseg.msgpack (and no other weights file): K2-K4 against their
    plain versions, the ISeg phase, the click contract, the evaluation of
    ISeg's masks of the 8 green-screen frames against their GTs, and
    scenario 3 with seeded STM weights. Returns (kernel counts by path,
    kernel rows of K2-K4)."""
    import numpy as np
    import torch
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

    t0 = time.perf_counter()
    agent16 = ISegAgent(str(weights), input_long_side=ISEG_LONG,
                        dtype=torch.bfloat16, device=device)
    agree = []
    for f, g, m in zip(frames, gts, masks):
        ys, xs = np.nonzero(g)
        m16 = agent16.forward(f, [(True, int(ys.mean()), int(xs.mean())),
                                  (False, 80, 120)])
        agree.append(float((m16 == m).mean()))
    phase(f"ISeg bfloat16 masks of {N_FRAMES} frames", t0)
    print(f"  ISeg bfloat16 against float32 masks (plain, flip TTA): "
          f"agree on min {min(agree):.6f} mean {np.mean(agree):.6f} of "
          f"pixels", flush=True)
    check(min(agree) >= ISEG_BF16_AGREE,
          f"ISeg bfloat16 masks against float32 {agree}")
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


def protocol_check(wire, vid, miou):
    """A green clip's MIOU against its row of the JAX table of record
    (`PROTOCOL_JAX`): raises when they are more than PROTOCOL_MIOU_TOL
    apart; returns the difference."""
    want = PROTOCOL_JAX[wire][vid][0]
    d = miou - want
    check(abs(d) <= PROTOCOL_MIOU_TOL, f"protocol {wire} green {vid}: MIOU "
          f"{miou:.4f} is {d:+.4f} from the JAX row's {want:.4f} (bound "
          f"{PROTOCOL_MIOU_TOL})")
    return d


def protocol_phase(cfg_path, root):
    """The protocol's green rows on the card, through
    tools/run_eval_protocol_torch.py: the 5 green clips made under `root`
    by tools/make_eval_set_torch.py, then for each wire the tool's
    `run_mode` on each clip (fused green, its alphas written as JPEGs) and
    its `score_mode` (`pipeline/evaluate.py:run` on the card), the kernel
    counts reset just before the wire and read just after. Returns (kernel
    counts by wire, the rows: wire -> clip -> the five scores and the
    run's seconds)."""
    import shutil

    import numpy as np
    import torch
    from glob import glob
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.pipeline.evaluate import KEYS

    vids = [v for v in PROTOCOL_JAX["bgr"] if v != "ALL"]
    t0 = time.perf_counter()
    maker = load_cli("tools/make_eval_set_torch.py")
    maker.make_clips(root, set(vids), PROTOCOL_FRAMES, *PROTOCOL_HW,
                     workers=len(vids))
    phase(f"protocol clips ({len(vids)} x {PROTOCOL_FRAMES} frames at "
          f"{PROTOCOL_HW[0]}x{PROTOCOL_HW[1]}, one process a clip)", t0)
    tool = load_cli("tools/run_eval_protocol_torch.py")
    results_dir = os.path.join(root, "results")
    os.makedirs(results_dir)
    counts, rows = {}, {}
    for wire in PROTOCOL_WIRES:
        t0 = time.perf_counter()
        shutil.rmtree(os.path.join(root, "test_green_img"),
                      ignore_errors=True)
        kernels.reset_counts()
        secs = {}
        for vid in vids:
            t1 = time.perf_counter()
            tool.run_mode("green", root, [vid], cfg_path,
                          work_long_side=WORK_LONG_SIDE,
                          chunk=PROTOCOL_CHUNK, wire=wire, device="cuda")
            torch.cuda.synchronize()
            secs[vid] = time.perf_counter() - t1
            n = [len(glob(os.path.join(root, sub, vid, tmpl)))
                 for sub, tmpl in (("alpha_img", "*.*"),
                                   ("test_green_img", "alphamask_*.*"))]
            check(n == [PROTOCOL_FRAMES] * 2, f"protocol {wire} {vid}: "
                  f"{n[0]} GTs, {n[1]} predictions")
        scores = tool.score_mode("green", root, vids, results_dir,
                                 suffix=f"_{wire}", device="cuda")
        torch.cuda.synchronize()
        counts[f"protocol_{wire}"] = kernels.counts()
        phase(f"protocol {wire} ({len(vids)} clips)", t0)
        check_launched(counts[f"protocol_{wire}"], f"protocol {wire}")
        secs["ALL"] = float(np.mean(list(secs.values())))
        rows[wire] = {vid: [scores[vid][k] for k in KEYS] + [secs[vid]]
                      for vid in vids + ["ALL"]}
        for vid, m in rows[wire].items():
            want = PROTOCOL_JAX[wire][vid]
            check(all(np.isfinite(m)) and 0.0 <= m[0] <= 1.0,
                  f"protocol {wire} {vid}: scores {m}")
            print(f"  protocol {wire} green {vid}: MIOU {m[0]:.4f} SAD "
                  f"{m[1]:.3f} MSE {m[2]:.4f} GRAD {m[3]:.3f} CONN "
                  f"{m[4]:.3f}; {m[5]:.2f}s; JAX MIOU {want[0]:.4f} "
                  f"({m[0] - want[0]:+.4f})", flush=True)
        print(f"  protocol {wire}: (calls, launches) "
              f"{counts[f'protocol_{wire}']}", flush=True)
    for wire in PROTOCOL_WIRES:   # every row printed before any raise
        for vid in vids:
            protocol_check(wire, vid, rows[wire][vid][0])
    return counts, rows


def protocol_paths(device):
    """`--paths protocol`: configs/green.json as shipped (its weights by
    their paths in the checkout), K1-K3 against their plain versions, then
    the protocol phase. Returns (kernel counts by wire, kernel rows of
    K1-K3 and the protocol's rows)."""
    import tempfile
    from video_unscreen_tpu_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "green.json"))
    seed_weights = ROOT / "weights" / "deeplab_binseg.msgpack"
    weights = ROOT / "weights" / "matting_unet.msgpack"
    for p in (seed_weights, weights):
        check(p.is_file(), f"the weights {p} are missing")
    check("type" not in cfg["binseg"] and cfg["binseg"]["model_path"],
          "configs/green.json no longer ships the DeepLab seed")
    cfg["binseg"]["model_path"] = str(seed_weights)
    cfg["vmatting"]["model_path"] = str(weights)
    t0 = time.perf_counter()
    rows = morph_phase(device)
    rows.update(kernel_phase(device))
    phase("kernels vs plain (K1-K3)", t0)
    with tempfile.TemporaryDirectory(prefix="protocol_") as root:
        cfg_path = os.path.join(root, "green.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        counts, rows["protocol"] = protocol_phase(cfg_path, root)
    return counts, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", choices=("default", "green_deeplab", "iseg",
                                        "train", "ranks", "train_ranks",
                                        "host_fetch", "disk",
                                        "protocol"),
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
    elif args.paths == "train":
        counts, rows = trainers_phases(), {}
    elif args.paths == "ranks":
        counts, rows = ranks_paths(device)
    elif args.paths == "train_ranks":
        counts, rows = train_ranks_paths(device)
    elif args.paths == "host_fetch":
        counts, rows = host_fetch_paths(device)
    elif args.paths == "disk":
        counts, rows = disk_paths(device)
    elif args.paths == "protocol":
        counts, rows = protocol_paths(device)
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
                                           "iseg", "ranks", "train_ranks",
                                           "codec", "protocol")
                      if k in rows}))
    print(f"total wall seconds: {time.perf_counter() - t_start:.1f}",
          flush=True)
    card = smi_line()
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
