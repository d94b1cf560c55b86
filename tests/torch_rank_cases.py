"""What the spawned ranks of the multi-rank port tests run.

`parallel/launch.py:run_ranks` unpickles a rank's function by its module
path, so these functions live here, in a module that imports neither JAX
nor the JAX package (a test module that imports JAX would load it in every
rank). The tests pass configs and frames in as arguments. Each function
runs every case of its test file in one spawn, on the CPU over `gloo`, and
returns numpy arrays and plain values.
"""

import time

import numpy as np
import torch

from video_unscreen_tpu_torch.parallel.launch import heartbeat
from video_unscreen_tpu_torch.parallel.mesh import make_mesh
from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
from video_unscreen_tpu_torch.pipeline.fused_green import FusedGreenPipeline

WORK_LONG = 128
F32 = dict(matting_dtype=torch.float32, seg_dtype=torch.float32)
BG_F32 = dict(F32, stm_dtype=torch.float32)


def green_pipe(cfg, hw, **kw):
    return FusedGreenPipeline(cfg, hw, work_long_side=WORK_LONG,
                              fetch_fg="device", pack_d2h=False,
                              device="cpu", **F32, **kw)


def bg_pipe(cfg, hw):
    return FusedBgPipeline(cfg, hw, work_long_side=WORK_LONG,
                           use_stm_tracking=False, fetch="device",
                           pack_d2h=False, device="cpu", **BG_F32)


def _indivisible(pipe, mesh, segments):
    """The error of S = 3 segments on the mesh's data axis of 2."""
    try:
        pipe.process_segments(mesh, segments[:3])
    except ValueError as e:
        return str(e)
    return None


def _segments_run(pipe, mesh, segments):
    outs = pipe.process_segments(mesh, segments)
    return {"mesh": (dict(mesh.shape), dict(mesh.coords)),
            "outs": [o.numpy() for o in outs],
            "tracking": list(pipe.step_tracking),
            "stats": dict(pipe.stats),
            "indivisible": _indivisible(pipe, mesh, segments)}


def green_segments(rank, segments, cfg):
    """Green `process_segments` on (data 2, model 2), float32."""
    mesh = make_mesh(4)
    return _segments_run(green_pipe(cfg, segments.shape[2:4]), mesh,
                         segments)


def bg_segments(rank, segments, cfg):
    """Fused bg `process_segments` on (data 2, model 2), float32, STM
    tracking off."""
    mesh = make_mesh(4)
    return _segments_run(bg_pipe(cfg, segments.shape[2:4]), mesh, segments)


def deeplab_cases(rank, segments, cfg):
    """The DeepLab seed over the model axis of (data 2, model 2): the
    sharded TTA scores of this rank's block's first frames beside the
    unsharded ones, the green pipeline's `process_segments`, and a step in
    which the ranks of a model axis disagree on a segment's tracking (rank
    (d, 1) says it tracks, rank (d, 0) that it does not)."""
    mesh = make_mesh(4)
    pipe = green_pipe(cfg, segments.shape[2:4])
    axis = mesh.axis("model")
    d = mesh.index("data")
    block = torch.from_numpy(segments[2 * d:2 * d + 2])
    with torch.inference_mode():
        frames = pipe._prep_frames(block[:, 0])
        sharded = pipe.seg.predict_scores(frames, axis).numpy()
        whole = pipe.seg.predict_scores(frames).numpy()
    packed, bg_colors = pipe.process_segments(mesh, segments)
    carries = pipe.init_carries(2)
    if mesh.index("model") == 1:
        carries[0] = carries[0]._replace(tracking=torch.tensor(True))
    before = pipe.seg.forwards
    with torch.inference_mode():
        pipe._step_batched(carries, block[:, 0], axis)
    return {"sharded": sharded, "whole": whole,
            "packed": packed.numpy(), "bg_colors": bg_colors.numpy(),
            "disagree_tracking": pipe.step_tracking[-1],
            "disagree_forwards": pipe.seg.forwards - before}


def mesh_of(rank, n):
    """`make_mesh(n)` on one of n ranks: its shape and coordinates."""
    mesh = make_mesh(n)
    return dict(mesh.shape), dict(mesh.coords)


def rank1_raises(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def rank0_dies(rank):
    if rank == 0:
        import os
        os._exit(3)
    torch.distributed.barrier()


def rank1_hangs(rank):
    if rank == 1:
        time.sleep(600)
    return rank


def naps_with_reports(rank, naps, seconds):
    """`naps` sleeps of `seconds` each, a progress report after each."""
    for _ in range(naps):
        time.sleep(seconds)
        heartbeat()
    return rank


def green_step(pipe):
    """Green's `_step_batched` with the outputs `process_segments` keeps:
    (alpha and fg packed (S, h, w, 4), screen colors (S, 3))."""
    def step(carries, frames):
        carries, (a, fg, bg_color) = pipe._step_batched(carries, frames)
        return carries, (torch.cat([a[..., None], fg], dim=-1), bg_color)
    return step


def bg_step(pipe):
    def step(carries, frames):
        carries, packed = pipe._step_batched(carries, frames)
        return carries, (packed,)
    return step


def one_process(step, init_carries, segments, n_data=2):
    """The blocks of `segments` that the ranks of a data axis of `n_data`
    take, each run in this process from `init_carries` through `step`
    (`green_step`, `bg_step`); each output (S, L, ...) as
    `process_segments` returns it, in numpy."""
    blocks = []
    with torch.inference_mode():
        for blk in np.split(segments, n_data):
            carries = init_carries(blk.shape[0])
            steps = []
            for t in range(blk.shape[1]):
                carries, out = step(carries, torch.from_numpy(blk[:, t]))
                steps.append(out)
            blocks.append([torch.stack(o, dim=1).numpy()
                           for o in zip(*steps)])
    return [np.concatenate(o) for o in zip(*blocks)]
