"""Shared pipeline helpers (port of `video_unscreen_tpu/pipeline/common.py`):
the location score map, config-driven object removal, the host-side
foreground gate, artifact names, reading the clip (`read_frames`) and the
runtime report (`print_statistic`); and the fused pipelines' frame
preparation on the device (`prep_frames`: the I420 decode, then the resize
when the frames are not at work resolution yet), their segment loop
(`run_segments`: the host builds each chunk, resized on the host and packed
for the wire, and `parallel/streaming.py` uploads it) and their loop over
the ranks of a mesh (`segment_blocks`)."""

from __future__ import annotations

import collections
import functools
import os.path as osp
from glob import glob
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..ops.color import yuv420_to_bgr
from ..ops.connected import remove_invalid_objects, score_map
from ..ops.geometry import resize_nchw
from ..parallel.mesh import batch_sharding
from ..parallel.streaming import ChunkStream
from ..utils.fileio import parallel_read_img
from ..utils.profiling import StageTimer

WIRES = ("bgr", "yuv420")


def unported(what: str, item: str) -> NotImplementedError:
    """The error an option of the JAX pipelines that has no port yet
    raises, naming its ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1, item {item})")


@functools.lru_cache(maxsize=16)
def _score_map(h: int, w: int, center) -> np.ndarray:
    sm = score_map(h, w, center)
    sm.setflags(write=False)
    return sm


def _center(h: int, w: int, cfg: dict):
    centers = cfg["objectremoval"]["score_map_center"]
    return tuple(centers["landscape"] if w > h else centers["portrait"])


def build_score_map(h: int, w: int, cfg: dict) -> np.ndarray:
    """Landscape/portrait location score map from the config, cached per
    geometry."""
    return _score_map(h, w, _center(h, w, cfg))


@functools.lru_cache(maxsize=16)
def _score_tensor(h: int, w: int, center, device: torch.device):
    return torch.from_numpy(np.array(_score_map(h, w, center))).to(device)


def remove_invalid_objects_cfg(cfg: dict, alpha: torch.Tensor,
                               segmask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Object removal at full resolution with the config's thresholds; the
    segmask defaults to the alpha itself. Takes uint8 or float (H, W)
    tensors and returns a uint8 tensor on the alpha's device."""
    a = alpha.to(torch.float32)
    seg = a if segmask is None else segmask.to(torch.float32)
    h, w = a.shape
    out = remove_invalid_objects(
        a, seg, _score_tensor(h, w, _center(h, w, cfg), a.device),
        saliency_thr=float(cfg["objectremoval"]["saliency_thr"]),
        consensus_thr=float(cfg["objectremoval"]["consensus_thr"]))
    return out.to(torch.uint8)


def exist_foreground_np(mask, thr: float) -> bool:
    """Host-side foreground gate: (mask >= 128).sum() > thr * h * w (one
    device sync for a CUDA tensor)."""
    h, w = mask.shape
    return bool((torch.as_tensor(mask) >= 128).sum() > thr * h * w)


def artifact_path(dst_dir: str, kind: str, fid: int) -> str:
    return osp.join(dst_dir, f"{kind}_{fid:06d}.jpg")


def read_frames(cfg: dict) -> List[np.ndarray]:
    """The clip of `cfg["data"]`: the files matching `src_img_tmpl` in
    `src_img_dir`, sorted, cut to `range` when given, decoded to BGR."""
    data = cfg["data"]
    paths = sorted(glob(osp.join(data["src_img_dir"], data["src_img_tmpl"])))
    if data.get("range"):
        paths = paths[data["range"][0]:data["range"][1]]
    if not paths:
        raise FileNotFoundError(
            f"no frames matching {data['src_img_tmpl']} in "
            f"{data['src_img_dir']}")
    return parallel_read_img(paths)


def print_statistic(runtime_s: dict, tracking_count: int,
                    numframes: int) -> None:
    """Per-stage runtime report: seconds a frame of each stage."""
    print(f"{tracking_count} / {numframes} use tracking")
    print("-" * 10 + "runtime" + "-" * 10)
    for key, value in runtime_s.items():
        print(f"{key:>16s}: {value / max(numframes, 1):.3f}s")
    print("-" * 10 + "-------" + "-" * 10)
    print()


def check_wire(wire: str) -> str:
    if wire not in WIRES:
        raise ValueError(f"wire={wire!r}: one of {WIRES}")
    return wire


def prep_frames(frames_full: torch.Tensor,
                work_hw: Tuple[int, int]) -> torch.Tensor:
    """One step's uint8 frames on the device, BGR (S, H, W, 3) or I420
    (S, H * 3 / 2, W), -> float32 BGR (S, h, w, 3) at work resolution:
    I420 is decoded first, then the frames are resized on the device
    unless the host already brought them to `work_hw`."""
    if frames_full.dim() == 3:
        x = yuv420_to_bgr(frames_full)
    else:
        x = frames_full.to(torch.float32)
    if tuple(x.shape[1:3]) == tuple(work_hw):
        return x
    y = resize_nchw(x.permute(0, 3, 1, 2), work_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def host_frames(frames, work_hw: Tuple[int, int]) -> np.ndarray:
    """The frames at work resolution on the host, (N, h, w, 3) uint8,
    resized with cv2's INTER_LINEAR (`runtime.resize_batch`)."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if frames[0].shape[:2] == tuple(work_hw):
        return np.stack(frames)
    return runtime.resize_batch(frames, work_hw)


def run_segments(step: Callable, carries, frames, n_segments: int,
                 chunk_size: int, device: torch.device,
                 stats: collections.Counter, wire_hw: Tuple[int, int],
                 wire: str = "bgr", timer: Optional[StageTimer] = None
                 ) -> Tuple[np.ndarray, ...]:
    """The fused pipelines' host loop. The clip is split into `n_segments`
    contiguous segments of ceil(N / S) frames (the tail padded with the
    last frame) advanced in lockstep. The host builds each chunk of
    `chunk_size` steps, (steps, S, ...) uint8: every frame resized to
    `wire_hw` (the work resolution under `host_downscale`, else its own)
    and, for `wire="yuv420"`, packed as I420, in one C++ call a chunk;
    `ChunkStream` uploads it behind the device's work on the last chunk.
    `step(carries, frames)` takes one step's (S, ...) frames and returns
    (carries, a tuple of tensors with a leading S axis); a chunk's outputs
    are fetched together in one copy (one sync, counted in `stats`).
    `timer` takes the stream_wait / dispatch / fetch split. Returns each
    output as an (N, ...) numpy array in clip order, trimmed to N
    frames."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    n = len(frames)
    seg_len = -(-n // n_segments)
    padded = frames + [frames[-1]] * (n_segments * seg_len - n)
    starts = list(range(0, seg_len, chunk_size))
    i420 = check_wire(wire) == "yuv420"
    h, w = wire_hw
    one = (h * 3 // 2, w) if i420 else (h, w) + frames[0].shape[2:]

    def fill(i: int, out: np.ndarray) -> int:
        c0 = starts[i]
        cn = min(chunk_size, seg_len - c0)
        srcs = [padded[s * seg_len + c0 + t] for t in range(cn)
                for s in range(n_segments)]
        runtime.prep_batch(srcs, wire_hw, i420,
                           out=out.reshape((-1,) + one)[:len(srcs)])
        return cn

    timer = timer or StageTimer()
    stream = iter(ChunkStream(fill, len(starts),
                              (chunk_size, n_segments) + one, device))
    chunks = []
    while True:
        with timer.stage("stream_wait"):
            item = next(stream, None)
        if item is None:
            break
        chunk, cn = item
        outs = []
        with timer.stage("dispatch"):
            for t in range(cn):
                carries, out = step(carries, chunk[t])
                outs.append(out)
        with timer.stage("fetch"):
            chunks.append(_fetch([torch.stack(o, dim=1)
                                  for o in zip(*outs)]))
        stats["syncs"] += 1
    # per output: (S, seg_len, ...) -> clip order, trimmed
    return tuple(np.concatenate(parts, axis=1).reshape(
        (n_segments * seg_len,) + parts[0].shape[2:])[:n]
        for parts in zip(*chunks))


def segment_blocks(step: Callable, init_carries: Callable, mesh, segments,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The fused pipelines' `process_segments`. `segments` (S, L, ...)
    uint8 (numpy or a tensor) are split over the data axis of `mesh`
    (S divisible by it, else ValueError); this rank uploads its block of S
    / data segments and advances it from `init_carries(S / data)` through
    L calls of `step(carries, (S / data, ...) frames, model_axis)`, which
    returns (carries, a tuple of tensors with a leading segment axis), no
    step padded. Returns each output as (S, L, ...) on the device,
    gathered over the data axis on every rank."""
    n_data = mesh.shape["data"]
    if segments.shape[0] % n_data:
        raise ValueError(f"S={segments.shape[0]} segments not divisible by "
                         f"the mesh data axis ({n_data})")
    rows = batch_sharding(mesh)
    block = torch.as_tensor(rows.shard(segments)).to(device)
    model_axis = mesh.axis("model")
    carries = init_carries(block.shape[0])
    outs = []
    for t in range(block.shape[1]):
        carries, out = step(carries, block[:, t], model_axis)
        outs.append(out)
    return tuple(rows.gather(torch.stack(o, dim=1)) for o in zip(*outs))


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Copy tensors of any dtypes to the host in one transfer: their bytes
    concatenated on the device, split and reinterpreted on the host."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + nbytes].view(dtype).reshape(t.shape))
        at += nbytes
    return out
