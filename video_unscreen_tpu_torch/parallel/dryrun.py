"""The JAX package's multi-chip dry run.

Port of `__graft_entry__.py:dryrun_multichip`: n ranks make a (data,
model) mesh (`parallel/mesh.py`), take one MattingUNet train step over it
(seeded weights split over the model axis, a 64x64 batch of max(data, 2)
made as JAX makes it, `optax.adamw(1e-4)`'s AdamW: `parallel/train.py`'s
step), then run fused green with the DeepLab seed on seeded weights,
whose crops split over the model axis, and fused bg without STM
tracking, each `process_segments` on 2 x data segments of 2 frames of
64x96 random frames, and print JAX's three lines, the training one first.

    python -m video_unscreen_tpu_torch.parallel.dryrun --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from ..agents.binseg import SegAgent
from ..pipeline.fused_bg import FusedBgPipeline
from ..pipeline.fused_green import FusedGreenPipeline
from ..utils.device import resolve_device
from .launch import run_ranks
from .mesh import make_mesh
from .train import make_train_state, make_train_step

SEG_LEN, H, W = 2, 64, 96

# `__graft_entry__.py:dryrun_multichip`'s green_cfg
GREEN_CFG = {
    "fg_exist_thr": 0.001,
    "colorfiltering_update_duration": 30,
    "colorfiltering_train_iters": 1,
    "binseg": {"type": "deeplab", "input_long_side": W,
               "crop_h": H, "crop_w": H, "stride_ratio": 0.5,
               "flip": True},
    "colorfiltering": {"input_long_side": W,
                       "bg_ncomp": [2, 2, 2],
                       "fg_ncomp": [2, 2, 2]},
    "objectremoval": {
        "score_map_center": {"landscape": [0.5, 0.5],
                             "portrait": [0.6, 0.5]},
        "saliency_thr": 0.00001, "consensus_thr": 0.5},
    "trimap": {"input_long_side": W, "kernelsize": 3, "iters": 2,
               "color_winsize": [10, 100, 180]},
    "vmatting": {"model_path": None, "input_long_side": W},
    "bg_mask": {"thr": 25, "fusion_weight": 0.1},
}


def _train_batch(n: int, hw: int = 64) -> dict:
    """JAX's dry-run batch, drawn as it draws it."""
    rng = np.random.RandomState(0)
    trimap_cls = rng.randint(0, 3, (n, hw, hw))
    return {"img": rng.rand(n, hw, hw, 3).astype(np.float32),
            "alpha_pre": rng.rand(n, hw, hw, 1).astype(np.float32),
            "trimap": np.eye(3, dtype=np.float32)[trimap_cls],
            "alpha_gt": rng.rand(n, hw, hw).astype(np.float32)}


def _train_step(mesh, device: str) -> float:
    """One MattingUNet step over `mesh`: the whole batch's loss."""
    model = make_train_state(device, seed=0, mesh=mesh)
    # optax.adamw(1e-4): constant rate, weight decay 1e-4
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)
    data = mesh.shape["data"]
    batch_n = max(data, 2)
    if batch_n % data:
        batch_n = data
    return float(make_train_step(model, opt, sched, mesh)(
        _train_batch(batch_n)))


def _dryrun_rank(rank: int, n_ranks: int, device: str) -> dict:
    mesh = make_mesh(n_ranks)
    loss = _train_step(mesh, device)
    return dict(_inference(mesh, device), loss=loss)


def _inference(mesh, device: str) -> dict:
    n_seg = 2 * mesh.shape["data"]
    segments = np.random.RandomState(1).randint(
        0, 255, (n_seg, SEG_LEN, H, W, 3)).astype(np.uint8)
    gpipe = FusedGreenPipeline(GREEN_CFG, (H, W), work_long_side=W,
                               fetch_fg="device", device=device)
    if not isinstance(gpipe.seg, SegAgent):
        raise RuntimeError("the green pipeline's seed is not the DeepLab")
    packed, bg_colors = gpipe.process_segments(mesh, segments)
    bpipe = FusedBgPipeline(GREEN_CFG, (H, W), work_long_side=W,
                            use_stm_tracking=False, fetch="device",
                            device=device)
    packed_b, bg_small = bpipe.process_segments(mesh, segments)
    return {"mesh": dict(mesh.shape), "n_seg": n_seg,
            "green": (tuple(packed.shape), tuple(bg_colors.shape)),
            "bg": (tuple(packed_b.shape), tuple(bg_small.shape)),
            "seed_forwards": gpipe.seg.forwards}


def _spawn(fn, n_ranks: int, device) -> List[dict]:
    """`fn` on `n_ranks` ranks (NCCL when each has a card of its own, else
    `gloo`, ranks sharing the card)."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        from ..ops.kernels import build
        build.build()   # once, before the ranks load it
        if n_ranks <= torch.cuda.device_count():
            backend = "nccl"
    return run_ranks(fn, n_ranks, (n_ranks, dev.type), backend=backend,
                     timeout=600.0)


def dryrun_multichip(n_ranks: int, device="cuda") -> List[str]:
    """The whole dry run on `n_ranks` ranks (one spawn): print and return
    JAX's three lines, the training step's first."""
    results = _spawn(_dryrun_rank, n_ranks, device)
    loss = results[0]["loss"]
    if not np.isfinite(loss) or any(r["loss"] != loss for r in results):
        raise RuntimeError(
            f"train step losses {[r['loss'] for r in results]}")
    line = (f"dryrun_multichip ok: mesh={results[0]['mesh']} "
            f"loss={loss:.4f}")
    print(line, flush=True)
    return [line] + _inference_lines(results)


def _inference_lines(results: List[dict]) -> List[str]:
    r0 = results[0]
    mesh, n_seg = r0["mesh"], r0["n_seg"]
    for r in results:
        for mode, shapes in (("green", ((n_seg, SEG_LEN, H, W, 4),
                                        (n_seg, SEG_LEN, 3))),
                             ("bg", ((n_seg, SEG_LEN, H, W, 8),
                                     (n_seg, SEG_LEN, 1, 1, 3)))):
            if r[mode] != shapes:
                raise RuntimeError(f"{mode} outputs {r[mode]}, want {shapes}")
        if r["seed_forwards"] == 0:
            raise RuntimeError("the DeepLab seed never ran")
    lines = [
        f"dryrun_multichip green inference ok: {n_seg} segments x {SEG_LEN} "
        f"frames sharded over data={mesh['data']}, seed TTA crops sharded "
        f"over model={mesh['model']} (2-axis inference)",
        f"dryrun_multichip bg inference ok: {n_seg} segments x {SEG_LEN} "
        f"frames sharded over data={mesh['data']}"]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
