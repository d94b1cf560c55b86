"""STM mask-propagation training on synthetic clips, on one device or over
a mesh.

Port of `video_unscreen_tpu/parallel/train_stm.py`: the clip maker, the
loss (memorize frames 0..T-2 with their ground-truth masks, segment frame
T-1 against the whole bank) and the train step. The memory read is
`models/stm.py:memory_read`, so on the card a step runs K4 forward and K5
and K6 backward once for its batch. Over a mesh (`train.py`'s step) each
data rank reads its block of the batch: the key and value projections are
split over the model axis and gathered before the read, so K4-K6 see
whole (B / data, L, d) tensors; the BatchNorms of the T - 1 `memorize`
calls and the `segment_raw` call take the whole batch's statistics, and
the mean is the whole batch's. The optimizer is the
JAX tool's `optax.adamw(cosine_decay_schedule(lr, steps),
weight_decay=1e-5)`, `parallel/train.py:make_optimizer`, which the other
trainers share, as they share the initialization (`make_state`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.stm import STM
from ..utils.checkpoint import load_stm
from .data_synth import _random_alpha, _smooth_noise, draw_person, translate
from .mesh import Mesh
from .train import TrainStep, make_state, make_step, over_batch


def make_clip_batch(rng: np.random.RandomState, batch: int,
                    hw: Tuple[int, int] = (128, 128),
                    clip_len: int = 3) -> Dict[str, np.ndarray]:
    """T-frame clips: frames 0..T-2 become memory entries (teacher-forced
    with their GT masks), frame T-1 is the query; the JAX package's clips,
    draw for draw. Returns {"frames": (B, T, h, w, 3) normalized, "masks":
    (B, T, h, w)}, NHWC as the JAX package returns them."""
    h, w = hw
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    all_frames, all_masks = [], []
    for _ in range(batch):
        # background: flat, smooth single-octave noise, or textured
        # multi-scale noise with a lighting gradient
        r_bg = rng.rand()
        if r_bg < 0.2:
            bg = np.broadcast_to(
                rng.uniform(0.05, 0.95, 3).astype(np.float32),
                (h, w, 3)).copy()
        elif r_bg < 0.45:
            bg = _smooth_noise(rng, h, w,
                               scale=max(h // rng.choice([6, 8, 12]), 1))
        else:
            coarse = max(h // rng.choice([4, 6, 8]), 1)
            bg = (_smooth_noise(rng, h, w, scale=coarse) * 0.85
                  + _smooth_noise(rng, h, w, scale=max(h // 24, 1)) * 0.15)
            gy = np.linspace(rng.uniform(0.6, 1.0), rng.uniform(0.9, 1.3),
                             h, dtype=np.float32)[:, None, None]
            bg = (bg * gy).clip(0, 1)

        fgs, alphas = [], []
        if rng.rand() < 0.6:
            # walking person: the same figure at successive walk phases,
            # shifted further at each step
            prng = np.random.RandomState(rng.randint(1 << 31))
            state = prng.get_state()
            p1 = rng.uniform(0, 2 * np.pi)
            dphase = rng.uniform(0.3, 1.0)
            step_dx = rng.randint(-10, 11)
            for t in range(clip_len):
                prng.set_state(state)
                person, parts = draw_person(prng, h, w,
                                            phase=p1 + t * dphase)
                person = np.roll(person, t * step_dx, axis=1)
                parts = np.roll(parts, t * step_dx, axis=1)
                fgs.append(person)
                alphas.append((parts > 0).astype(np.float32))
        else:
            # deformable blob clip (generic object tracking)
            if rng.rand() < 0.5:
                fg = np.broadcast_to(
                    rng.uniform(0.05, 0.95, 3).astype(np.float32),
                    (h, w, 3)).copy()
                fg += _smooth_noise(rng, h, w, 16) * rng.uniform(0.0, 0.2)
            else:
                fg = _smooth_noise(rng, h, w, scale=4)
            alpha0 = _random_alpha(rng, h, w)
            step = rng.randint(-10, 11, size=2)
            for t in range(clip_len):
                tx, ty = int(t * step[0]), int(t * step[1])
                alphas.append(translate(alpha0, tx, ty))
                fgs.append(translate(fg, tx, ty))

        def compose(a, f):
            img = a[..., None] * f + (1 - a[..., None]) * bg
            img += rng.randn(h, w, 3).astype(np.float32) * 0.02
            return ((img.clip(0, 1))[..., ::-1] - mean) / std

        all_frames.append(np.stack([compose(a, f)
                                    for a, f in zip(alphas, fgs)]))
        all_masks.append(np.stack([(a > 0.5).astype(np.float32)
                                   for a in alphas]))
    return {"frames": np.stack(all_frames), "masks": np.stack(all_masks)}


def make_pair_batch(rng: np.random.RandomState, batch: int,
                    hw: Tuple[int, int] = (128, 128)
                    ) -> Dict[str, np.ndarray]:
    """2-frame compatibility wrapper over `make_clip_batch`."""
    b = make_clip_batch(rng, batch, hw, clip_len=2)
    return {"frame1": b["frames"][:, 0], "mask1": b["masks"][:, 0],
            "frame2": b["frames"][:, 1],
            "mask2": b["masks"][:, 1].astype(np.int32)}


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch (NHWC frames) as tensors on `device`, frames NCHW:
    "frames" (B, T, 3, H, W) or "frame1"/"frame2" (B, 3, H, W)."""
    out = {}
    for key, a in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(a)).to(device)
        if key.startswith("frame"):
            t = t.movedim(-1, -3).contiguous()
        out[key] = t
    return out


def stm_logits(model: STM, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw decoder logits (B, 2, H, W) of the last frame, its target
    (B, H, W) int64): memorize frames 0..T-2 (teacher-forced GT masks)
    into a T-1 slot bank and segment frame T-1 against the whole bank
    (every slot valid). `batch` is `batch_to_device`'s. Run in train mode,
    each module updates its BatchNorm statistics as it runs, in the order
    flax threads `batch_stats` (the memory frames in turn, then the
    query)."""
    if "frames" in batch:
        frames, masks = batch["frames"], batch["masks"]
        mem_frames = [(frames[:, t], masks[:, t])
                      for t in range(frames.shape[1] - 1)]
        query, target = frames[:, -1], masks[:, -1].long()
    else:  # 2-frame pair dict (compat)
        mem_frames = [(batch["frame1"], batch["mask1"])]
        query, target = batch["frame2"], batch["mask2"].long()
    ks, vs = [], []
    for f, m in mem_frames:
        k, v = model.memorize(f, m, 1.0 - m)
        ks.append(k)
        vs.append(v)
    mem_k, mem_v = torch.stack(ks, dim=1), torch.stack(vs, dim=1)
    valid = torch.ones((query.shape[0], len(ks)), dtype=torch.bool,
                       device=query.device)
    return model.segment_raw(query, mem_k, mem_v, valid), target


def stm_loss(model: STM, batch: Dict[str, torch.Tensor],
             axis=None) -> torch.Tensor:
    """The mean cross-entropy of `stm_logits` over the whole batch
    (`train.over_batch`). The sum is `torch.sum` of the per-pixel losses:
    CUDA's `nll_loss2d` sums with atomics, so its loss would not repeat
    bit for bit."""
    logits, target = stm_logits(model, batch)
    ce = F.cross_entropy(logits, target, reduction="none")
    return over_batch(ce.sum(), target.numel(), axis)


def make_stm_train_state(device="cuda", seed: int = 0, init_from=None,
                         model: Optional[STM] = None,
                         mesh: Optional[Mesh] = None) -> STM:
    """The STM (`model`, default `STM()`) on `device` ("cuda" unless the
    caller asks for "cpu") in train mode: flax's initialization from a
    `torch.Generator` seeded with `seed`, or the variables of a flax
    msgpack checkpoint (`utils/checkpoint.py:load_stm`); split over
    `mesh` when given (`parallel/train.py:make_state`)."""
    return make_state(model if model is not None else STM(), device, seed,
                      init_from, load_stm, mesh)


def make_stm_train_step(model: STM, optimizer, scheduler,
                        mesh: Optional[Mesh] = None) -> TrainStep:
    """The STM step (`train.make_step` of `stm_loss` on `batch_to_device`'s
    NCHW frames): step(numpy batch) -> loss, one value-and-grad, one AdamW
    update and one schedule step."""
    return make_step(model, optimizer, scheduler, stm_loss, mesh=mesh,
                     to_device=batch_to_device)
