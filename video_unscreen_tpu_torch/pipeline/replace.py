"""Person replacement: a matted person composited onto another clip's
background.

Port of `video_unscreen_tpu/pipeline/replace.py`: the mean mask-centroid
offset between the source and target clips (`comp_dx_dy`), then per frame
the target's fg and mask shifted by that offset (bilinear, zero outside),
rescaled by 1.2 about the centre and alpha-composited over the source
background (`_compose`). With `harmonize`, the HarmonizationAgent tones
the fg toward the background in Lab and blurs the background first.

`compose_frames` is the per-frame device work on in-memory arrays; `run`
reads the JPEGs around it and writes `res_` and `compare_*.jpg`.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..agents.harmonization import HarmonizationAgent
from ..ops.geometry import resize
from ..utils.device import as_float, resolve_device
from ..utils.fileio import parallel_read_img, save_img, save_video

SCALE = 1.2


def mask_centroid(mask_gray: torch.Tensor) -> torch.Tensor:
    """(cx, cy) of a float (H, W) mask from its image moments."""
    h, w = mask_gray.shape
    ys = torch.arange(h, dtype=torch.float32, device=mask_gray.device)
    xs = torch.arange(w, dtype=torch.float32, device=mask_gray.device)
    m00 = mask_gray.sum() + 1e-6
    return torch.stack([(mask_gray * xs[None, :]).sum() / m00,
                        (mask_gray * ys[:, None]).sum() / m00])


def _shift_planes(img: torch.Tensor, dx: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """out[y, x] = img at (y - dy, x - dx), bilinear, 0 outside: what
    `map_coordinates(order=1, mode="constant", cval=0)` computes, with the
    explicit floor and weights (a grid_sample reaches these coordinates
    only through a normalization round trip, which rounds differently).
    The four neighbours are summed in map_coordinates' order, each weight
    the product of its row and column weights."""
    h, w = img.shape[:2]
    gy = torch.arange(h, dtype=torch.float32, device=img.device) - dy
    gx = torch.arange(w, dtype=torch.float32, device=img.device) - dx
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy = (1.0 - (gy - y0), gy - y0)
    wx = (1.0 - (gx - x0), gx - x0)
    iy = (y0.to(torch.int64), y0.to(torch.int64) + 1)
    ix = (x0.to(torch.int64), x0.to(torch.int64) + 1)
    out = None
    for a in range(2):
        vy = (iy[a] >= 0) & (iy[a] < h)
        rows = img.index_select(0, iy[a].clamp(0, h - 1))
        for b in range(2):
            vx = (ix[b] >= 0) & (ix[b] < w)
            vals = rows.index_select(1, ix[b].clamp(0, w - 1))
            valid = (vy[:, None] & vx[None, :])[..., None]
            term = (wy[a][:, None] * wx[b][None, :])[..., None] * \
                torch.where(valid, vals, 0.0)
            out = term if out is None else out + term
    return out


def _compose(fg: torch.Tensor, mask: torch.Tensor, bg: torch.Tensor,
             shift_xy: torch.Tensor,
             scale_factor: float = SCALE) -> torch.Tensor:
    """Shift `fg` and `mask` (float (H, W, 3)) by `shift_xy` = (dx, dy),
    rescale them by `scale_factor` and crop the centre, then composite
    over `bg`: clip(fg * a + bg * (1 - a), 0, 255) with a = mask / 255."""
    h, w = fg.shape[:2]
    sh, sw = int(h * scale_factor), int(w * scale_factor)
    off_h, off_w = (sh - h) // 2, (sw - w) // 2

    def shift_and_scale(img):
        big = resize(_shift_planes(img, shift_xy[0], shift_xy[1]), (sh, sw))
        return big[off_h:off_h + h, off_w:off_w + w]

    fg_s = shift_and_scale(fg)
    a = shift_and_scale(mask) / 255.0
    return torch.clamp(fg_s * a + bg * (1.0 - a), 0.0, 255.0)


def centroid_offset(src_masks: Sequence[np.ndarray],
                    dst_masks: Sequence[np.ndarray],
                    device="cuda") -> Tuple[float, float]:
    """The mean (dx, dy) from each target mask's centroid to its source
    mask's, uint8 BGR masks (the source resized to the target's size as
    cv2.resize does, both made gray as cv2 does)."""
    dev = resolve_device(device)
    dxs, dys = [], []
    for src, dst in zip(src_masks, dst_masks):
        src = runtime.resize_batch([np.ascontiguousarray(src, np.uint8)],
                                   dst.shape[:2])[0]
        dc = mask_centroid(as_float(runtime.bgr_to_gray(dst), dev))
        sc = mask_centroid(as_float(runtime.bgr_to_gray(src), dev))
        d = (sc - dc).cpu().numpy()
        dxs.append(d[0])
        dys.append(d[1])
    return float(np.mean(dxs)), float(np.mean(dys))


def comp_dx_dy(src_data_dir: str, tgt_data_dir: str, numframes: int,
               device="cuda") -> Tuple[float, float]:
    """The mean centroid offset source <- target over the clip's
    `alphamask_*.jpg` files."""
    names = [f"alphamask_{fid:06d}.jpg" for fid in range(numframes)]
    return centroid_offset(
        parallel_read_img([osp.join(src_data_dir, n) for n in names]),
        parallel_read_img([osp.join(tgt_data_dir, n) for n in names]),
        device)


@torch.inference_mode()
def compose_frames(dst_fgs: Sequence[np.ndarray],
                   dst_masks: Sequence[np.ndarray], bg: np.ndarray,
                   shift: Tuple[float, float], harmonize: bool = False,
                   device="cuda") -> np.ndarray:
    """The per-frame device work of `run` on in-memory uint8 arrays: the
    target's BGR fgs and BGR masks (h, w, 3), the source background at
    their size, the (dx, dy) shift. With `harmonize`, each fg is toned
    toward the background and the background is blurred at long side 480
    (3 box filters of 3) first. Returns the composites, uint8 (N, h, w,
    3)."""
    dev = resolve_device(device)
    shift_d = torch.tensor([float(shift[0]), float(shift[1])],
                           dtype=torch.float32, device=dev)
    bg_raw = bg_d = as_float(bg, dev)
    harm = HarmonizationAgent(device=dev) if harmonize else None
    if harm is not None:  # the same blur for every frame
        bg_d = harm.device_smooth(bg_raw, 3, 3,
                                  harm.blur_work_hw(*bg.shape[:2]))
    out = []
    for fg, mask in zip(dst_fgs, dst_masks):
        fg_d, mask_d = as_float(fg, dev), as_float(mask, dev)
        if harm is not None:
            alpha_gray = as_float(runtime.bgr_to_gray(
                np.asarray(mask, np.uint8)), dev)
            fg_d = harm.device_foreground_toning(fg_d, bg_raw, alpha_gray)
        out.append(_compose(fg_d, mask_d, bg_d, shift_d, SCALE).to(
            torch.uint8))
    return torch.stack(out).cpu().numpy()


def run(args, device="cuda") -> None:
    """`args`: a namespace with `src_data_dir`, `tgt_data_dir`,
    `src_bg_image`, `dst_data_dir`, `dst_vid_dir`, `src`, `tgt` and
    optionally `harmonize`, as `tools/replace/replace_torch.py` builds
    it."""
    dev = resolve_device(device)
    framepaths = sorted(glob(osp.join(args.tgt_data_dir, "fg_*.jpg")))
    numframes = len(framepaths)
    assert numframes > 0
    os.makedirs(args.dst_data_dir, exist_ok=True)

    dx, dy = comp_dx_dy(args.src_data_dir, args.tgt_data_dir, numframes,
                        dev)
    print("Correspondence mean: ", dx, dy)
    harmonize = bool(getattr(args, "harmonize", False))

    ids = range(numframes)
    dst_fgs = parallel_read_img([osp.join(args.tgt_data_dir,
                                          f"fg_{fid:06d}.jpg") for fid in ids])
    dst_masks = parallel_read_img([osp.join(
        args.tgt_data_dir, f"alphamask_{fid:06d}.jpg") for fid in ids])
    h, w = dst_fgs[0].shape[:2]
    bg = runtime.resize_batch([parallel_read_img([args.src_bg_image])[0]],
                              (h, w))[0]
    res = compose_frames(dst_fgs, dst_masks, bg, (dx, dy), harmonize, dev)
    for fid in ids:
        src_path = osp.join(args.src_data_dir, f"frame_{fid:06d}.jpg")
        if osp.exists(src_path):
            src_image = runtime.resize_batch(
                [parallel_read_img([src_path])[0]], (h, w))[0]
        else:
            src_image = np.zeros_like(dst_fgs[fid])
        save_img(osp.join(args.dst_data_dir, f"res_{fid:06d}.jpg"), res[fid])
        save_img(osp.join(args.dst_data_dir, f"compare_{fid:06d}.jpg"),
                 np.concatenate((src_image, res[fid]), axis=1))

    try:
        save_video(args.dst_data_dir,
                   osp.join(args.dst_vid_dir,
                            f"compare_{args.src}_{args.tgt}.mp4"))
    except Exception as e:  # the JAX package's best-effort mux
        print(f"save_video skipped: {e}")
