"""The application protocols of `tools/run_app_protocol.py` on the PyTorch
port: scenario 3 (STM mask propagation with ISeg correction, scored) and
scenario 4 (the person replacement, scored), with `--device` (default
cuda; `cpu` runs on the host).

    python tools/run_app_protocol_torch.py [--scenarios stm_iseg,replace]
        [--device cuda|cpu] [--results_dir DIR]
        [--stm_weights weights/stm.msgpack]
        [--iseg_weights weights/iseg.msgpack]

Scenario 3 builds the hard-cut multi-shot clip
(`parallel/data_synth.py:make_multishot_clip`), propagates the first
frame's GT mask with STM straight through the cut ("stm_raw"), and again
with the mask re-seeded at each cut by the ISeg agent from simulated
clicks ("stm_iseg": positive at the GT centroid, negative at the centroid
of the failed propagation's false positives when there are more than 20),
and scores both per frame with `pipeline/evaluate.py:score_pair` on the
device. `--iseg_weights none` runs ISeg on seeded weights (the scores
then say nothing of the shipped model).

Scenario 4 composites a target clip's person onto a source clip's
background with the replacement's device work
(`pipeline/replace.py:centroid_offset` and `compose_frames`), its inputs
(premultiplied fgs and 3-channel masks) written and read back as PNGs,
and scores the composite against the analytic one (the target's fg and
alpha shifted by the measured offset over the background; MSE, PSNR) and
the harmonized composite's subject lightness against the background's.
Unlike the JAX tool, which scores its `res_*.jpg` files, it scores the
composites as computed (no JPEG on the card's machine).

Each scenario prints its lines; with `--results_dir` they also go to
`<dir>/test_stm_iseg_torch.txt`, `<dir>/test_replace_torch.txt` and
`<dir>/protocol_apps_torch.md`.
"""
import argparse
import os
import os.path as osp
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.device import (  # noqa: E402
    as_float, resolve_device)


def centroid(mask):
    ys, xs = np.nonzero(mask > 127)
    return int(ys.mean()), int(xs.mean())


def iseg_correct(iseg, frame, pred, gt):
    """The simulated operator's correction: a positive click at the GT's
    centroid, a negative one at the failed propagation's false positives
    (when there are more than 20)."""
    clicks = [(True, *centroid(gt))]
    fp = (pred > 127) & (gt <= 127)
    if fp.sum() > 20:
        clicks.append((False, *centroid(fp.astype(np.uint8) * 255)))
    return iseg.forward(frame, clicks)


def _weights(path):
    return None if path in (None, "", "none") else str(ROOT / path) \
        if not osp.isabs(path) else path


def run_stm_iseg(device="cuda", stm_weights="weights/stm.msgpack",
                 iseg_weights="weights/iseg.msgpack", results_dir=None):
    """Scenario 3; returns [(variant, mean scores (5,), post-cut mean
    scores (5,))] and the lines."""
    import torch

    from video_unscreen_tpu_torch.agents.iseg import ISegAgent
    from video_unscreen_tpu_torch.agents.stm import STMAgent
    from video_unscreen_tpu_torch.parallel.data_synth import \
        make_multishot_clip
    from video_unscreen_tpu_torch.pipeline.evaluate import score_pair

    dev = resolve_device(device)
    frames, gts, cuts = make_multishot_clip(n_shots=2, frames_per_shot=8)
    stm = STMAgent(model_path=_weights(stm_weights), input_long_side=128,
                   memory_step=2, memory_capacity=10, device=dev)
    iseg = ISegAgent(model_path=_weights(iseg_weights), input_long_side=128,
                     with_flip=True, device=dev)

    # raw propagation straight through the cut
    preds_raw = stm.forward(frames, gts[0])
    # the corrected workflow: re-seeded at every cut from ISeg clicks
    preds_fix, bounds = [], [0] + list(cuts) + [len(frames)]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b0 == 0:
            seed = gts[0]
        else:
            seed = iseg_correct(iseg, frames[b0],
                                preds_raw[b0].cpu().numpy(), gts[b0])
        preds_fix.extend(stm.forward(frames[b0:b1], seed))

    rows, lines = [], []
    for name, preds in (("stm_raw", preds_raw), ("stm_iseg", preds_fix)):
        scores = torch.stack([
            score_pair(as_float(g, dev), p.to(torch.float32))
            for g, p in zip(gts, preds)]).cpu().numpy().astype(np.float64)
        mean = scores.mean(axis=0)
        # the frames after the cut are where the two variants differ
        post = scores[cuts[0]:].mean(axis=0)
        rows.append((name, mean, post))
        lines.append(
            "{} MIOU: {:.06g} SAD: {:.06g} MSE: {:.06g} GRAD: {:.06g} "
            "CONN: {:.06g}' (post-cut MIOU {:.4f})".format(
                name, *mean, post[0]))
    for ln in lines:
        print(ln)
    if results_dir:
        with open(osp.join(results_dir, "test_stm_iseg_torch.txt"),
                  "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return rows, lines


def run_replace(device="cuda", results_dir=None):
    """Scenario 4; returns (mean MSE, mean PSNR, lines)."""
    import torch

    from video_unscreen_tpu_torch.ops.color import bgr2lab
    from video_unscreen_tpu_torch.parallel.data_synth import (
        _warp_translate, make_eval_clip)
    from video_unscreen_tpu_torch.pipeline import replace as replace_mod
    from video_unscreen_tpu_torch.utils.fileio import (parallel_read_img,
                                                       write_png)

    dev = resolve_device(device)
    n, h, w = 6, 144, 256
    src_frames, src_gts = make_eval_clip("natural", n=n, h=h, w=w, seed=7)
    tgt_frames, tgt_gts = make_eval_clip("natural", n=n, h=h, w=w, seed=19)

    # GT-driven inputs: the replacement consumes an unscreen run's
    # premultiplied fgs and 3-channel alphamasks; GT in their place
    # isolates the geometry, compositing and harmonization it scores
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: [] for k in ("src_mask", "tgt_fg", "tgt_mask")}
        for i in range(n):
            at = (tgt_gts[i].astype(np.float32) / 255.0)[..., None]
            arrays = {
                "src_mask": np.repeat(src_gts[i][..., None], 3, -1),
                "tgt_fg": (tgt_frames[i].astype(np.float32) * at
                           ).astype(np.uint8),
                "tgt_mask": np.repeat(tgt_gts[i][..., None], 3, -1)}
            for k, a in arrays.items():
                p = osp.join(tmp, f"{k}_{i:06d}.png")
                write_png(p, a)
                paths[k].append(p)
        src_masks, tgt_fgs, tgt_masks = (parallel_read_img(paths[k])
                                         for k in paths)
    # the source background: the median over time of the pixels the
    # subject leaves free (every pixel is background in some frame)
    stack = np.stack(src_frames).astype(np.float32)
    occl = np.stack([g > 127 for g in src_gts])
    med = np.where(occl[..., None], np.nan, stack)
    bg = np.nanmedian(med, axis=0)
    bg = np.where(np.isnan(bg), stack.mean(axis=0), bg).astype(np.uint8)

    dx, dy = replace_mod.centroid_offset(src_masks, tgt_masks, dev)
    res = {harm: replace_mod.compose_frames(tgt_fgs, tgt_masks, bg,
                                            (dx, dy), harm, dev)
           for harm in (False, True)}

    # the plain composite against the analytic one with the same shift
    mses, psnrs = [], []
    for i in range(n):
        at = tgt_gts[i].astype(np.float32) / 255.0
        a_s = _warp_translate(at, dx, dy)
        fg = tgt_frames[i].astype(np.float32) * at[..., None]
        fg_s = np.stack([_warp_translate(np.ascontiguousarray(fg[..., c]),
                                         dx, dy) for c in range(3)], -1)
        gt_comp = fg_s + (1 - a_s[..., None]) * bg.astype(np.float32)
        mse = float(((res[False][i].astype(np.float32) - gt_comp) ** 2
                     ).mean())
        mses.append(mse)
        psnrs.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-6)))
    lines = ["replace composite vs analytic GT composite: "
             "MSE {:.2f} PSNR {:.2f} dB (n={})".format(
                 np.mean(mses), np.mean(psnrs), n)]

    # harmonized: the subject's Lab lightness moves toward the background's
    subj = _warp_translate(tgt_gts[0].astype(np.float32) / 255.0, dx,
                           dy) > 0.5

    def lightness(img, where=None):
        lab = bgr2lab(as_float(img, torch.device("cpu"))).numpy()[..., 0]
        return float((lab if where is None else lab[where]).mean())

    bg_l = lightness(bg)
    p_l = lightness(res[False][0], subj)
    h_l = lightness(res[True][0], subj)
    lines.append(
        "harmonize: subject L mean {:.1f} -> {:.1f} (bg {:.1f}; toning "
        "moved it {}closer)".format(
            p_l, h_l, bg_l,
            "" if abs(h_l - bg_l) <= abs(p_l - bg_l) else "NOT "))
    for ln in lines:
        print(ln)
    if results_dir:
        with open(osp.join(results_dir, "test_replace_torch.txt"),
                  "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return float(np.mean(mses)), float(np.mean(psnrs)), lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--results_dir", type=str, default=None,
                        help="write the result files here (else only "
                             "print)")
    parser.add_argument("--scenarios", type=str, default="stm_iseg,replace")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    parser.add_argument("--stm_weights", type=str,
                        default="weights/stm.msgpack")
    parser.add_argument("--iseg_weights", type=str,
                        default="weights/iseg.msgpack",
                        help="'none' for seeded weights")
    args = parser.parse_args(argv)

    if args.results_dir:
        os.makedirs(args.results_dir, exist_ok=True)
    md = ["# Application-scenario protocol, PyTorch port", ""]
    scenarios = args.scenarios.split(",")
    if "stm_iseg" in scenarios:
        rows, _ = run_stm_iseg(args.device, args.stm_weights,
                               args.iseg_weights, args.results_dir)
        md += ["## STM propagation + iseg correction (multi-shot clip)",
               "", "| variant | MIOU | SAD | MSE | GRAD | CONN | "
               "post-cut MIOU |", "|---|---|---|---|---|---|---|"]
        for name, mean, post in rows:
            md.append("| {} | {:.4f} | {:.3f} | {:.4f} | {:.3f} | "
                      "{:.3f} | {:.4f} |".format(name, *mean, post[0]))
        md.append("")
    if "replace" in scenarios:
        mse, psnr, _ = run_replace(args.device, args.results_dir)
        md += ["## Person replacement", "", "| metric | value |",
               "|---|---|",
               "| composite MSE vs analytic GT | {:.2f} |".format(mse),
               "| composite PSNR | {:.2f} dB |".format(psnr), ""]
    if args.results_dir:
        path = osp.join(args.results_dir, "protocol_apps_torch.md")
        with open(path, "w") as fh:
            fh.write("\n".join(md))
        print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
