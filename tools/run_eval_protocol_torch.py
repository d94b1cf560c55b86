"""Run the evaluation protocol of `tools/run_eval_protocol.py` on the
PyTorch port and write its table: the synthetic eval set
(`tools/make_eval_set_torch.py`, made when `<data_root>/src_img` is
absent), each mode of `--modes` (green, bg, bg_step) on its clips, the
MIOU / SAD / MSE / GRAD / CONN scores of its predictions
(`pipeline/evaluate.py`) and a markdown table of them.

    python tools/run_eval_protocol_torch.py [--data_root DIR] \
        [--modes green,bg,bg_step] [--vids green1,green2] [--frames 12]
        [--height 288 --width 512] [--work_long_side 512] [--modular]
        [--wire bgr|yuv420] [--green_cfg configs/green.json]
        [--bg_cfg configs/bg.json] [--results_dir runs/eval_protocol_torch]
        [--device cuda|cpu]

It writes `<results_dir>/test_<mode><suffix>.txt` (the evaluation's
lines), `<results_dir>/protocol<suffix>.md` (the table) and the clip lists
it scored, never into the JAX package's `results/`. The eval set and the
predictions go to `--data_root` (default `<results_dir>/data`), as JPEG
files. The protocol runs on the card by default (`--device` defaults to
cuda); `--device cpu` runs it on the host, at small sizes. `--vids` keeps
only those clips of each mode's list. `--only run` runs the modes and
writes their predictions without scoring them, `--only score` scores the
predictions already under `--data_root` (its `alpha_img/`, `meta/` and
`test_<mode>_img/`): bg and bg_step run on the host, where SCHP's
weights are, and the card scores them (the host's CONN labeller takes
~15 s a 1080p frame).
"""
import argparse
import os
import os.path as osp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.config import (  # noqa: E402
    attach_data_section, load_config)
from video_unscreen_tpu_torch.pipeline import evaluate  # noqa: E402

MODES = ("green", "bg", "bg_step")


def ensure_eval_set(root, frames, height, width):
    if not osp.isdir(osp.join(root, "src_img")):
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "make_eval_set_torch", ROOT / "tools" / "make_eval_set_torch.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(["--data_root", root, "--frames", str(frames),
                  "--height", str(height), "--width", str(width)])


def read_list(root, kind):
    with open(osp.join(root, "meta", f"vid_list_{kind}.txt")) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


def run_mode(mode, root, vids, cfg_path, fused=True, work_long_side=288,
             chunk=4, wire="bgr", device="cuda"):
    """Each clip of `vids` through `mode`'s driver; the alphas land in
    `<root>/test_<mode>_img/<vid>/alphamask_*.jpg`."""
    base = load_config(cfg_path)
    for vid in vids:
        cfg = attach_data_section(base, vid, mode, data_root=root,
                                  src_tmpl="*.jpg")
        st = time.time()
        if mode == "green" and fused:
            from video_unscreen_tpu_torch.pipeline.fused_green import \
                run_fused
            run_fused(cfg, save=True, chunk_size=chunk,
                      work_long_side=work_long_side, wire=wire,
                      device=device)
        elif mode == "green":
            from video_unscreen_tpu_torch.pipeline import green
            green.run(cfg, save=True, device=device)
        elif mode == "bg" and fused:
            from video_unscreen_tpu_torch.pipeline.fused_bg import run_fused
            run_fused(cfg, save=True, chunk_size=chunk,
                      work_long_side=work_long_side, wire=wire,
                      device=device)
        elif mode == "bg":
            from video_unscreen_tpu_torch.pipeline import bg
            bg.run(cfg, save=True, device=device)
        else:
            from video_unscreen_tpu_torch.pipeline import bg_offline
            bg_offline.run(cfg, save=True, fused=fused,
                           work_long_side=work_long_side, chunk_size=chunk,
                           device=device)
        print(f"[{mode}] {vid}: {time.time() - st:.1f}s")


def score_mode(mode, root, vids, results_dir, suffix="", device="cuda"):
    """`pipeline/evaluate.py:run` over `vids` (listed in
    `<results_dir>/vid_list_<mode><suffix>.txt`)."""
    meta_fn = osp.join(results_dir, f"vid_list_{mode}{suffix}.txt")
    with open(meta_fn, "w") as fh:
        fh.write("\n".join(vids) + "\n")
    cfg = {"data": {
        "range": None,
        "meta_fn": meta_fn,
        "gt_data_dir": osp.join(root, "alpha_img"),
        "gt_data_tmpl": "*.*",
        "pred_data_dir": osp.join(root, f"test_{mode}_img"),
        "pred_data_tmpl": "alphamask_*.*",
        "save_data_fn": osp.join(results_dir, f"test_{mode}{suffix}.txt"),
    }}
    return evaluate.run(cfg, device=device)


def table(rows) -> str:
    lines = ["| mode | clip | MIOU | SAD | MSE | GRAD | CONN |",
             "|---|---|---|---|---|---|---|"]
    for mode, per_video in rows.items():
        for vid, m in per_video.items():
            lines.append(
                f"| {mode} | {vid} | {m['miou']:.4f} | {m['sad']:.3f} | "
                f"{m['mse']:.4f} | {m['grad']:.3f} | {m['conn']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_root", type=str, default=None,
                        help="eval set and predictions "
                             "(default <results_dir>/data)")
    parser.add_argument("--modes", type=str, default="green,bg,bg_step")
    parser.add_argument("--vids", type=str, default="",
                        help="comma-separated clips to keep (default all)")
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--height", type=int, default=288)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--work_long_side", type=int, default=512)
    parser.add_argument("--modular", action="store_true",
                        help="the modular (unfused) drivers")
    parser.add_argument("--wire", type=str, default="bgr",
                        choices=("bgr", "yuv420"))
    parser.add_argument("--green_cfg", type=str,
                        default=str(ROOT / "configs" / "green.json"))
    parser.add_argument("--bg_cfg", type=str,
                        default=str(ROOT / "configs" / "bg.json"))
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--results_dir", type=str,
                        default=str(ROOT / "runs" / "eval_protocol_torch"))
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    parser.add_argument("--only", type=str, default=None,
                        choices=("run", "score"),
                        help="run the modes, or score their predictions, "
                             "alone (default both)")
    args = parser.parse_args(argv)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    unknown = set(modes) - set(MODES)
    if unknown:
        parser.error(f"unknown modes {sorted(unknown)}: of {MODES}")
    keep = {v.strip() for v in args.vids.split(",") if v.strip()}
    root = args.data_root or osp.join(args.results_dir, "data")
    if args.only != "score":
        ensure_eval_set(root, args.frames, args.height, args.width)
    os.makedirs(args.results_dir, exist_ok=True)
    rows = {}
    for mode in modes:
        vids = read_list(root, "green" if mode == "green" else "natural")
        vids = [v for v in vids if not keep or v in keep]
        cfg_path = args.green_cfg if mode == "green" else args.bg_cfg
        if args.only != "score":
            run_mode(mode, root, vids, cfg_path, fused=not args.modular,
                     work_long_side=args.work_long_side, wire=args.wire,
                     device=args.device)
        if args.only != "run":
            rows[mode] = score_mode(mode, root, vids, args.results_dir,
                                    args.suffix, args.device)
    if args.only == "run":
        return rows
    text = table(rows)
    with open(osp.join(args.results_dir,
                       f"protocol{args.suffix}.md"), "w") as fh:
        fh.write(text + "\n")
    print(text)
    return rows


if __name__ == "__main__":
    main()
