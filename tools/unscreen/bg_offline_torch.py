"""bg_offline mode CLI of the PyTorch port: the argparse surface of
`tools/unscreen/bg_offline.py`, plus `--device` (default cuda; `cpu` runs
on the host).

    python tools/unscreen/bg_offline_torch.py -vid <clip> [--range 0-100]
        [--data_root DIR] [--stages 1,2,3] [--modular] [--chunk 4]
        [--device cuda|cpu]

Reads `<data_root>/src_img/<clip>/*.jpg` and writes the stages' artifacts
into `<data_root>/test_bg_step_img/<clip>/`: `segmask_`, `bg_*.jpg`,
`ema_bg.png` and `ema_seen.png` (stage 1), `always_bg.jpg` (stage 2),
`alphamask_` and `fg_*.jpg` (stage 3). A stage run without the earlier
ones reads their artifacts back from there. The data root defaults to
$UNSCREEN_DATA_ROOT, else ./data; $UNSCREEN_DEVICE_ID picks the card.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from video_unscreen_tpu_torch.config import (  # noqa: E402
    attach_data_section, load_config, select_device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", type=str, default="./configs/bg.json")
    parser.add_argument("-vid", "--video_id", type=str, default="1")
    parser.add_argument("--range", type=str, default=None, help="eg. 400-700")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--stages", type=str, default="1,2,3",
                        help="comma-separated stage list, e.g. 2,3")
    parser.add_argument("--modular", action="store_true",
                        help="the per-frame agent loop instead of the fused "
                             "stage scans")
    parser.add_argument("--chunk", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    device = (select_device() if args.device == "cuda" else None) \
        or args.device
    cfg = load_config(args.cfg)
    cfg = attach_data_section(cfg, args.video_id, "bg_step",
                              data_root=args.data_root,
                              frame_range=args.range, src_tmpl="*.jpg")
    stages = tuple(int(s) for s in args.stages.split(","))
    from video_unscreen_tpu_torch.pipeline.bg_offline import run
    return run(cfg, stages=stages, fused=not args.modular,
               chunk_size=args.chunk, device=device)


if __name__ == "__main__":
    main()
