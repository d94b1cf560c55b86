"""bg mode CLI of the PyTorch port: the argparse surface of
`tools/unscreen/bg.py`, plus `--device` (default cuda; `cpu` runs on the
host).

    python tools/unscreen/bg_torch.py -vid <clip> [--range 0-100]
        [--data_root DIR] [--fused [--chunk 4] [--segments 1]
        [--wire bgr|yuv420] [--profile]] [--device cuda|cpu]

Reads `<data_root>/src_img/<clip>/*.jpg` and writes `segmask_`,
`alphamask_`, `fg_` and `bg_*.jpg` into `<data_root>/test_bg_img/<clip>/`;
the data root defaults to $UNSCREEN_DATA_ROOT, else ./data.
$UNSCREEN_DEVICE_ID picks the card.
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
    parser.add_argument("--fused", action="store_true",
                        help="the fused pipeline (the whole frame on the "
                             "device, fastest)")
    parser.add_argument("--chunk", type=int, default=4)
    parser.add_argument("--segments", type=int, default=1,
                        help="advance N clip segments in lockstep (fused "
                             "path; carries reset at segment boundaries)")
    parser.add_argument("--wire", type=str, default="bgr",
                        choices=("bgr", "yuv420"),
                        help="the upload's frame format; yuv420 sends "
                             "1.5 bytes a pixel (I420, lossy 4:2:0)")
    parser.add_argument("--profile", action="store_true",
                        help="per-stage runtime report; set $VU_TRACE_DIR "
                             "for a profiler trace")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    device = (select_device() if args.device == "cuda" else None) \
        or args.device
    cfg = load_config(args.cfg)
    cfg = attach_data_section(cfg, args.video_id, "bg",
                              data_root=args.data_root,
                              frame_range=args.range, src_tmpl="*.jpg")
    if args.fused:
        from video_unscreen_tpu_torch.pipeline.fused_bg import run_fused
        return run_fused(cfg, save=True, chunk_size=args.chunk,
                         segments=args.segments, wire=args.wire,
                         profile=args.profile, device=device)
    from video_unscreen_tpu_torch.pipeline.bg import run
    return run(cfg, save=True, device=device)


if __name__ == "__main__":
    main()
