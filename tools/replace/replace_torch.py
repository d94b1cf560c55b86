"""Person replacement CLI of the PyTorch port: the argparse surface of
`tools/replace/replace.py`, plus `--device` (default cuda; `cpu` runs on
the host).

    python tools/replace/replace_torch.py --src test5 [--tgt out5]
        [--data_root DIR] [--harmonize] [--device cuda|cpu]

Under the data root: the source clip's `unscreen_img/<src>/`
(`alphamask_*.jpg`, `frame_*.jpg`), its background
`unscreen_img/bg/bg_case.jpg`, the target's `unscreenbg_img/<tgt>/`
(`fg_*.jpg`, `alphamask_*.jpg`); writes `res_` and `compare_*.jpg` into
`merge_test_img/<src>_<tgt>/`. $UNSCREEN_DEVICE_ID picks the card.
"""
import argparse
import os.path as osp
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from video_unscreen_tpu_torch.config import select_device  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=str, default="test5")
    parser.add_argument("--tgt", type=str, default=None)
    parser.add_argument("--data_root", type=str,
                        default="./data/replace/edn")
    parser.add_argument("--harmonize", action="store_true",
                        help="tone the foreground toward the background in "
                             "Lab and blur the background before the "
                             "composite")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    device = (select_device() if args.device == "cuda" else None) \
        or args.device
    data_root = args.data_root
    args.tgt = args.tgt or ("out" + args.src[-1])
    args.src_img_dir = osp.join(data_root, "src_img", args.src + "_500")
    args.src_data_dir = osp.join(data_root, "unscreen_img", args.src)
    args.src_bg_image = osp.join(args.src_data_dir, "../bg/bg_case.jpg")
    args.tgt_data_dir = osp.join(data_root, "unscreenbg_img", args.tgt)
    args.dst_data_dir = osp.join(data_root, "merge_test_img",
                                 f"{args.src}_{args.tgt}")
    args.dst_vid_dir = osp.join(data_root, "video")
    from video_unscreen_tpu_torch.pipeline.replace import run
    return run(args, device=device)


if __name__ == "__main__":
    main()
