"""Metric harness CLI of the PyTorch port: the protocol of `tools/eval.py`,
plus `--device` (default cuda; `cpu` runs on the host).

    python tools/eval_torch.py --exp_name test_green [--data_root DIR]
        [--device cuda|cpu]

Pairs `<data_root>/alpha_img/<vid>/*.*` (GT) with
`<data_root>/<exp_name>_img/<vid>/alphamask_*.*` for every clip of
`<data_root>/meta/vid_list2.txt`, prints MIOU / SAD / MSE / GRAD / CONN
per clip and over all, and writes them to
`<data_root>/results/<exp_name>.txt`. The data root defaults to
$UNSCREEN_DATA_ROOT, else ./data; $UNSCREEN_DEVICE_ID picks the card.
"""
import argparse
import os.path as osp
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.config import (  # noqa: E402
    default_data_root, select_device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--exp_name", type=str, default="test_green")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    device = (select_device() if args.device == "cuda" else None) \
        or args.device
    data_root = args.data_root or default_data_root()
    cfg = {"data": {
        "range": None,
        "meta_fn": osp.join(data_root, "meta/vid_list2.txt"),
        "gt_data_dir": osp.join(data_root, "alpha_img"),
        "gt_data_tmpl": "*.*",
        "pred_data_dir": osp.join(data_root, f"{args.exp_name}_img"),
        "pred_data_tmpl": "alphamask_*.*",
        "save_data_fn": osp.join(data_root, f"results/{args.exp_name}.txt"),
    }}
    from video_unscreen_tpu_torch.pipeline.evaluate import run
    return run(cfg, device=device)


if __name__ == "__main__":
    main()
