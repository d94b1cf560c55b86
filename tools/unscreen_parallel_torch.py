"""One process a video, over the cards of this machine: the PyTorch port's
`tools/unscreen_parallel.py`.

    python tools/unscreen_parallel_torch.py [--script green|bg|bg_offline]
        [--range 0-40] [--workers N] [--data_root DIR]

Reads the clip ids of `<data_root>/meta/vid_list.txt` (the data root
defaults to $UNSCREEN_DATA_ROOT, else ./data), keeps `--range` of them,
and runs `bash tools/unscreen_torch.sh <script> <clip> <i % N>` for clip
i, N of them at a time: the launcher exports the last argument as
UNSCREEN_DEVICE_ID, which `config.select_device` reads, so clip i runs on
card i % N.
"""
import argparse
import os
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.config import default_data_root  # noqa: E402
from video_unscreen_tpu_torch.utils.fileio import read_txt_list  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--script", type=str, default="green")
    parser.add_argument("--range", type=str, default=None, help="eg. 0-40")
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--data_root", type=str, default=None)
    return parser.parse_args(argv)


def commands(args):
    """(argv, env) of each clip's launch, in the order of the list."""
    root = args.data_root or default_data_root()
    vid_list = read_txt_list(osp.join(root, "meta/vid_list.txt"))
    if args.range:
        start, end = args.range.split("-")
        vid_list = vid_list[int(start):int(end)]
    workers = max(args.workers, 1)
    env = {**os.environ, "UNSCREEN_DATA_ROOT": root}
    return [(["bash", "tools/unscreen_torch.sh", args.script, vid,
              str(idx % workers)], env)
            for idx, vid in enumerate(vid_list)]


def main(argv=None, call=subprocess.call) -> int:
    """Run every clip through `call(argv, env=...)` (a process each by
    default); returns how many failed."""
    args = parse_args(argv)
    jobs = commands(args)
    with ThreadPoolExecutor(max_workers=max(args.workers, 1)) as pool:
        rets = list(pool.map(lambda job: call(job[0], env=job[1]), jobs))
    ok = sum(r == 0 for r in rets)
    print(f"\nVideos Done: {len(jobs)} ({ok} ok)")
    return len(jobs) - ok


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
