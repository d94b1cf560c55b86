"""Compare two eval sets of the same clips, clip by clip: how many GT
pixels and frame pixels differ, in how many frames, and by how much at
most. For the sets that `tools/make_eval_set.py` and
`tools/make_eval_set_torch.py` make at the same size.

    python tools/compare_eval_sets_torch.py SET_A SET_B

One line a clip of SET_A's `src_img/`; a frame pixel differs when any of
its three channels does. Reads with the port's codecs (no cv2).
"""
import argparse
import os
import os.path as osp
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.utils.fileio import (  # noqa: E402
    parallel_read_img, read_png)


def compare_dir(dir_a, dir_b):
    """(pixels that differ, frames with one, frames, largest |difference|,
    frame shape) over the same-named files of two directories."""
    names = sorted(os.listdir(dir_a))
    if names != sorted(os.listdir(dir_b)):
        raise SystemExit(f"{dir_a} and {dir_b} hold different files")
    paths = [[osp.join(d, n) for n in names] for d in (dir_a, dir_b)]
    if names[0].endswith(".png"):
        a, b = ([read_png(p) for p in ps] for ps in paths)
    else:
        a, b = (parallel_read_img(ps) for ps in paths)
    n_px = n_frames = top = 0
    for x, y in zip(a, b):
        d = np.abs(x.astype(np.int16) - y.astype(np.int16))
        if d.ndim == 3:
            d = d.max(axis=-1)
        n_px += int((d > 0).sum())
        n_frames += int(d.max() > 0)
        top = max(top, int(d.max()))
    return n_px, n_frames, len(names), top, a[0].shape


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("set_a")
    parser.add_argument("set_b")
    args = parser.parse_args(argv)
    rows = {}
    for vid in sorted(os.listdir(osp.join(args.set_a, "src_img"))):
        rows[vid] = {sub: compare_dir(osp.join(args.set_a, sub, vid),
                                      osp.join(args.set_b, sub, vid))
                     for sub in ("alpha_img", "src_img")}
        line = [vid]
        for sub, (n_px, n_fr, n, top, shape) in rows[vid].items():
            line.append(f"{sub} {shape}: {n_px} pixels differ in {n_fr}/{n} "
                        f"frames, max |diff| {top}")
        print(" | ".join(line), flush=True)
    return rows


if __name__ == "__main__":
    main()
