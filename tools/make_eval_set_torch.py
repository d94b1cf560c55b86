"""Generate the synthetic evaluation set with the PyTorch port: the clips
and layout of `tools/make_eval_set.py`, drawn by the port's cv2-free clip
makers and written by its codecs (JPEG frames at quality 95, PNG GTs).

    python tools/make_eval_set_torch.py --data_root /tmp/unscreen_eval \
        --frames 12 --height 288 --width 512 [--workers 5]

`--workers` makes that many clips at once, each in a process of its own
(a 1080p clip of 12 frames takes about 100 s in one process).

Layout:
  <root>/src_img/<vid>/frame_%06d.jpg     pipeline input
  <root>/alpha_img/<vid>/frame_%06d.png   GT soft alphas (lossless)
  <root>/meta/vid_list.txt                all clips
  <root>/meta/vid_list_green.txt          green-mode clips
  <root>/meta/vid_list_natural.txt        bg-mode clips

The JPEG writes (and the "jpeg" variant's round trip) go through the
port's own codec, bit-equal to cv2's.
"""
import argparse
import os
import os.path as osp
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.data_synth import \
    write_eval_clip  # noqa: E402

# (vid, kind, seed, variant): tools/make_eval_set.py's table
CLIPS = (
    ("green1", "green", 4, "plain"),
    ("green2", "green", 11, "plain"),
    ("natural1", "natural", 7, "plain"),
    ("natural2", "natural", 19, "plain"),
    ("green_mblur", "green", 23, "motion_blur"),
    ("green_jpeg", "green", 31, "jpeg"),
    ("green_twop", "green", 37, "two_person"),
    ("natural_shadow", "natural", 29, "shadow"),
    ("natural_occl", "natural", 41, "occluder"),
    ("natural_twop", "natural", 43, "two_person"),
)


def make_clips(root, vids, frames, height, width, workers=1):
    """The clips of `CLIPS` named in `vids` (`data_synth.write_eval_clip`),
    `workers` at a time (spawned processes); returns their report lines
    in `CLIPS`' order."""
    todo = [(root, *c, frames, height, width) for c in CLIPS
            if c[0] in vids]
    if workers <= 1:
        return [write_eval_clip(*a) for a in todo]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(min(workers, len(todo)),
                             mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(write_eval_clip, *zip(*todo)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_root", type=str, default="/tmp/unscreen_eval")
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--height", type=int, default=288)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--workers", type=int, default=1)
    args = parser.parse_args(argv)

    root = args.data_root
    for line in make_clips(root, {c[0] for c in CLIPS}, args.frames,
                           args.height, args.width, args.workers):
        print(line)

    meta = osp.join(root, "meta")
    os.makedirs(meta, exist_ok=True)
    with open(osp.join(meta, "vid_list.txt"), "w") as fh:
        fh.write("\n".join(v for v, _, _, _ in CLIPS) + "\n")
    for kind in ("green", "natural"):
        with open(osp.join(meta, f"vid_list_{kind}.txt"), "w") as fh:
            fh.write("\n".join(v for v, k, _, _ in CLIPS if k == kind)
                     + "\n")
    print(f"eval set ready under {root}")


if __name__ == "__main__":
    main()
