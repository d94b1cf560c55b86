"""Train the PyTorch port's STM on synthetic clips, on the cards.

  python tools/train_stm_torch.py --steps 800 --batch 8 --size 128

The flags of `tools/train_stm.py`, plus `--device` (default `cuda`; `cpu`
only when asked) and `--ranks` (the (data, model) mesh's ranks,
`parallel/families.py:run_tool`; default the card count). The memory read
runs kernel K4 forward and K5/K6 backward on the card, on each rank's
block of the batch. The checkpoint is a flax msgpack file that both the
port's `load_stm` and the JAX package's `load_variables` read; `--out`
defaults to `runs/stm_torch.msgpack` (a git-ignored directory), never to
the shipped `weights/stm.msgpack`.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.families import run_tool  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--out", type=str, default="runs/stm_torch.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--clip_len", type=int, default=3,
                        help="frames per training clip; clip_len-1 "
                             "memory slots")
    parser.add_argument("--clip_lens", type=str, default=None,
                        help="comma list of clip lengths cycled across "
                             "steps (e.g. 2,4,8); overrides --clip_len")
    parser.add_argument("--sizes", type=str, default=None,
                        help="comma list of square train sizes cycled "
                             "across steps (e.g. 128,256); overrides "
                             "--size")
    parser.add_argument("--save_every", type=int, default=0,
                        help="checkpoint to --out every N steps (0 = "
                             "only at the end)")
    parser.add_argument("--init_from", type=str, default=None,
                        help="fine-tune from a flax msgpack checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of the (data, model) mesh (default: "
                             "the card count, 1 with --device cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tool("stm", parse_args(argv))


if __name__ == "__main__":
    main()
