"""Train the PyTorch port's click-based interactive segmenter
(DistMapsModel) on synthetic clicks, on the cards.

  python tools/train_iseg_torch.py --steps 1000 --batch 8 --size 128

The flags of `tools/train_iseg.py` (1000 steps, batch 8, 128x128, lr 5e-4;
like it, no `--init_from`), plus `--device` (default `cuda`; `cpu` only
when asked) and `--ranks` (the (data, model) mesh's ranks,
`parallel/families.py:run_tool`; default the card count). The ASPP's
dropout draws from a generator seeded with `--seed`. The checkpoint is a
flax msgpack file that both the port's `load_iseg` and the JAX package's
`load_variables` read; `--out` defaults to `runs/iseg_torch.msgpack`
(git-ignored), never to the shipped `weights/iseg.msgpack`.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.families import run_tool  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--out", type=str,
                        default="runs/iseg_torch.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of the (data, model) mesh (default: "
                             "the card count, 1 with --device cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tool("iseg", parse_args(argv))


if __name__ == "__main__":
    main()
