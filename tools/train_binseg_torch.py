"""Train the PyTorch port's DeepLabV3+ binary segmenter on synthetic
composites, on the cards.

  python tools/train_binseg_torch.py --steps 800 --batch 8 --size 128

The flags of `tools/train_binseg.py` (800 steps, batch 8, 128x128, lr
5e-4, `--init_from`, `--save_every`), plus `--device` (default `cuda`;
`cpu` only when asked) and `--ranks` (the (data, model) mesh's ranks,
`parallel/families.py:run_tool`; default the card count). The ASPP's
dropout draws from a generator seeded with `--seed`. The checkpoint is a
flax msgpack file that both the port's `load_deeplab` and the JAX
package's `load_variables` read; `--out` defaults to
`runs/deeplab_binseg_torch.msgpack` (git-ignored), never to the shipped
`weights/deeplab_binseg.msgpack`.
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
    parser.add_argument("--out", type=str,
                        default="runs/deeplab_binseg_torch.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--init_from", type=str, default=None,
                        help="fine-tune from a flax msgpack checkpoint")
    parser.add_argument("--save_every", type=int, default=0,
                        help="checkpoint to --out every N steps (0 = "
                             "only at the end)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of the (data, model) mesh (default: "
                             "the card count, 1 with --device cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tool("binseg", parse_args(argv))


if __name__ == "__main__":
    main()
