"""Train the PyTorch port's MattingUNet on synthetic composites, on the cards.

  python tools/train_matting_torch.py --steps 2000 --batch 16

The flags of `tools/train_matting.py` (its defaults: 2000 steps, batch 16,
128x128, lr 1e-3, `--init_from`), plus `--device` (default `cuda`; `cpu`
only when asked) and `--ranks` (the (data, model) mesh's ranks,
`parallel/families.py:run_tool`; default the card count). The checkpoint
is a flax msgpack file that both the port's `load_matting_unet` and the
JAX package's `load_variables` read; `--out` defaults to
`runs/matting_unet_torch.msgpack` (a git-ignored directory), never to the
shipped `weights/matting_unet.msgpack`.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.families import run_tool  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=str,
                        default="runs/matting_unet_torch.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--init_from", type=str, default=None,
                        help="fine-tune from a flax msgpack checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of the (data, model) mesh (default: "
                             "the card count, 1 with --device cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tool("matting", parse_args(argv))


if __name__ == "__main__":
    main()
