"""Train the PyTorch port's SCHP human parser on synthetic people, on the
cards.

  python tools/train_human_torch.py --steps 2000 --batch 8 --size 224

The flags of `tools/train_human.py` (2000 steps, batch 8, 224x224, lr
5e-4, `--layers` 3 4 23 3 (ResNet-101), `--init_from`), plus `--device`
(default `cuda`; `cpu` only when asked) and `--ranks` (the (data, model)
mesh's ranks, `parallel/families.py:run_tool`; default the card count). As
the JAX tool, the batches go up as BGR uint8 (`raw_uint8=True`) and are
normalized on the device, and the gradient is clipped to global norm 1
before AdamW. The fusion dropout draws from a generator seeded with
`--seed`. The checkpoint is a flax msgpack file that both the port's
`load_schp` and the JAX package's `load_variables` read; `--out` defaults
to `runs/schp_human_torch.msgpack` (git-ignored), never to the shipped
`weights/schp_human.msgpack`.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.families import run_tool  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--out", type=str,
                        default="runs/schp_human_torch.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=25)
    parser.add_argument("--layers", type=int, nargs=4, default=(3, 4, 23, 3),
                        help="backbone stage depths (reference R101)")
    parser.add_argument("--init_from", type=str, default=None,
                        help="resume/fine-tune from a flax msgpack "
                             "checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of the (data, model) mesh (default: "
                             "the card count, 1 with --device cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tool("human", parse_args(argv))


if __name__ == "__main__":
    main()
