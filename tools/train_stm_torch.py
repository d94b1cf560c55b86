"""Train the PyTorch port's STM on synthetic clips, on one card.

  python tools/train_stm_torch.py --steps 800 --batch 8 --size 128

The flags of `tools/train_stm.py`, plus `--device` (default `cuda`; `cpu`
only when asked). The memory read runs kernel K4 forward and K5/K6
backward on the card. The checkpoint is a flax msgpack file that both the
port's `load_stm` and the JAX package's `load_variables` read; `--out`
defaults to `runs/stm_torch.msgpack` (a git-ignored directory), never to
the shipped `weights/stm.msgpack`.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_unscreen_tpu_torch.parallel.train_stm import (  # noqa: E402
    make_clip_batch, make_optimizer, make_stm_train_state,
    make_stm_train_step)
from video_unscreen_tpu_torch.utils.checkpoint import save_stm  # noqa


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
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = Path(args.out).resolve()
    shipped = (Path(__file__).resolve().parents[1] / "weights").resolve()
    if shipped in out.parents:
        raise SystemExit(f"--out {args.out}: the port's trainer does not "
                         f"write under weights/ (the shipped checkpoints)")
    model = make_stm_train_state(args.device, seed=args.seed,
                                 init_from=args.init_from)
    device = next(model.parameters()).device
    optimizer, scheduler = make_optimizer(model, args.lr, args.steps)
    train_step = make_stm_train_step(model, optimizer, scheduler)
    clip_lens = ([int(v) for v in args.clip_lens.split(",")]
                 if args.clip_lens else [args.clip_len])
    sizes = ([int(v) for v in args.sizes.split(",")]
             if args.sizes else [args.size])
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    print(f"device: {device} ({name})", flush=True)

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        cl = clip_lens[step % len(clip_lens)]
        sz = sizes[(step // len(clip_lens)) % len(sizes)]
        batch = make_clip_batch(rng, args.batch, (sz, sz), clip_len=cl)
        loss = train_step(batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} T={cl} loss {float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save_stm(out, model)
            print(f"checkpoint @ step {step}", flush=True)
    save_stm(out, model)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
