"""The four trainer families side by side, and the loop their tools share.

`family(name)` gives a family's batch maker (as its tool calls it, and
with float images: `float_batch`), state, step and loss, its model at
full and at reduced depth, its checkpoint reader and its eval forward on
a device batch ("matting", "binseg", "human", "iseg"; STM's trainer,
`train_stm.py`, keeps its own clip batches and tool).

`run_tool(name, args)` is the loop of `tools/train_<family>_torch.py`:
the family's model (`args.layers` where the tool has it) on
`args.device`, from `args.init_from` or a flax-like init seeded with
`args.seed`, `args.steps` steps on the maker's batches, the loss every
`args.log_every` steps, and a flax msgpack checkpoint at `args.out`
(every `args.save_every` steps too, where the tool has it). It refuses an
`--out` under the repository's `weights/` (the shipped checkpoints).
"""

from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ..models.deeplab import DeepLabV3Plus, build_deeplab
from ..models.human_parse import SCHPHumanParser
from ..models.iseg import DistMapsModel
from ..models.matting_unet import MattingUNet
from ..utils import checkpoint as ck
from . import data_synth, train, train_human, train_iseg, train_seg

REDUCED = (1, 1, 1, 1)
SHIPPED = Path(__file__).resolve().parents[2] / "weights"


def family(name: str) -> SimpleNamespace:
    """One family's pieces (the module docstring); the ISeg's trunk is a
    fixed ResNet-50, so its reduced model is the full one."""
    nchw = train.nchw
    if name == "matting":
        return SimpleNamespace(
            make_batch=data_synth.make_batch,
            float_batch=data_synth.make_batch, state=train.make_train_state,
            step=lambda m, o, s, seed=0: train.make_train_step(m, o, s),
            loss=train.matting_loss, full=MattingUNet,
            reduced=lambda: MattingUNet(layers=REDUCED),
            load=ck.load_matting_unet,
            forward=lambda m, b: m(nchw(b["img"]), nchw(b["alpha_pre"]),
                                   nchw(b["trimap"])))
    if name == "binseg":
        return SimpleNamespace(
            make_batch=train_seg.make_seg_batch,
            float_batch=train_seg.make_seg_batch,
            state=train_seg.make_seg_train_state,
            step=train_seg.make_seg_train_step, loss=train_seg.seg_loss,
            full=lambda: build_deeplab(2),
            reduced=lambda: DeepLabV3Plus(2, backbone_layers=REDUCED),
            load=ck.load_deeplab, forward=lambda m, b: m(nchw(b["img"])))
    if name == "human":
        return SimpleNamespace(
            make_batch=lambda rng, n, hw: train_human.make_human_batch(
                rng, n, hw, raw_uint8=True),
            float_batch=train_human.make_human_batch,
            state=train_human.make_human_train_state,
            step=train_human.make_human_train_step,
            loss=train_human.human_loss,
            full=lambda layers=(3, 4, 23, 3): SCHPHumanParser(
                20, layers=tuple(layers)),
            reduced=lambda: SCHPHumanParser(20, layers=REDUCED),
            load=ck.load_schp,
            forward=lambda m, b: m(nchw(
                train_human.normalize_bgr_uint8(b["img"]))))
    if name == "iseg":
        return SimpleNamespace(
            make_batch=train_iseg.make_click_batch,
            float_batch=train_iseg.make_click_batch,
            state=train_iseg.make_iseg_train_state,
            step=train_iseg.make_iseg_train_step, loss=train_iseg.iseg_loss,
            full=DistMapsModel, reduced=DistMapsModel, load=ck.load_iseg,
            forward=lambda m, b: m(nchw(b["img"]), b["points"]))
    raise ValueError(f"unknown trainer family {name!r}")


def run_tool(name: str, args) -> None:
    """The training loop of the family's tool (the module docstring)."""
    out = Path(args.out).resolve()
    if SHIPPED.resolve() in out.parents:
        raise SystemExit(f"--out {args.out}: the port's trainer does not "
                         f"write under weights/ (the shipped checkpoints)")
    fam = family(name)
    layers = getattr(args, "layers", None)
    model = fam.state(args.device, seed=args.seed,
                      init_from=getattr(args, "init_from", None),
                      model=fam.full(layers) if layers else fam.full())
    step_fn = fam.step(model, *train.make_optimizer(model, args.lr,
                                                    args.steps), args.seed)
    device = next(model.parameters()).device
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    print(f"device: {device} ({card})", flush=True)
    save_every = getattr(args, "save_every", 0)
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        loss = step_fn(fam.make_batch(rng, args.batch,
                                      (args.size, args.size)))
        if step == 0:   # the first step (a warm-up) ends before the clock
            float(loss)
            t1 = time.time()
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if save_every and step and step % save_every == 0:
            ck.save_variables(out, model)
            print(f"checkpoint @ step {step}", flush=True)
    if args.steps > 1:
        print(f"{(args.steps - 1) / (time.time() - t1):.3f} steps/s over "
              f"steps 2-{args.steps} (batches made on the host included)")
    ck.save_variables(out, model)
    print(f"saved {out}")
