"""The five trainer families side by side, and the loop their tools share.

`family(name)` gives a family's batch maker (as its tool calls it, and
with float images: `float_batch`), state, step and loss, its model at
full and at reduced depth, its checkpoint reader and its eval forward on
a device batch ("matting", "binseg", "human", "iseg", "stm"; the STM has
no reduced form, and its forward is the decoder's raw logits on
`train_stm.batch_to_device`'s batch, `train_stm.stm_logits`).

`run_tool(name, args)` is the loop of `tools/train_<family>_torch.py`:
the family's model (`args.layers` where the tool has it) on
`args.device`, from `args.init_from` or a flax-like init seeded with
`args.seed`, `args.steps` steps on the maker's batches (the STM's tool
cycles `--clip_lens` and `--sizes`), the loss every `args.log_every`
steps, and a flax msgpack checkpoint at `args.out` (every
`args.save_every` steps too, where the tool has it). It refuses an
`--out` under the repository's `weights/` (the shipped checkpoints).

`args.ranks` ranks train one step over the (data, model) mesh of
`parallel/mesh.py:make_mesh`, as JAX's tools do over every device
(`parallel/train.py`'s step); the default is the card count (1 under
`--device cpu`), and 1 is today's one-process run. Several ranks are
spawned by `parallel/launch.py:run_ranks`: NCCL when each has a card of
its own, else `gloo` (ranks sharing a card, or on the host). Every rank
makes the same batches and loads or initializes the whole model before
it is split; rank 0 prints, and writes the whole checkpoint.
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
from ..models.stm import STM
from ..utils import checkpoint as ck
from ..utils.device import resolve_device
from . import (data_synth, train, train_human, train_iseg, train_seg,
               train_stm)
from .launch import run_ranks
from .mesh import make_mesh
from .tensor_parallel import full_state_dict

REDUCED = (1, 1, 1, 1)
SHIPPED = Path(__file__).resolve().parents[2] / "weights"
TOOL_DEADLINE = 7 * 24 * 3600.0   # a tool's ranks: seconds until killed
TOOL_COLLECTIVE_TIMEOUT = 1800.0


def family(name: str) -> SimpleNamespace:
    """One family's pieces (the module docstring); the ISeg's trunk is a
    fixed ResNet-50, so its reduced model is the full one."""
    nchw = train.nchw
    if name == "matting":
        return SimpleNamespace(
            make_batch=data_synth.make_batch,
            float_batch=data_synth.make_batch, state=train.make_train_state,
            step=lambda m, o, s, seed=0, mesh=None: train.make_train_step(
                m, o, s, mesh),
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
    if name == "stm":
        return SimpleNamespace(
            make_batch=train_stm.make_clip_batch,
            float_batch=train_stm.make_clip_batch,
            state=train_stm.make_stm_train_state,
            step=lambda m, o, s, seed=0, mesh=None:
            train_stm.make_stm_train_step(m, o, s, mesh),
            loss=train_stm.stm_loss, full=STM, reduced=STM,
            load=ck.load_stm,
            forward=lambda m, b: train_stm.stm_logits(m, b)[0])
    raise ValueError(f"unknown trainer family {name!r}")


def default_ranks(device: torch.device) -> int:
    """JAX's tools mesh every device: the card count, 1 on the host."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def run_tool(name: str, args) -> None:
    """The training loop of the family's tool (the module docstring)."""
    out = Path(args.out).resolve()
    if SHIPPED.resolve() in out.parents:
        raise SystemExit(f"--out {args.out}: the port's trainer does not "
                         f"write under weights/ (the shipped checkpoints)")
    device = resolve_device(args.device)
    n = getattr(args, "ranks", None) or default_ranks(device)
    if n == 1:
        _train(name, args, make_mesh())
        return
    backend = "gloo"
    if device.type == "cuda":
        if name == "stm":
            from ..ops.kernels import build
            build.build()   # K4-K6, once, before the ranks load them
        if n <= torch.cuda.device_count():
            backend = "nccl"
    run_ranks(_tool_rank, n, (name, args, n), backend=backend,
              timeout=TOOL_DEADLINE,
              collective_timeout=TOOL_COLLECTIVE_TIMEOUT)


def _tool_rank(rank: int, name: str, args, n_ranks: int) -> None:
    _train(name, args, make_mesh(n_ranks, timeout=TOOL_COLLECTIVE_TIMEOUT))


def save_whole(path, model, mesh) -> None:
    """`model` written whole from rank 0 of `mesh`: every rank gathers its
    split leaves (`full_state_dict`, a collective), rank 0 writes them
    (`utils/checkpoint.py:save_variables`)."""
    state = full_state_dict(model)
    if mesh.rank == 0:
        ck.save_variables(path, model, state)


def _ints(text):
    return [int(v) for v in text.split(",")] if text else None


def _train(name: str, args, mesh) -> None:
    """The loop on this rank of `mesh` (a one-rank mesh: one process)."""
    def log(*a, **kw):
        if mesh.rank == 0:
            print(*a, flush=True, **kw)

    out = Path(args.out).resolve()
    fam = family(name)
    layers = getattr(args, "layers", None)
    model = fam.state(args.device, seed=args.seed,
                      init_from=getattr(args, "init_from", None),
                      model=fam.full(layers) if layers else fam.full(),
                      mesh=mesh)
    step_fn = fam.step(model, *train.make_optimizer(model, args.lr,
                                                    args.steps), args.seed,
                       mesh=mesh)
    device = next(model.parameters()).device
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    log(f"device: {device} ({card})")
    log(f"mesh: {dict(mesh.shape)} on {device.type}")
    save_every = getattr(args, "save_every", 0)
    # the STM's tool cycles clip lengths, then sizes, step by step
    clip_lens = _ints(getattr(args, "clip_lens", None)) or [
        getattr(args, "clip_len", None)]
    sizes = _ints(getattr(args, "sizes", None)) or [args.size]
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        cl = clip_lens[step % len(clip_lens)]
        size = sizes[(step // len(clip_lens)) % len(sizes)]
        batch = fam.make_batch(rng, args.batch, (size, size),
                               **({} if cl is None else {"clip_len": cl}))
        loss = step_fn(batch)
        if step == 0:   # the first step (a warm-up) ends before the clock
            float(loss)
            t1 = time.time()
        if step % args.log_every == 0 or step == args.steps - 1:
            tag = "" if cl is None else f" T={cl}"
            log(f"step {step:5d}{tag} loss {float(loss):.4f} "
                f"({time.time() - t0:.1f}s)")
        if save_every and step and step % save_every == 0:
            save_whole(out, model, mesh)
            log(f"checkpoint @ step {step}")
    if args.steps > 1:
        log(f"{(args.steps - 1) / (time.time() - t1):.3f} steps/s over "
            f"steps 2-{args.steps} (batches made on the host included)")
    save_whole(out, model, mesh)
    log(f"saved {out}")
