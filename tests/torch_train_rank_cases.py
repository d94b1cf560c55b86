"""What the spawned ranks of the training-over-ranks tests run.

`parallel/launch.py:run_ranks` unpickles a rank's function by its module
path, so these functions live here, in a module that imports neither JAX
nor the JAX package (as `tests/torch_rank_cases.py`). Every function runs
all the cases of its test file in one spawn of 4 `gloo` ranks on the
CPU, on a (data 2, model 2) mesh, and returns numpy arrays and plain
values: whole gradients, statistics and parameters from rank 0, the
shapes each rank holds from every rank.

The families run at the small widths of `tests/test_torch_train_*.py`:
stages (1, 1, 1, 1) (the ISeg's ResNet-50 too, `shallow_iseg`), 64x64,
from the port's seeded flax-like init (seed 0), the STM from
weights/stm.msgpack.
"""

import contextlib
import io

import numpy as np
import torch
import torch.nn as nn

from video_unscreen_tpu_torch.models import iseg as piseg
from video_unscreen_tpu_torch.models.deeplab import DeepLabV3Plus
from video_unscreen_tpu_torch.models.dropout import dropouts
from video_unscreen_tpu_torch.models.human_parse import SCHPHumanParser
from video_unscreen_tpu_torch.models.matting_unet import MattingUNet
from video_unscreen_tpu_torch.models.resnet import ResNet
from video_unscreen_tpu_torch.models.stm import STM
from video_unscreen_tpu_torch.parallel import families, train
from video_unscreen_tpu_torch.parallel.launch import heartbeat
from video_unscreen_tpu_torch.parallel.mesh import (make_mesh,
                                                    param_shardings,
                                                    spatial_sharding)
from video_unscreen_tpu_torch.parallel.tensor_parallel import (
    full_grads, full_state_dict, held_bytes, shard_model, sync_data_axis)

LAYERS = (1, 1, 1, 1)
STM_WEIGHTS = "weights/stm.msgpack"
# the tools' (lr, steps), as the single-process trainer tests take them
OPTIM = {"matting": (1e-3, 2000), "binseg": (5e-4, 800),
         "human": (5e-4, 2000), "iseg": (5e-4, 1000), "stm": (5e-4, 800)}
FAMILIES = tuple(OPTIM)


@contextlib.contextmanager
def _shallow_trunk():
    orig = piseg.ResNet
    piseg.ResNet = lambda block, layers, **kw: ResNet(block, LAYERS, **kw)
    try:
        yield
    finally:
        piseg.ResNet = orig


def shallow_iseg():
    """`DistMapsModel` on a ResNet of stages (1, 1, 1, 1), as
    `tests/test_torch_train_iseg.py` builds it."""
    with _shallow_trunk():
        return piseg.DistMapsModel()


def reduced(name):
    """The family's model at the tests' small widths."""
    return {"matting": lambda: MattingUNet(layers=LAYERS),
            "binseg": lambda: DeepLabV3Plus(2, backbone_layers=LAYERS),
            "human": lambda: SCHPHumanParser(20, layers=LAYERS),
            "iseg": shallow_iseg, "stm": STM}[name]()


def make_state(name, mesh=None, dropout=True, dtype=torch.float32):
    """The family's reduced model from the seeded init (the STM from its
    shipped weights) on the host, split over `mesh`, in `dtype`; dropouts
    at rate 0 unless `dropout`."""
    model = families.family(name).state(
        "cpu", seed=0, init_from=STM_WEIGHTS if name == "stm" else None,
        model=reduced(name), mesh=mesh).to(dtype)
    if not dropout:
        for d in dropouts(model):
            d.rate = 0.0
    return model


def as_float64(batch):
    """The batch with its float arrays in float64."""
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _np(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _stats(model):
    return _np({k: v for k, v in model.state_dict().items()
                if "running" in k})


def _step(name, batch, mesh=None, dropout=True, dtype=torch.float32,
          dropout_seed=1):
    """One step of the family in `dtype` (a float64 one on the batch in
    float64): the loss and gradients (`TrainStep.value_and_grad`), then
    the update; returns the model, the optimizer and the readings."""
    model = make_state(name, mesh, dropout, dtype)
    if dtype == torch.float64:
        batch = as_float64(batch)
    opt, sched = train.make_optimizer(model, *OPTIM[name])
    step = families.family(name).step(model, opt, sched, dropout_seed,
                                      mesh=mesh)
    out = {"loss": float(step.value_and_grad(batch)),
           "grads": _np(full_grads(model)), "stats": _stats(model)}
    norm = step.apply()
    out.update(norm=None if norm is None else float(norm),
               stepped=_np(full_state_dict(model)))
    return model, opt, out


def one_process_step(name, batch, dropout=True, dtype=torch.float32):
    """The readings of `_step` in this process, without a mesh."""
    return _step(name, batch, None, dropout, dtype)[2]


def one_process_loss(name, batch):
    """The family's loss of one process on `batch` (no update)."""
    model = make_state(name)
    step = families.family(name).step(
        model, *train.make_optimizer(model, *OPTIM[name]))
    return float(step.value_and_grad(batch))


def _holdings(model, opt):
    """For each parameter: (its shape, its gradient's, its two moments')
    on this rank."""
    out = {}
    for n, p in model.named_parameters():
        st = opt.state[p]
        out[n] = (tuple(p.shape), tuple(p.grad.shape),
                  tuple(st["exp_avg"].shape), tuple(st["exp_avg_sq"].shape))
    return out


def train_cases(rank, batches, band_batch, save_dir, steps_batch,
                tool_args):
    """Every family: one float32 step with dropout off (against JAX) and
    one float64 step with it on (against one process), each rank's
    holdings, and the whole model written from every rank
    (`families.save_whole`); the MattingUNet on a batch whose unknown
    band differs by rank (its loss only), and 5 steps of it on one batch (`steps_batch`); each
    tool's loop (`families._train`) with its parsed flags (`tool_args`:
    family -> namespace), rank 0's prints returned. Then, outside the
    mesh, each rank takes the one-process references of its share of
    the families (`references`), and rank 3 the band batch's losses (the
    whole batch's and each data block's own). A `heartbeat` ends each
    phase, so `run_ranks`'s deadline bounds a phase, not the whole job."""
    mesh = make_mesh(4)
    out = {"mesh": dict(mesh.shape), "coords": dict(mesh.coords)}
    for name in FAMILIES:
        _, _, off = _step(name, batches[name], mesh, dropout=False)
        model, opt, on = _step(name, batches[name], mesh,
                               dtype=torch.float64)
        families.save_whole(f"{save_dir}/{name}.msgpack", model, mesh)
        out[name] = {"off": off, "on": on, "held": _holdings(model, opt),
                     "bytes": held_bytes(model, opt),
                     "specs": param_shardings(reduced(name), mesh)}
        if rank:   # rank 0 returns the whole arrays
            for r in (off, on):
                r.pop("grads"), r.pop("stepped"), r.pop("stats")
        del model, opt
        heartbeat()
    model = make_state("matting", mesh)
    step = families.family("matting").step(
        model, *train.make_optimizer(model, *OPTIM["matting"]), mesh=mesh)
    out["band_loss"] = float(step.value_and_grad(band_batch))
    model = make_state("matting", mesh)
    step = families.family("matting").step(
        model, *train.make_optimizer(model, *OPTIM["matting"]), mesh=mesh)
    out["losses"] = [float(step(steps_batch)) for _ in range(5)]
    heartbeat()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        for name, args in tool_args.items():
            families._train(name, args, mesh)
            heartbeat()
    out["printed"] = printed.getvalue()
    out["references"] = references(FAMILIES[rank::4], batches)
    if rank == 3:   # the band batch's one-process losses: whole and halves
        out["references"]["band"] = [one_process_loss("matting", b) for b in (
            band_batch, *({k: v[i:i + 2] for k, v in band_batch.items()}
                          for i in (0, 2)))]
    return out


def tool_and_train_cases(rank, tool_rank, tool_args, *args):
    """A tool's own `--ranks` spawn and `train_cases` in one spawn: the
    rank function and arguments that `families.run_tool` hands to
    `run_ranks` (`tool_rank(rank, *tool_args)`, its prints on this rank
    kept), then `train_cases(rank, *args)`."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tool_rank(rank, *tool_args)
    heartbeat()
    out = train_cases(rank, *args)
    out["tool_printed"] = printed.getvalue()
    return out


def references(names, batches):
    """For each family of `names`, one process's float64 step on the whole
    batch with dropout on (`one_process_step`), and its float64
    gradients with dropout off (the same, for a model without dropout)."""
    out = {}
    for name in names:
        on = one_process_step(name, batches[name], dtype=torch.float64)
        off = on if not dropouts(reduced(name)) else one_process_step(
            name, batches[name], dropout=False, dtype=torch.float64)
        out[name] = {"on": on, "off_grads": off["grads"]}
        heartbeat()
    return out


class _TwoConvs(nn.Module):
    """Two split convolutions; `forward` reaches only the first."""

    def __init__(self):
        super().__init__()
        self.used = nn.Conv2d(3, 64, 3, padding=1)
        self.unused = nn.Conv2d(64, 64, 1)

    def forward(self, x):
        return self.used(x)


def sharding_cases(rank, spatial):
    """`spatial_sharding`'s block of `spatial` on this rank and its gather;
    the holdings of the MattingUNet (a transposed conv) and the ISeg (its
    depthwise convs) after one step; a split leaf the loss does not reach
    (an exact zero block, whole on gathering)."""
    mesh = make_mesh(4)
    sharding = spatial_sharding(mesh)
    block = sharding.shard(spatial)
    out = {"coords": dict(mesh.coords), "block": block,
           "gathered": sharding.gather(torch.from_numpy(block)).numpy()}
    rng = np.random.RandomState(5)
    for name, batch in (("matting", {
            "img": rng.rand(4, 64, 64, 3).astype(np.float32),
            "alpha_pre": rng.rand(4, 64, 64, 1).astype(np.float32),
            "trimap": np.eye(3, dtype=np.float32)[
                rng.randint(0, 3, (4, 64, 64))],
            "alpha_gt": rng.rand(4, 64, 64).astype(np.float32)}),
            ("iseg", {
                "img": rng.randn(4, 64, 64, 3).astype(np.float32),
                "points": np.tile(np.array([[1.0, 20, 30]] + [[-1, -1, -1]]
                                           * 19, np.float32), (4, 1, 1)),
                "label": (rng.rand(4, 64, 64) > 0.5).astype(np.int32)})):
        model, opt, _ = _step(name, batch, mesh)
        out[name] = _holdings(model, opt)

    torch.manual_seed(0)
    model = sync_data_axis(shard_model(_TwoConvs(), mesh), mesh)
    model.train_mesh = mesh
    opt, sched = train.make_optimizer(model, 1e-3, 10)
    step = train.make_step(
        model, opt, sched,
        lambda m, b, axis=None: train.over_batch(
            m(b["x"].permute(0, 3, 1, 2)).square().sum(), 64, axis),
        mesh=mesh)
    step.value_and_grad({"x": rng.randn(4, 8, 8, 3).astype(np.float32)})
    out["unused_block"] = model.unused.weight.grad.numpy().copy()
    out["unused_whole"] = full_grads(model)["unused.weight"].numpy()
    return out
