"""The five trainers' steps over a (data 2, model 2) mesh of 4 `gloo` CPU
ranks, against the JAX value-and-grad and the port's one-process step.

One spawn of 4 ranks for the file (`parallel/launch.py:run_ranks`, made
by the matting tool's own `--ranks 4` run; what they run is
`tests/torch_train_rank_cases.py:tool_and_train_cases`), every family
at the small widths of `tests/test_torch_train_*.py` (stages (1, 1, 1,
1), 64x64, the tools' optimizers), from the port's seeded init (the STM
from weights/stm.msgpack), on one batch of the JAX maker:

- dropout off: rank 0's loss, whole gradients (gathered over the model
  axis) and BatchNorm statistics against the jitted JAX value-and-grad on
  the whole batch (flax's dropout patched to the identity), to
  `tests/torch_train_util.py:check_loss_and_grads` and `check_stats`. Its
  float64 reference (`exact`) is the port's own one-process float64
  gradient, which the single-process tests hold to JAX's float64 to 1e-6
  of each tensor's max (the STM, as its test, without one). The ranks
  take these one-process references too, each its share of the families
  after the mesh's work, outside the mesh;
- dropout on, in float64: the same against the port's one-process step
  on the whole batch (the same generator: every rank draws the whole
  batch's mask and keeps its block): the loss and the SCHP's global norm
  (before its clip) to 1e-9 relative, the gradients to 1e-6 of each
  tensor's max (`check_float64_grads`' rule, plus 2e-9 of the largest
  |g| for a tensor that is zero but for rounding), the statistics to
  `check_stats`, the updated parameters to `check_step`. In float32 the
  two runs' gradients are each within float32's noise of the float64
  ones, and that noise (BatchNorms over a few values a channel) is what
  the JAX comparison's rule is made of; in float64 the comparison sees
  the collectives alone;
- every rank holds half of each leaf that `param_shardings` splits (the
  parameter, its gradient and both AdamW moments), the rest whole;
- the checkpoint that `families.save_whole` writes from the 4 ranks (the
  whole state gathered, `save_variables` on rank 0): bit for
  bit the ranks' whole model, read by the port's loader and by JAX's
  `load_variables`;
- the MattingUNet on a batch whose unknown band is 16 times larger on one
  data rank than on the other: the loss of one process (the band's size
  over the whole batch), not a mean of the ranks' own;
- JAX's `make_train_step(model, optimizer, make_mesh(4))` (on 4 of the 8
  virtual CPU devices) and the ranks reach the same loss over 5 steps of
  one batch, and it falls (`tests/test_parallel.py:36-61`);
- the five tools' runs with each tool's own flags: the matting tool's
  `main` with `--ranks 4` makes the file's one spawn (the cases above ride
  it, after the tool's own rank function), and the other four tools'
  loops run on its mesh (`families._train`): the mesh printed as the JAX
  tools print it, one whole checkpoint each that JAX's `load_variables`
  reads.
"""
import contextlib
import importlib.util
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from tests import torch_train_rank_cases as cases
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_train_util import (check_loss_and_grads, check_stats,
                                    check_step, flax_dropout_off,
                                    grads_tree, np_tree)
from video_unscreen_tpu.models import MattingUNet as JMattingUNet
from video_unscreen_tpu.models import iseg as jiseg
from video_unscreen_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from video_unscreen_tpu.models.human_parse import SCHPHumanParser as JSCHP
from video_unscreen_tpu.models.resnet import ResNet as JResNet
from video_unscreen_tpu.models.stm import STM as JSTM
from video_unscreen_tpu.parallel import data_synth as jds
from video_unscreen_tpu.parallel import make_mesh as jax_make_mesh
from video_unscreen_tpu.parallel.mesh import (
    batch_sharding as jax_batch_sharding,
    param_shardings as jax_param_shardings, replicate as jax_replicate)
from video_unscreen_tpu.parallel import train as jtr
from video_unscreen_tpu.parallel import train_human as jth
from video_unscreen_tpu.parallel import train_iseg as jti
from video_unscreen_tpu.parallel import train_seg as jts
from video_unscreen_tpu.parallel import train_stm as jstm
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models.dropout import dropouts
from video_unscreen_tpu_torch.parallel import families
from video_unscreen_tpu_torch.parallel.launch import run_ranks
from video_unscreen_tpu_torch.utils.checkpoint import (_leaves, read_msgpack,
                                                       variables_tree)

ROOT = Path(__file__).resolve().parents[1]
HW = (64, 64)
FAMILIES = cases.FAMILIES


def _batches():
    """The JAX makers' batches of the single-process tests (the human's
    with float images; the segmenter's with a weight map)."""
    rng = lambda: np.random.RandomState(0)  # noqa: E731
    seg = jts.make_seg_batch(rng(), 4, HW)
    seg["weight"] = np.random.RandomState(1).uniform(
        0.5, 2.0, seg["label"].shape).astype(np.float32)
    return {"matting": jds.make_batch(rng(), 2, HW), "binseg": seg,
            "human": jth.make_human_batch(rng(), 2, HW),
            "iseg": jti.make_click_batch(rng(), 4, HW),
            "stm": jstm.make_clip_batch(rng(), 2, HW, 3)}


def _band_batch():
    """A matting batch of 4 whose first data block (items 0-1) is unknown
    everywhere and whose second is unknown on a 16x16 patch only."""
    batch = jds.make_batch(np.random.RandomState(4), 4, HW)
    cls = np.zeros((4,) + HW, np.int64)
    cls[:2] = 1
    cls[2:, 8:24, 8:24] = 1
    batch["trimap"] = np.eye(3, dtype=np.float32)[cls]
    return batch


def _steps_batch():
    """`tests/test_parallel.py`'s batch of 4 at 64x64."""
    rng = np.random.RandomState(0)
    n, (h, w) = 4, HW
    trimap_cls = rng.randint(0, 3, (n, h, w))
    return {"img": rng.rand(n, h, w, 3).astype(np.float32),
            "alpha_pre": rng.rand(n, h, w, 1).astype(np.float32),
            "trimap": np.eye(3, dtype=np.float32)[trimap_cls],
            "alpha_gt": rng.rand(n, h, w).astype(np.float32)}


@pytest.fixture(scope="module")
def batches():
    return _batches()


# the tool whose own `--ranks 4` spawn carries the file's cases
SPAWNING_TOOL = "matting"


def _tool_argv(name, out_dir):
    """Each tool's flags: `--ranks 4 --device cpu`, 1 step of batch 2 at
    64x64 (the SCHP at stages (1, 1, 1, 1)), the checkpoint to
    `out_dir / <family>`."""
    argv = ["--steps", "1", "--batch", "2", "--size", "64", "--device",
            "cpu", "--ranks", "4", "--out", str(out_dir / name)]
    if name == "human":
        argv += ["--layers", "1", "1", "1", "1"]
    return argv


def _tool_args(out_dir):
    """The other tools' flags (`_tool_argv`), parsed by each tool, for
    their loops on the ranks (`families._train`)."""
    return {name: _tool(name).parse_args(_tool_argv(name, out_dir))
            for name in FAMILIES if name != SPAWNING_TOOL}


@pytest.fixture(scope="module")
def ranks(batches, tmp_path_factory):
    """One spawn of 4 ranks for the file: the matting tool's own `main`
    with `--ranks 4` makes it (`families.run_tool` -> `run_ranks`), and
    each rank runs the tool's rank function and then
    `cases.train_cases`."""
    save_dir = tmp_path_factory.mktemp("ranks")
    tools_dir = tmp_path_factory.mktemp("tools")
    spawns = []

    def tool_spawn(fn, n, args, backend, timeout, collective_timeout):
        # the tool's deadline and collective timeout are kept for the test
        # to check; the spawn runs on the file's own (600 s, and
        # `run_ranks`' 60 s), so that a hung collective fails fast
        spawns.append(dict(fn=fn, n=n, backend=backend, timeout=timeout,
                           collective_timeout=collective_timeout))
        spawns[-1]["got"] = run_ranks(
            cases.tool_and_train_cases, n,
            (fn, args, batches, _band_batch(), str(save_dir),
             _steps_batch(), _tool_args(tools_dir)),
            backend=backend, timeout=600)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(families, "run_ranks", tool_spawn)
        _tool(SPAWNING_TOOL).main(_tool_argv(SPAWNING_TOOL, tools_dir))
    (spawn,) = spawns
    got = spawn.pop("got")
    refs = {}
    for r in got:
        refs.update(r.pop("references"))
    return {"ranks": got, "dir": save_dir, "tools": tools_dir,
            "references": refs, "spawn": spawn}


def _holder(name, arrays=None, grads=None):
    """A fresh one-process model of the family holding the given whole
    parameters and buffers (by name) and gradients (in their type)."""
    model = cases.reduced(name)
    if grads is not None and next(iter(grads.values())).dtype == np.float64:
        model.double()
    if arrays is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in arrays.items()}, strict=False)
    if grads is not None:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
    return model


@contextlib.contextmanager
def _jax_family(name):
    """(JAX model, its init's inputs, loss, the loss's extra arguments) of
    the family at the tests' widths; the ISeg's trunk is patched to
    stages (1, 1, 1, 1) while the context is open (flax builds it when the
    model runs)."""
    key = jax.random.PRNGKey(0)
    z = jnp.zeros((1,) + HW + (3,))
    layers = cases.LAYERS
    with pytest.MonkeyPatch.context() as mp:
        if name == "matting":
            yield (JMattingUNet(layers=layers), (z, z[..., :1], z),
                   jtr.matting_loss, ())
        elif name == "binseg":
            yield (JDeepLab(num_classes=2, backbone_layers=layers), (z,),
                   jts.seg_loss, (key,))
        elif name == "human":
            yield (JSCHP(num_classes=20, layers=layers), (z,),
                   jth.human_loss, (key,))
        elif name == "iseg":
            mp.setattr(jiseg, "ResNet", lambda **kw: JResNet(
                **dict(kw, layers=layers)))
            yield (jiseg.DistMapsModel(), (z, jnp.full((1, 20, 3), -1.0)),
                   jti.iseg_loss, (key,))
        else:
            yield JSTM(pallas_attention=False), None, jstm.stm_loss, ()


def _jax_run(name, variables, batch):
    """(loss, gradient tree, statistics tree) of the JAX loss, jitted, on
    the whole batch, dropout as the identity."""
    with _jax_family(name) as (model, _, loss_fn, extra), flax_dropout_off():
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                     static_argnums=2)
        (loss, stats), grads = vg(
            variables["params"], variables["batch_stats"], model,
            {k: jnp.asarray(v) for k, v in batch.items()}, *extra)
    return float(loss), np_tree(grads), np_tree(stats)


def _variables(name):
    if name == "stm":
        with open(ROOT / cases.STM_WEIGHTS, "rb") as f:
            return flax.serialization.msgpack_restore(f.read())
    return variables_tree(cases.make_state(name))


@pytest.mark.parametrize("name", FAMILIES)
def test_step_over_ranks_matches_jax(name, ranks, batches):
    """Dropout off: rank 0 against JAX's value-and-grad on the whole
    batch."""
    r0 = ranks["ranks"][0][name]["off"]
    loss, grads, stats = _jax_run(name, _variables(name), batches[name])
    exact = None if name == "stm" else dict(_leaves(grads_tree(_holder(
        name, grads=ranks["references"][name]["off_grads"]))))
    check_loss_and_grads(r0["loss"], loss, _holder(name, grads=r0["grads"]),
                         grads, exact)
    check_stats(_holder(name, r0["stats"]), stats)


def _check_float64(got, want):
    """Float64 gradients (flat by flax path) of the ranks against one
    process's: each tensor to 1e-6 of its max (`torch_train_util.
    check_float64_grads`'s rule) plus 2e-9 of the model's largest |g| (a
    tensor that is zero but for rounding: the STM's key-projection bias,
    by the softmax's shift invariance)."""
    assert got.keys() == want.keys()
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        tol = 1e-6 * float(np.abs(w).max()) + 2e-9 * gmax
        assert err <= tol, ("/".join(path), err, tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_step_over_ranks_matches_one_process(name, ranks, batches):
    """Dropout on, in float64: every rank's loss and rank 0's gradients,
    statistics and updated parameters against one process stepping the
    whole batch from the same weights with the same generator."""
    got = [r[name]["on"] for r in ranks["ranks"]]
    one = ranks["references"][name]["on"]
    for r in got:
        assert abs(r["loss"] - one["loss"]) <= 1e-9 * abs(one["loss"])
    want_grads = grads_tree(_holder(name, grads=one["grads"]))
    _check_float64(dict(_leaves(grads_tree(_holder(
        name, grads=got[0]["grads"])))), dict(_leaves(want_grads)))
    check_stats(_holder(name, got[0]["stats"]),
                variables_tree(_holder(name, one["stats"]))["batch_stats"])
    check_step(_holder(name, got[0]["stepped"]),
               variables_tree(_holder(name, one["stepped"]))["params"],
               want_grads, cases.OPTIM[name][0])
    if name == "human":
        assert one["norm"] > 1.0   # the clip scales this step
        for r in got:
            assert abs(r["norm"] - one["norm"]) <= 1e-9 * one["norm"]
    else:
        assert all(r["norm"] is None for r in got) and one["norm"] is None
    if dropouts(cases.reduced(name)):   # the masks are drawn: they matter
        off = ranks["ranks"][0][name]["off"]["loss"]
        assert abs(off - one["loss"]) > 1e-4 * abs(one["loss"])


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_hold_half_of_each_split_leaf(name, ranks):
    """At (2, 2) each rank holds half of every leaf that `param_shardings`
    splits along the torch dimension of its flax output channels (a
    transposed conv's dim 1), and every other leaf whole; the parameter,
    its gradient and both moments alike; the split set is JAX's rule's."""
    model = cases.reduced(name)
    full = dict(model.named_parameters())
    specs = ranks["ranks"][0][name]["specs"]
    split = {"/".join(p) for p, s in _spec_leaves(specs) if s}
    assert split, name
    n_split = 0
    for r in ranks["ranks"]:
        assert r["coords"] in ({"data": d, "model": m} for d in (0, 1)
                               for m in (0, 1))
        for n, shapes in r[name]["held"].items():
            whole = tuple(full[n].shape)
            assert len(set(shapes)) == 1, (n, shapes)
            if shapes[0] != whole:
                mod = model.get_submodule(n.rsplit(".", 1)[0])
                dim = int(isinstance(mod, nn.ConvTranspose2d)
                          and len(whole) == 4)
                want = list(whole)
                want[dim] //= 2
                assert shapes[0] == tuple(want), (n, shapes[0], whole)
                n_split += 1
    assert n_split == 4 * len(split)
    assert len({r[name]["bytes"] for r in ranks["ranks"]}) == 1


def _spec_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", FAMILIES)
def test_save_variables_from_ranks(name, ranks):
    """The file `families.save_whole` wrote from the 4 ranks: the whole model
    after the step, bit for bit, through the port's reader and loader and
    through JAX's `load_variables`."""
    path = ranks["dir"] / f"{name}.msgpack"
    stepped = ranks["ranks"][0][name]["on"]["stepped"]
    state = families.family(name).load(str(path))
    for k, v in state.items():   # written in float32
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(v.numpy(), stepped[k].astype(np.float32)), k
    if name == "stm":
        template = _variables(name)
    else:
        with _jax_family(name) as (model, inputs, _, _):
            template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                      *inputs)
    _read_by_jax(path, template)


def _read_by_jax(path, template):
    """JAX's `load_variables` of `path` against `template` (strict on its
    paths): every leaf the file holds, and no other."""
    restored = dict(_leaves(np_tree(load_variables(str(path), template))))
    held = dict(_leaves(read_msgpack(path)))
    assert restored.keys() == held.keys()
    for p, arr in held.items():
        assert np.array_equal(restored[p], arr), "/".join(p)
    assert np.isfinite(np.concatenate([a.ravel() for a in held.values()
                                       ])).all()


def test_loss_normalizer_is_the_whole_batchs(ranks):
    """The unknown band covers 16x the pixels on data rank 0 as on data
    rank 1: the ranks' loss is one process's, far from the mean of the two
    blocks' own losses."""
    want, *halves = ranks["references"]["band"]
    for r in ranks["ranks"]:
        assert abs(r["band_loss"] - want) <= 1e-5 * want
    assert abs(np.mean(halves) - want) > 0.05 * want, (halves, want)


def test_five_steps_reach_jaxs_loss(ranks):
    """JAX's sharded step on `make_mesh(4)` and the 4 ranks, 5 steps of one
    batch from the same variables: the same losses, falling."""
    variables = variables_tree(cases.make_state("matting"))
    model = JMattingUNet(layers=cases.LAYERS)
    lr, steps = cases.OPTIM["matting"]
    opt = optax.adamw(optax.cosine_decay_schedule(lr, steps),
                      weight_decay=1e-5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtr.TrainState(params, jax.tree_util.tree_map(
        jnp.asarray, variables["batch_stats"]), opt.init(params),
        jnp.asarray(0))
    mesh = jax_make_mesh(4)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    step = jtr.make_train_step(model, opt, mesh)
    # placed as the step's own in/out shardings place them, so that the
    # first step's program serves the next four (a first call on unplaced
    # arrays traces and lowers the same program twice; the same losses)
    rep = jax_replicate(mesh)
    state = jax.device_put(state, jtr.TrainState(
        jax_param_shardings(state.params, mesh),
        jax.tree.map(lambda _: rep, state.batch_stats),
        jax.tree.map(lambda _: rep, state.opt_state), rep))
    batch = jax.device_put({k: jnp.asarray(v)
                            for k, v in _steps_batch().items()},
                           jax_batch_sharding(mesh))
    want = []
    with mesh:
        for _ in range(5):
            state, loss = step(state, batch)
            want.append(float(loss))
    got = ranks["ranks"][0]["losses"]
    assert all(r["losses"] == got for r in ranks["ranks"])
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"train_{name}_torch", ROOT / "tools" / f"train_{name}_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _jax_template(name):
    """The JAX model's variables tree, shapes only (`eval_shape`)."""
    key = jax.random.PRNGKey(0)
    z = jnp.zeros((1,) + HW + (3,))
    if name == "matting":
        return jax.eval_shape(JMattingUNet().init, key, z, z[..., :1], z)
    if name == "binseg":
        return jax.eval_shape(JDeepLab(num_classes=2).init, key, z)
    if name == "human":
        return jax.eval_shape(JSCHP(num_classes=20,
                                    layers=cases.LAYERS).init, key, z)
    if name == "iseg":
        return jax.eval_shape(jiseg.DistMapsModel().init, key, z,
                              jnp.full((1, 20, 3), -1.0))
    return _variables("stm")


def test_tools_train_over_four_ranks(ranks):
    """Each tool's flags (`_tool_argv`): the matting tool's own `--ranks
    4` spawn (its `main`: `families.run_tool` hands `run_ranks` its rank
    function on 4 `gloo` ranks, which the file's cases ride), and the
    other tools' loops on the ranks of that spawn: the mesh printed once
    each, by rank 0 only, a whole checkpoint each that JAX's
    `load_variables` reads."""
    spawn = ranks["spawn"]
    assert spawn["fn"] is families._tool_rank and spawn["n"] == 4
    assert spawn["backend"] == "gloo"
    assert spawn["timeout"] == families.TOOL_DEADLINE
    assert spawn["collective_timeout"] == families.TOOL_COLLECTIVE_TIMEOUT
    r0 = ranks["ranks"][0]
    mesh = "mesh: {'data': 2, 'model': 2} on cpu"
    assert r0["tool_printed"].count(mesh) == 1, r0["tool_printed"]
    assert r0["printed"].count(mesh) == len(FAMILIES) - 1, r0["printed"]
    assert all(mesh not in r["printed"] + r["tool_printed"]
               for r in ranks["ranks"][1:])
    for name in FAMILIES:
        _read_by_jax(ranks["tools"] / name, _jax_template(name))


@pytest.mark.parametrize("shape", [(8, 8, 16, 16), (16, 16, 64, 64),
                                   (5, 7, 13, 11), (30, 30, 119, 119),
                                   (9, 12, 4, 5)])
def test_resize_gradient_is_torchs(shape):
    """`resize_nchw`'s gradient (two matmuls by the interpolation
    matrices, not torch's atomic CUDA backward, so a step's gradients on
    the card repeat bit for bit): its forward is `F.interpolate`'s bit for
    bit, its gradient `F.interpolate`'s to float64 rounding, up and
    down."""
    from video_unscreen_tpu_torch.ops.geometry import resize_nchw
    h, w, oh, ow = shape
    gen = torch.Generator().manual_seed(h * w)
    x = torch.randn(2, 3, h, w, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    g = torch.randn(2, 3, oh, ow, dtype=torch.float64, generator=gen)
    want = torch.nn.functional.interpolate(x, size=(oh, ow), mode="bilinear",
                                           align_corners=False)
    got = resize_nchw(x, (oh, ow))
    assert torch.equal(got, want)
    (gw,) = torch.autograd.grad(want, x, g)
    (gg,) = torch.autograd.grad(got, x, g)
    assert float((gg - gw).abs().max()) <= 1e-12 * float(gw.abs().max())
