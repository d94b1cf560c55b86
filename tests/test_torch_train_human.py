"""The port's SCHP human-parser training against the JAX package's, on the
CPU.

One module-scoped JAX run: the jitted `jax.value_and_grad(human_loss)` of
a `SCHPHumanParser(layers=(1, 1, 1, 1))` from the port's seeded flax-like
init (checked against the JAX model's paths and shapes; the unused head
convolutions included), on one `raw_uint8` batch of the JAX
`make_human_batch` (64x64, batch 2: normalized on the device, labels at
16x16; PSP's 6 bins then exceed the 4x4 map, so its priors go down
through the antialiased resize), flax's `Dropout` patched to the identity
(the port's at rate 0), one `optax.chain(clip_by_global_norm(1.0),
adamw(cosine_decay_schedule(5e-4, 2000), weight_decay=1e-5))` step (the
batch's gradient norm is above 1, so the clip scales it), and the
value-and-grad in float64 (of the loss without its float32 cast of the
logits, on both sides). The port's
`human_loss`, gradients (float32 and float64), statistics and one step
from the same variables, and its clip and update on JAX's own gradients,
to `tests/torch_train_util.py`'s tolerances. A
parameter the loss does not reach (the edge head's `conv4`, `conv5`, the
decoder's last convolution) gets optax's zero gradient and still decays.

Also: `make_human_batch` against the JAX maker in both `raw_uint8` modes
(figures and the distractor ellipse drawn with the JAX package's cv2 on
both sides: float images to 2e-5, uint8 ones within one level where the
cubic background rounds across an integer, labels exactly; with the
port's own figures the generator stays in step and the labels agree on
>= 99%), `_resize_nearest` bit-equal to cv2's INTER_NEAREST, the global
clip against optax's on both sides of the threshold, `save_variables`
through the JAX `load_variables` and apply, and the tool."""
import copy
import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_train_util import (check_float64_grads,
                                    check_loss_and_grads,
                                    check_saved_variables, check_stats,
                                    check_step,
                                    check_update_on_jax_grads,
                                    dropout_off, optax_step,
                                    flax_dropout_off, jax_float64_grads,
                                    np_tree, port_float64_grads,
                                    seeded_variables)
from video_unscreen_tpu.models import SCHPHumanParser as JSCHP
from video_unscreen_tpu.parallel import data_synth as jds
from video_unscreen_tpu.parallel import train_human as jth
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models.human_parse import SCHPHumanParser
from video_unscreen_tpu_torch.parallel import data_synth as ds
from video_unscreen_tpu_torch.parallel import train as tr
from video_unscreen_tpu_torch.parallel import train_human as th
from video_unscreen_tpu_torch.utils.checkpoint import (load_schp,
                                                       save_variables,
                                                       variables_tree)

LR, STEPS = 5e-4, 2000   # the tool's defaults
LAYERS, HW = (1, 1, 1, 1), (64, 64)
UNUSED = ("edge/conv4", "edge/conv5", "decoder/Conv_4")


def _port_model():
    return SCHPHumanParser(20, layers=LAYERS)


def _optimizer():
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                                   weight_decay=1e-5))


def _jax_loss64(params, batch_stats, model, batch, dropout_rng):
    """`human_loss` without its float32 cast of the logits (in float64)."""
    img = batch["img"]
    mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float32)
    std = jnp.asarray([0.229, 0.224, 0.225], jnp.float32)
    img = (img[..., ::-1].astype(jnp.float64) / 255.0 - mean) / std
    logits, updates = model.apply(
        {"params": params, "batch_stats": batch_stats}, img, train=True,
        mutable=["batch_stats"], rngs={"dropout": dropout_rng})
    ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                         batch["label"])
    wgt = jnp.where(batch["label"] > 0, 3.0, 1.0)
    return (ce * wgt).sum() / wgt.sum(), updates["batch_stats"]


def _port_loss64(model, batch):
    """The port's float64 counterpart of `_jax_loss64`."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32).double()
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32).double()
    img = (batch["img"].flip(-1).double() / 255.0 - mean) / std
    logits = model(tr.nchw(img))
    label = batch["label"].long()
    ce = torch.nn.functional.cross_entropy(logits, label, reduction="none")
    wgt = torch.where(label > 0, 3.0, 1.0).double()
    return (ce * wgt).sum() / wgt.sum()


@pytest.fixture(scope="module")
def run():
    model = JSCHP(num_classes=20, layers=LAYERS)
    variables = seeded_variables(_port_model(), model,
                                 jnp.zeros((1,) + HW + (3,)))
    batch = jth.make_human_batch(np.random.RandomState(0), 2, HW,
                                 raw_uint8=True)
    key = jax.random.PRNGKey(23)
    with flax_dropout_off():
        vg = jax.jit(jax.value_and_grad(jth.human_loss, has_aux=True),
                     static_argnums=2)
        (loss, stats), grads = vg(
            variables["params"], variables["batch_stats"], model,
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    opt = _optimizer()
    new_params = optax_step(opt, grads, variables["params"])
    exact = jax_float64_grads(
        _jax_loss64, variables,
        JSCHP(num_classes=20, layers=LAYERS, dtype=jnp.float64), batch, key)

    def port_model():
        return dropout_off(th.make_human_train_state(
            "cpu", init_from=variables, model=_port_model()))

    port = port_model()
    p_loss = th.human_loss(port, tr.batch_to_device(batch, "cpu"))
    p_loss.backward()
    stepped = port_model()
    step_loss = th.make_human_train_step(stepped, *tr.make_optimizer(
        stepped, LR, STEPS))(batch)
    port64 = port_float64_grads(port_model(), _port_loss64,
                                tr.batch_to_device(batch, "cpu"))
    return dict(fresh=port_model, variables=variables, loss=float(loss),
                stats=np_tree(stats),
                grads=np_tree(grads), new_params=new_params,
                exact=exact, port64=port64, port=port,
                p_loss=p_loss.detach(), stepped=stepped,
                step_loss=step_loss, jmodel=model,
                norm=float(np.sqrt(sum(
                    float(np.square(g).sum())
                    for g in jax.tree_util.tree_leaves(grads)))))


def test_loss_and_gradients_match_jax(run):
    check_loss_and_grads(run["p_loss"], run["loss"], run["port"],
                         run["grads"], run["exact"])


def test_float64_gradients_match_jax(run):
    check_float64_grads(run["port64"], run["exact"])


def test_batch_stats_match_jax(run):
    check_stats(run["port"], run["stats"])


def test_clipped_adamw_step_matches_optax(run):
    assert run["norm"] > 1.0, run["norm"]     # the clip scales this step
    assert float(run["step_loss"]) == float(run["p_loss"])
    check_step(run["stepped"], run["new_params"], run["grads"], LR,
               run["exact"])


def test_update_on_jax_gradients_matches_optax(run):
    """The port's clip and AdamW update on JAX's own gradients: optax's
    step to float32 rounding, every entry."""
    check_update_on_jax_grads(run["fresh"](), load_schp,
                              run["variables"], run["grads"],
                              run["new_params"], LR, STEPS, th.CLIP_NORM)


def test_unused_heads_get_zero_gradients_and_decay(run):
    """The heads the fusion logits do not reach: no gradient from the loss,
    a zero one in the step, so AdamW decays them by lr * wd as optax
    does."""
    params = dict(run["port"].named_parameters())
    for name in ("edge.conv4.weight", "edge.conv5.bias",
                 "decoder.convs.4.weight"):
        assert params[name].grad is None, name
    stepped = variables_tree(run["stepped"])["params"]
    for path in UNUSED:
        mod, _, leaf = path.partition("/")
        before = run["variables"]["params"][mod][leaf]["kernel"]
        for after in (run["new_params"][mod][leaf]["kernel"],
                      stepped[mod][leaf]["kernel"]):
            np.testing.assert_allclose(after, before * (1 - LR * 1e-5),
                                       rtol=1e-6)


@pytest.mark.parametrize("below", [True, False])
def test_clip_by_global_norm_matches_optax(below):
    rng = np.random.RandomState(int(below))
    grads = [rng.randn(3, 4).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    scale = 0.1 if below else 3.0
    grads = [g * scale for g in grads]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = tr.clip_by_global_norm_(torch.nn.ParameterList(params), 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    assert (float(norm) < 1.0) == below
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0)


def _jax_figures(monkeypatch):
    """The port's maker draws its figures and the distractor ellipse with
    the JAX package's rasterizers (cv2; held on their own in
    tests/test_torch_data_synth.py)."""
    monkeypatch.setattr(th, "draw_person", jds.draw_person)

    def ellipse(img, center, axes, angle, start, end, val):
        cv2.ellipse(img, center, axes, angle, start, end, val, -1)

    monkeypatch.setattr(th, "_fill_ellipse", ellipse)


@pytest.mark.parametrize("seed,raw", [(0, True), (1, True), (2, False),
                                      (3, False)])
def test_make_human_batch_matches_jax(seed, raw, monkeypatch):
    _jax_figures(monkeypatch)
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):   # two successive batches of one generator
        want = jth.make_human_batch(rj, 4, (64, 64), raw_uint8=raw)
        got = th.make_human_batch(rp, 4, (64, 64), raw_uint8=raw)
        for key in ("img", "label"):
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        assert got["label"].shape[1:] == (16, 16)
        d = np.abs(got["img"].astype(np.float64) - want["img"])
        assert d.max() <= (1 if raw else 2e-5), d.max()
        np.testing.assert_array_equal(got["label"], want["label"])
    assert rj.rand() == rp.rand()


def test_make_human_batch_with_the_ports_figures():
    rj, rp = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(2):
        want = jth.make_human_batch(rj, 4, (64, 64), raw_uint8=True)
        got = th.make_human_batch(rp, 4, (64, 64), raw_uint8=True)
        agree = (got["label"] == want["label"]).mean(axis=(1, 2))
        assert agree.min() >= 0.99, agree
    assert rj.rand() == rp.rand()


@pytest.mark.parametrize("src,dst", [((224, 224), (56, 56)),
                                     ((73, 41), (224, 100)),
                                     ((97, 161), (24, 24)),
                                     ((30, 200), (30, 91))])
def test_resize_nearest_is_cv2s(src, dst):
    parts = np.random.RandomState(src[1]).randint(0, 20, src).astype(
        np.int32)
    np.testing.assert_array_equal(
        ds._resize_nearest(parts, *dst),
        cv2.resize(parts, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_normalize_on_the_device_matches_jax():
    img = np.random.RandomState(4).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    want = (img[..., ::-1].astype(np.float32) / 255.0
            - np.array([0.485, 0.456, 0.406], np.float32)) / np.array(
        [0.229, 0.224, 0.225], np.float32)
    np.testing.assert_array_equal(
        th.normalize_bgr_uint8(torch.from_numpy(img)).numpy(), want)


def test_save_variables_through_jax(run, tmp_path):
    """The stepped model, unused heads included, written by
    `save_variables`, restored by JAX's `load_variables` against the
    seeded variables and applied in eval mode: logits within 1e-5 of the
    port's; `load_schp` reads it back bit for bit."""
    path = tmp_path / "schp.msgpack"
    model = run["stepped"]
    save_variables(path, model)
    img = th.make_human_batch(np.random.RandomState(3), 1, HW)["img"]
    jmodel = run["jmodel"]
    check_saved_variables(
        path, run["variables"], model,
        jax.jit(lambda v, x: jmodel.apply(v, x).transpose(0, 3, 1, 2)),
        {"port": [img.transpose(0, 3, 1, 2)], "jax": [img]}, load_variables)
    back = load_schp(str(path))
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], t), key


def test_dropout_draws_from_the_step_seed():
    batch = th.make_human_batch(np.random.RandomState(2), 2, (64, 64),
                                raw_uint8=True)
    base = th.make_human_train_state("cpu", seed=4, model=SCHPHumanParser(
        20, layers=LAYERS))
    losses = []
    for seed in (0, 0, 1):
        model = copy.deepcopy(base)
        step = th.make_human_train_step(model, *tr.make_optimizer(
            model, LR, STEPS), seed=seed)
        losses.append(float(step(batch)))
    assert losses[0] == losses[1] != losses[2]


def test_tool_trains_and_refuses(tmp_path):
    """tools/train_human_torch.py on the host (--layers 1 1 1 1): two steps
    from a checkpoint write one that `load_schp` reads whole; it refuses
    an --out under weights/ and, by default, a missing card."""
    spec = importlib.util.spec_from_file_location(
        "train_human_torch", os.path.join(os.path.dirname(__file__), "..",
                                          "tools", "train_human_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    init = tmp_path / "init.msgpack"
    save_variables(init, _port_model())
    out = tmp_path / "out" / "schp.msgpack"
    tool.main(["--steps", "2", "--batch", "2", "--size", "64", "--device",
               "cpu", "--layers", "1", "1", "1", "1", "--init_from",
               str(init), "--out", str(out)])
    model = _port_model()
    model.load_state_dict(load_schp(str(out)))
    with pytest.raises(SystemExit):
        tool.main(["--out", "weights/schp_new.msgpack", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--steps", "1", "--out", str(out)])
