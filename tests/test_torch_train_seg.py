"""The port's DeepLab segmenter training against the JAX package's, on the
CPU, and flax's dropout in the port.

One module-scoped JAX run: the jitted `jax.value_and_grad(seg_loss)` of a
`DeepLabV3Plus(backbone_layers=(1, 1, 1, 1))` from the port's seeded
flax-like init (checked against the JAX model's paths and shapes), on
one batch of the JAX `make_seg_batch` (64x64, batch 4) with a weight map,
flax's `Dropout` patched to the identity (the port's at rate 0), and one
optax `adamw(cosine_decay_schedule(5e-4, 800), weight_decay=1e-5)` step,
and the same value-and-grad in float64; the port's `seg_loss`, gradients
(float32 and float64), statistics and one step from the same variables,
and its update on JAX's own gradients, to `tests/torch_train_util.py`'s
tolerances.

Also: `make_seg_batch` against the JAX maker for several seeds and two
successive batches (figures drawn with the JAX rasterizers on both sides:
images to 2e-5, labels exactly; with the port's own figures the generator
stays in step and the labels agree on >= 99%), `_resize_linear` bit-equal
to cv2's INTER_LINEAR, the dropout's train-mode semantics, `save_variables`
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
from video_unscreen_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from video_unscreen_tpu.parallel import data_synth as jds
from video_unscreen_tpu.parallel import train_seg as jts
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models.deeplab import DeepLabV3Plus
from video_unscreen_tpu_torch.models.dropout import FlaxDropout, dropouts
from video_unscreen_tpu_torch.parallel import data_synth as ds
from video_unscreen_tpu_torch.parallel import train as tr
from video_unscreen_tpu_torch.parallel import train_seg as ts
from video_unscreen_tpu_torch.utils.checkpoint import (load_deeplab,
                                                       save_variables)

LR, STEPS = 5e-4, 800   # the tool's defaults
LAYERS, HW, NB = (1, 1, 1, 1), (64, 64), 4


def _port_model():
    return DeepLabV3Plus(2, backbone_layers=LAYERS)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run():
    model = JDeepLab(num_classes=2, backbone_layers=LAYERS)
    variables = seeded_variables(_port_model(), model,
                                 jnp.zeros((1,) + HW + (3,)))
    batch = jts.make_seg_batch(np.random.RandomState(0), NB, HW)
    batch["weight"] = np.random.RandomState(1).uniform(
        0.5, 2.0, batch["label"].shape).astype(np.float32)
    key = jax.random.PRNGKey(17)
    with flax_dropout_off():
        vg = jax.jit(jax.value_and_grad(jts.seg_loss, has_aux=True),
                     static_argnums=2)
        (loss, stats), grads = vg(variables["params"],
                                  variables["batch_stats"], model,
                                  _jbatch(batch), key)
    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                      weight_decay=1e-5)
    new_params = optax_step(opt, grads, variables["params"])
    exact = jax_float64_grads(
        jts.seg_loss, variables,
        JDeepLab(num_classes=2, backbone_layers=LAYERS, dtype=jnp.float64),
        batch, key)

    def port_model():
        return dropout_off(ts.make_seg_train_state(
            "cpu", init_from=variables, model=_port_model()))

    port = port_model()
    p_loss = ts.seg_loss(port, tr.batch_to_device(batch, "cpu"))
    p_loss.backward()
    stepped = port_model()
    step_loss = ts.make_seg_train_step(stepped, *tr.make_optimizer(
        stepped, LR, STEPS))(batch)
    port64 = port_float64_grads(port_model(), ts.seg_loss,
                                tr.batch_to_device(batch, "cpu"))
    return dict(fresh=port_model, variables=variables, loss=float(loss),
                stats=np_tree(stats),
                exact=exact, port64=port64, batch=batch,
                grads=np_tree(grads), new_params=new_params,
                port=port, p_loss=p_loss.detach(), stepped=stepped,
                step_loss=step_loss, jmodel=model)


def test_loss_and_gradients_match_jax(run):
    check_loss_and_grads(run["p_loss"], run["loss"], run["port"],
                         run["grads"], run["exact"])


def test_float64_gradients_match_jax(run):
    check_float64_grads(run["port64"], run["exact"])


def test_unweighted_loss_is_the_mean(run):
    """Without a weight map the loss is the plain mean: the weighted loss
    with every weight 1."""
    batch = dict(run["batch"])
    model = run["stepped"]
    with torch.no_grad():
        batch["weight"] = np.ones_like(batch["weight"])
        ones = ts.seg_loss(model, tr.batch_to_device(batch, "cpu"))
        del batch["weight"]
        plain = ts.seg_loss(model, tr.batch_to_device(batch, "cpu"))
    assert abs(float(plain) - float(ones)) <= 1e-6 * float(ones)


def test_batch_stats_match_jax(run):
    check_stats(run["port"], run["stats"])


def test_adamw_step_matches_optax(run):
    assert float(run["step_loss"]) == float(run["p_loss"])
    check_step(run["stepped"], run["new_params"], run["grads"], LR,
               run["exact"])


def test_update_on_jax_gradients_matches_optax(run):
    """The port's AdamW update on JAX's own gradients: optax's step to
    float32 rounding, every entry."""
    check_update_on_jax_grads(run["fresh"](), load_deeplab,
                              run["variables"], run["grads"],
                              run["new_params"], LR, STEPS)


def _jax_figures(monkeypatch):
    """The port's makers draw their figures with the JAX package's
    rasterizers (held on their own in tests/test_torch_data_synth.py)."""
    for name in ("draw_person", "_random_alpha"):
        monkeypatch.setattr(ds, name, getattr(jds, name))
        monkeypatch.setattr(ts, name, getattr(jds, name))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_seg_batch_matches_jax(seed, monkeypatch):
    _jax_figures(monkeypatch)
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):   # two successive batches of one generator
        want = jts.make_seg_batch(rj, 4, HW)
        got = ts.make_seg_batch(rp, 4, HW)
        for key in ("img", "label"):
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(got["label"], want["label"])
    assert rj.rand() == rp.rand()


def test_make_seg_batch_with_the_ports_figures():
    rj, rp = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        want = jts.make_seg_batch(rj, 4, HW)
        got = ts.make_seg_batch(rp, 4, HW)
        agree = (got["label"] == want["label"]).mean(axis=(1, 2))
        assert agree.min() >= 0.99, agree
    assert rj.rand() == rp.rand()


@pytest.mark.parametrize("src,dst", [((200, 170), (128, 128)),
                                     ((128, 128), (64, 64)),
                                     ((40, 30), (224, 224)),
                                     ((90, 70), (64, 64))])
def test_resize_linear_is_cv2s(src, dst):
    rng = np.random.RandomState(src[0])
    for shape in (src + (3,), src):
        img = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(
            ds._resize_linear(img, *dst), cv2.resize(img, dst[::-1]))


def test_dropout_train_mode():
    """flax's Dropout(0.1): in train mode about 90% kept (5 sigma of the
    binomial), the kept ones scaled by 1 / 0.9, the mask a function of the
    generator's seed; the identity in eval mode and at rate 0."""
    x = torch.rand(200_000) + 0.5
    drop = FlaxDropout(0.1).train()
    masks = []
    for seed in (3, 3, 4):
        drop.generator = torch.Generator().manual_seed(seed)
        y = drop(x)
        keep = y != 0
        masks.append(keep)
        n = x.numel()
        assert abs(float(keep.float().mean()) - 0.9) <= 5 * (
            0.09 / n) ** 0.5
        assert torch.equal(y[keep], x[keep] / 0.9)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert torch.equal(drop.eval()(x), x)
    drop.train().rate = 0.0
    assert torch.equal(drop(x), x)


def test_aspp_dropout_in_the_step():
    """The step's generator drives the ASPP's dropout: two models stepped
    from the same weights and step seed give the same loss, another seed
    another; in eval mode the forward does not depend on it."""
    batch = ts.make_seg_batch(np.random.RandomState(2), 2, HW)
    base = ts.make_seg_train_state("cpu", seed=9, model=_port_model())
    assert len(dropouts(base)) == 1
    losses = []
    for seed in (0, 0, 1):
        model = copy.deepcopy(base)
        step = ts.make_seg_train_step(model, *tr.make_optimizer(
            model, LR, STEPS), seed=seed)
        losses.append(float(step(batch)))
    assert losses[0] == losses[1] != losses[2]
    model.eval()
    x = torch.from_numpy(batch["img"]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        a = model(x)
        dropouts(model)[0].generator = torch.Generator().manual_seed(5)
        assert torch.equal(model(x), a)


def test_save_variables_through_jax(run, tmp_path):
    """The stepped model (cls_out's bias included) written by
    `save_variables`, restored by JAX's `load_variables` against the
    seeded variables as the template and applied in eval mode: logits
    within 1e-5 of the port's; `load_deeplab` reads it back bit for
    bit."""
    path = tmp_path / "deeplab.msgpack"
    model = run["stepped"]
    save_variables(path, model)
    img = ts.make_seg_batch(np.random.RandomState(3), 1, HW)["img"]
    jmodel = run["jmodel"]
    check_saved_variables(
        path, run["variables"], model,
        jax.jit(lambda v, x: jmodel.apply(v, x).transpose(0, 3, 1, 2)),
        {"port": [img.transpose(0, 3, 1, 2)], "jax": [img]}, load_variables)
    back = load_deeplab(str(path))
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], t), key


def test_tool_trains_and_refuses(tmp_path):
    """tools/train_binseg_torch.py on the host: two steps from a checkpoint
    with a checkpoint every step write one `load_deeplab` reads whole; it
    refuses an --out under weights/ and, by default, a missing card."""
    spec = importlib.util.spec_from_file_location(
        "train_binseg_torch", os.path.join(os.path.dirname(__file__), "..",
                                           "tools", "train_binseg_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    init = tmp_path / "init.msgpack"
    save_variables(init, ts.build_deeplab(2))
    out = tmp_path / "out" / "deeplab.msgpack"
    tool.main(["--steps", "2", "--batch", "2", "--size", "64", "--device",
               "cpu", "--init_from", str(init), "--save_every", "1",
               "--out", str(out)])
    model = ts.build_deeplab(2)
    model.load_state_dict(load_deeplab(str(out)))
    with pytest.raises(SystemExit):
        tool.main(["--out", "weights/deeplab_new.msgpack", "--device",
                   "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--steps", "1", "--out", str(out)])
