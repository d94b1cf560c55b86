"""The port's MattingUNet training against the JAX package's, on the CPU.

One module-scoped JAX run: the jitted `jax.value_and_grad(matting_loss)`
of a `MattingUNet(layers=(1, 1, 1, 1))` from the port's seeded flax-like
init (its `variables_tree`, checked against the paths and shapes of the
JAX model's `init`) on one batch of the JAX `make_batch` (64x64, batch
2), one optax `adamw(cosine_decay_schedule(1e-3, 2000),
weight_decay=1e-5)` step, and the value-and-grad in float64. The port
runs its `matting_loss` (float32 and float64) and one train step from
the same variables on the same batch, and its update on JAX's own
gradients; the tolerances are `tests/torch_train_util.py`'s (the
deepest stage's BatchNorm sees 8 values a channel at this size).

Also: `make_batch` against the JAX maker (the figures drawn with the JAX
package's rasterizers on both sides, so every other step is held: images
to 2e-5, the cv2 bicubic background's 2e-6 scaled by 1/std; the trimap,
alphas exactly), and with the port's own figures (the generator in step,
masks on >= 99% of the pixels: the recorded boundary-pixel divergence of
clipped shapes, `tests/test_torch_data_synth.py`); the saturated head's
zero gradient; `save_variables` through the JAX `load_variables` and
apply; the tool on the host and its refusals."""
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
                                    jax_float64_grads, np_tree,
                                    optax_step, port_float64_grads,
                                    seeded_variables)
from video_unscreen_tpu.models import MattingUNet as JMattingUNet
from video_unscreen_tpu.parallel import data_synth as jds
from video_unscreen_tpu.parallel import train as jtr
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models.matting_unet import MattingUNet
from video_unscreen_tpu_torch.parallel import data_synth as ds
from video_unscreen_tpu_torch.parallel import train as tr
from video_unscreen_tpu_torch.utils.checkpoint import (load_matting_unet,
                                                       save_variables)

LR, STEPS = 1e-3, 2000   # the tool's defaults
LAYERS, HW = (1, 1, 1, 1), (64, 64)

_value_and_grad = jax.jit(jax.value_and_grad(jtr.matting_loss, has_aux=True),
                          static_argnums=2)


def _port_model():
    return MattingUNet(layers=LAYERS)


@pytest.fixture(scope="module")
def run():
    model = JMattingUNet(layers=LAYERS)
    z = jnp.zeros((1,) + HW + (3,))
    variables = seeded_variables(_port_model(), model, z, z[..., :1], z)
    batch = jds.make_batch(np.random.RandomState(0), 2, HW)
    (loss, stats), grads = _value_and_grad(
        variables["params"], variables["batch_stats"], model,
        {k: jnp.asarray(v) for k, v in batch.items()})
    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                      weight_decay=1e-5)
    new_params = optax_step(opt, grads, variables["params"])
    exact = jax_float64_grads(
        jtr.matting_loss, variables,
        JMattingUNet(layers=LAYERS, dtype=jnp.float64), batch)

    port = tr.make_train_state("cpu", init_from=variables,
                               model=_port_model())
    p_loss = tr.matting_loss(port, tr.batch_to_device(batch, "cpu"))
    p_loss.backward()
    stepped = tr.make_train_state("cpu", init_from=variables,
                                  model=_port_model())
    step_loss = tr.make_train_step(stepped, *tr.make_optimizer(
        stepped, LR, STEPS))(batch)
    port64 = port_float64_grads(
        tr.make_train_state("cpu", init_from=variables, model=_port_model()),
        tr.matting_loss, tr.batch_to_device(batch, "cpu"))
    return dict(variables=variables, loss=float(loss), stats=np_tree(stats),
                exact=exact, port64=port64,
                grads=np_tree(grads), new_params=new_params,
                port=port, p_loss=p_loss.detach(), stepped=stepped,
                step_loss=step_loss, jmodel=model)


def test_loss_and_gradients_match_jax(run):
    check_loss_and_grads(run["p_loss"], run["loss"], run["port"],
                         run["grads"], run["exact"])


def test_float64_gradients_match_jax(run):
    check_float64_grads(run["port64"], run["exact"])


def test_batch_stats_match_jax(run):
    check_stats(run["port"], run["stats"])


def test_adamw_step_matches_optax(run):
    assert float(run["step_loss"]) == float(run["p_loss"])
    check_step(run["stepped"], run["new_params"], run["grads"], LR,
               run["exact"])


def test_update_on_jax_gradients_matches_optax(run):
    """The port's AdamW update on JAX's own gradients: optax's step to
    float32 rounding, every entry."""
    model = tr.make_train_state("cpu", init_from=run["variables"],
                                model=_port_model())
    check_update_on_jax_grads(model, load_matting_unet,
                              run["variables"], run["grads"],
                              run["new_params"], LR, STEPS)


def _jax_figures(monkeypatch):
    """The port's maker draws its figures with the JAX package's
    rasterizers (held on their own in tests/test_torch_data_synth.py)."""
    for name in ("draw_person", "_random_alpha"):
        monkeypatch.setattr(ds, name, getattr(jds, name))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_batch_matches_jax(seed, monkeypatch):
    _jax_figures(monkeypatch)
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):   # two successive batches of one generator
        want, got = jds.make_batch(rj, 4, HW), ds.make_batch(rp, 4, HW)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=2e-5)
        for key in ("alpha_pre", "trimap", "alpha_gt"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert rj.rand() == rp.rand()


def test_make_batch_with_the_ports_figures():
    rj, rp = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        want, got = jds.make_batch(rj, 4, HW), ds.make_batch(rp, 4, HW)
        agree = (got["trimap"] == want["trimap"]).all(-1).mean(axis=(1, 2))
        assert agree.min() >= 0.99, agree
    assert rj.rand() == rp.rand()


@pytest.mark.parametrize("blur_len", [3, 4, 7])
def test_motion_blur_is_cv2s(blur_len):
    """`_filter2d` of the line kernel (even lengths too), bit-equal to
    cv2.filter2D, on 3-channel and 2-D images."""
    rng = np.random.RandomState(blur_len)
    kern = ds._motion_blur_kernel(blur_len, rng.uniform(-0.35, 0.35))
    for shape in ((64, 64, 3), (50, 37)):
        img = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(ds._filter2d(img, kern),
                                      cv2.filter2D(img, -1, kern))


def test_saturated_head_has_zero_gradient():
    """Beyond XLA's tanh saturation the alpha is exactly 1 and its
    gradient exactly 0 (XLA's 1 - y^2 there), so the head gets none."""
    model = tr.make_train_state("cpu", seed=1, model=_port_model())
    with torch.no_grad():
        model.dec_conv2.bias.fill_(20.0)
    batch = ds.make_batch(np.random.RandomState(2), 2, HW)
    loss = tr.matting_loss(model, tr.batch_to_device(batch, "cpu"))
    loss.backward()
    assert torch.isfinite(loss)
    assert torch.count_nonzero(model.dec_conv2.bias.grad) == 0
    assert torch.count_nonzero(model.dec_conv2.weight.grad) == 0


def test_save_variables_through_jax(run, tmp_path):
    """The stepped model (statistics moved off the init) written by
    `save_variables`, restored by JAX's `load_variables` against the
    seeded variables as the template and applied: its alpha within 1e-5
    of the port's eval forward; `load_matting_unet` reads it back bit for
    bit."""
    path = tmp_path / "matting.msgpack"
    model = run["stepped"]
    save_variables(path, model)
    batch = ds.make_batch(np.random.RandomState(3), 1, HW)
    imgs = [batch["img"], batch["alpha_pre"], batch["trimap"]]
    jmodel = run["jmodel"]
    check_saved_variables(
        path, run["variables"], model,
        jax.jit(lambda v, *a: jmodel.apply(v, *a).transpose(0, 3, 1, 2)),
        {"port": [a.transpose(0, 3, 1, 2) for a in imgs], "jax": imgs},
        load_variables)
    back = load_matting_unet(str(path))
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], t), key


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "tools",
                           f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_tool_trains_and_refuses(tmp_path, run):
    """tools/train_matting_torch.py on the host: two steps from a
    checkpoint write one that `load_matting_unet` reads whole; it refuses
    an --out under weights/ and, by default, a missing card."""
    tool = _tool("train_matting_torch")
    init = tmp_path / "init.msgpack"
    save_variables(init, MattingUNet())
    out = tmp_path / "out" / "matting.msgpack"
    tool.main(["--steps", "2", "--batch", "2", "--size", "64", "--device",
               "cpu", "--init_from", str(init), "--out", str(out)])
    model = MattingUNet()
    model.load_state_dict(load_matting_unet(str(out)))
    with pytest.raises(SystemExit):
        tool.main(["--out", "weights/matting_new.msgpack", "--device",
                   "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--steps", "1", "--out", str(out)])
