"""The port's DistMaps (interactive segmentation) training against the JAX
package's, on the CPU.

The ISeg's `BRSDeepLabV3Plus` fixes a ResNet-50 trunk; this file swaps the
`ResNet` name of both packages' `models/iseg.py` for one with stages (1,
1, 1, 1) (`monkeypatch`, the whole module; nothing in either package
changes). One module-scoped JAX run: the jitted
`jax.value_and_grad(iseg_loss)` from the port's seeded flax-like init
(checked against the JAX model's paths and shapes) on one batch of the
JAX `make_click_batch` (64x64, batch 4, up to 20 clicks), flax's `Dropout`
patched to the identity (the port's at rate 0), one optax
`adamw(cosine_decay_schedule(5e-4, 1000), weight_decay=1e-5)` step, and
the value-and-grad in float64; the port's `iseg_loss`, gradients (float32
and float64), statistics and one step from the same variables, and its
update on JAX's own gradients, to `tests/torch_train_util.py`'s
tolerances.

Also: `make_click_batch` against the JAX maker (images to 2e-5, point
lists and labels exactly, for several seeds and two successive batches),
the ASPP's dropout drawing from the step's seed, `save_variables` (the
depthwise kernels included) through the JAX `load_variables` and apply,
and the tool."""
import copy
import importlib.util
import os

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
                                    dropout_off,
                                    flax_dropout_off, jax_float64_grads,
                                    np_tree, optax_step, port_float64_grads,
                                    seeded_variables)
from video_unscreen_tpu.models import iseg as jiseg
from video_unscreen_tpu.models.resnet import ResNet as JResNet
from video_unscreen_tpu.parallel import train_iseg as jti
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models import iseg as piseg
from video_unscreen_tpu_torch.models.resnet import ResNet as PResNet
from video_unscreen_tpu_torch.parallel import train as tr
from video_unscreen_tpu_torch.parallel import train_iseg as ti
from video_unscreen_tpu_torch.utils.checkpoint import (load_iseg,
                                                       save_variables)

LR, STEPS = 5e-4, 1000   # the tool's defaults
LAYERS, HW, NB = (1, 1, 1, 1), (64, 64), 4


@pytest.fixture(scope="module", autouse=True)
def shallow_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jiseg, "ResNet",
                   lambda **kw: JResNet(**dict(kw, layers=LAYERS)))
        mp.setattr(piseg, "ResNet",
                   lambda block, layers, **kw: PResNet(block, LAYERS, **kw))
        yield


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run(shallow_trunk):
    model = jiseg.DistMapsModel()
    variables = seeded_variables(piseg.DistMapsModel(), model,
                                 jnp.zeros((1,) + HW + (3,)),
                                 jnp.full((1, 20, 3), -1.0))
    batch = jti.make_click_batch(np.random.RandomState(0), NB, HW)
    key = jax.random.PRNGKey(23)
    with flax_dropout_off():
        vg = jax.jit(jax.value_and_grad(jti.iseg_loss, has_aux=True),
                     static_argnums=2)
        (loss, stats), grads = vg(variables["params"],
                                  variables["batch_stats"], model,
                                  _jbatch(batch), key)
    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                      weight_decay=1e-5)
    new_params = optax_step(opt, grads, variables["params"])
    exact = jax_float64_grads(jti.iseg_loss, variables,
                              jiseg.DistMapsModel(dtype=jnp.float64), batch,
                              key)

    def port_model():
        return dropout_off(ti.make_iseg_train_state(
            "cpu", init_from=variables, model=piseg.DistMapsModel()))

    port = port_model()
    p_loss = ti.iseg_loss(port, tr.batch_to_device(batch, "cpu"))
    p_loss.backward()
    stepped = port_model()
    step_loss = ti.make_iseg_train_step(stepped, *tr.make_optimizer(
        stepped, LR, STEPS))(batch)
    port64 = port_float64_grads(port_model(), ti.iseg_loss,
                                tr.batch_to_device(batch, "cpu"))
    return dict(fresh=port_model, variables=variables, loss=float(loss),
                stats=np_tree(stats),
                grads=np_tree(grads), new_params=new_params, exact=exact,
                port64=port64, port=port, p_loss=p_loss.detach(),
                stepped=stepped, step_loss=step_loss, jmodel=model)


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
    check_update_on_jax_grads(run["fresh"](), load_iseg,
                              run["variables"], run["grads"],
                              run["new_params"], LR, STEPS)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_click_batch_matches_jax(seed):
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):   # two successive batches of one generator
        want = jti.make_click_batch(rj, 4, HW)
        got = ti.make_click_batch(rp, 4, HW)
        for key in ("img", "points", "label"):
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(got["points"], want["points"])
        np.testing.assert_array_equal(got["label"], want["label"])
    assert rj.rand() == rp.rand()


def test_dropout_draws_from_the_step_seed():
    batch = ti.make_click_batch(np.random.RandomState(2), 2, HW)
    base = ti.make_iseg_train_state("cpu", seed=4,
                                    model=piseg.DistMapsModel())
    losses = []
    for seed in (0, 0, 1):
        model = copy.deepcopy(base)
        step = ti.make_iseg_train_step(model, *tr.make_optimizer(
            model, LR, STEPS), seed=seed)
        losses.append(float(step(batch)))
    assert losses[0] == losses[1] != losses[2]


def test_save_variables_through_jax(run, tmp_path):
    """The stepped model (depthwise kernels (3, 3, 1, C) included) written
    by `save_variables`, restored by JAX's `load_variables` against the
    seeded variables and applied in eval mode: logits within 1e-5 of the
    port's; `load_iseg` reads it back bit for bit."""
    path = tmp_path / "iseg.msgpack"
    model = run["stepped"]
    save_variables(path, model)
    batch = ti.make_click_batch(np.random.RandomState(3), 1, HW)
    img, pts = batch["img"], batch["points"]
    jmodel = run["jmodel"]
    check_saved_variables(
        path, run["variables"], model,
        jax.jit(lambda v, x, p: jmodel.apply(v, x, p).transpose(0, 3, 1, 2)),
        {"port": [img.transpose(0, 3, 1, 2), pts], "jax": [img, pts]},
        load_variables)
    back = load_iseg(str(path))
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], t), key


def test_tool_trains_and_refuses(tmp_path):
    """tools/train_iseg_torch.py on the host (the shallow trunk of this
    file): two steps write a checkpoint `load_iseg` reads whole; it
    refuses an --out under weights/ and, by default, a missing card."""
    spec = importlib.util.spec_from_file_location(
        "train_iseg_torch", os.path.join(os.path.dirname(__file__), "..",
                                         "tools", "train_iseg_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "out" / "iseg.msgpack"
    tool.main(["--steps", "2", "--batch", "2", "--size", "64", "--device",
               "cpu", "--out", str(out)])
    model = piseg.DistMapsModel()
    model.load_state_dict(load_iseg(str(out)))
    with pytest.raises(SystemExit):
        tool.main(["--out", "weights/iseg_new.msgpack", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--steps", "1", "--out", str(out)])
