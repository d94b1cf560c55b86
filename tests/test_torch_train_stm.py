"""The port's STM training against the JAX package's, on the CPU.

One module-scoped JAX run: the jitted `jax.value_and_grad(stm_loss)` with
`STM(pallas_attention=False)` (the JAX tool's model) from the shipped
`weights/stm.msgpack` on one batch of the JAX `make_clip_batch` (64x64,
batch 2, T 3). The port runs its `stm_loss` and one train step from the
same weights on the same batch. Tolerances:
- the loss to 1e-5 relative;
- each gradient tensor to 1e-3 of its own max |g| plus 2e-6 of the
  largest |g| of the model. The second term is the floor of f32 sums
  taken in another order: the memory encoder's smallest gradients (max
  |g| ~1e-5 against a model max of 0.93) differ from XLA's by up to 1.6%
  of their own max, 1.5e-7 absolute, with a dense softmax read in place
  of the flash formula as well, while the port's own run moves by 1e-9
  between thread counts. The key heads' reference gradient is exactly 0
  (the read's softmax saturates to one-hot in f32); the port's
  flash-style formula leaves a rounding-size gradient there (~1e-9);
  In float64 (JAX eager under `enable_x64`, the port's model in double)
  the loss agrees to 1e-10 and every gradient tensor to 1e-6 of its own
  max (the port's 1/sqrt(dk) is rounded to f32, as K4's is), which shows
  the f32 differences are rounding;
- the BatchNorm statistics to 1e-4 relative;
- after one AdamW step, each parameter to 1e-6 + 1e-4 |p|, except where
  |g| of the reference is within the gradient tolerance above: Adam's
  first step is about lr sign(g) there, and a sign the sums do not fix
  may flip, so the bound is 2 lr.
Also: the flax-semantics BatchNorm against flax's, the initialization
against flax's initializers, `save_stm` through the JAX `load_variables`,
and the tool's refusals."""
import importlib.util
import os

import flax.linen as fnn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import nn_, tt
from video_unscreen_tpu.models.stm import STM as JSTM
from video_unscreen_tpu.parallel import train_stm as jts
from video_unscreen_tpu.utils.checkpoint import load_variables
from video_unscreen_tpu_torch.models.batchnorm import FlaxBatchNorm2d
from video_unscreen_tpu_torch.parallel import train_stm as ts
from video_unscreen_tpu_torch.parallel.train import make_optimizer
from video_unscreen_tpu_torch.utils.checkpoint import (_leaves, _module_path,
                                                       load_stm, save_stm)

WEIGHTS = "weights/stm.msgpack"
LR, STEPS = 5e-4, 800  # the tool's defaults


# the JAX train step's value-and-grad, jitted as `make_stm_train_step`
# jits it
_value_and_grad = jax.jit(jax.value_and_grad(jts.stm_loss, has_aux=True),
                          static_argnums=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_name(path):
    """flax (params path) -> the port's parameter name."""
    leaf = path[-1]
    return (f"{_module_path(path[:-1])}."
            f"{'bias' if leaf == 'bias' else 'weight'}")


def _grad_tol(g, gmax):
    """The gradient tolerance of a tensor (see the module docstring)."""
    return 1e-3 * float(np.abs(g).max()) + 2e-6 * gmax


def _as_flax(name, t):
    a = nn_(t)
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def run():
    with open(WEIGHTS, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    batch = jts.make_clip_batch(np.random.RandomState(0), 2, (64, 64), 3)
    model = JSTM(pallas_attention=False)
    (loss, stats), grads = _value_and_grad(
        variables["params"], variables["batch_stats"], model,
        {k: jnp.asarray(v) for k, v in batch.items()})
    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS),
                      weight_decay=1e-5)
    updates, _ = opt.update(grads, opt.init(variables["params"]),
                            variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)

    port = ts.make_stm_train_state("cpu", init_from=variables)
    p_loss = ts.stm_loss(port, ts.batch_to_device(batch, "cpu"))
    p_loss.backward()
    stepped = ts.make_stm_train_state("cpu", init_from=variables)
    optimizer, scheduler = make_optimizer(stepped, LR, STEPS)
    step_loss = ts.make_stm_train_step(stepped, optimizer, scheduler)(batch)
    return dict(loss=float(loss), stats=_np(stats), grads=_np(grads),
                new_params=_np(new_params), port=port, p_loss=p_loss,
                stepped=stepped, step_loss=step_loss)


def test_loss_and_gradients_match_jax(run):
    assert abs(float(run["p_loss"].detach()) - run["loss"]) \
        <= 1e-5 * run["loss"]
    params = dict(run["port"].named_parameters())
    grads = list(_leaves(run["grads"]))
    assert len(grads) == len(params)
    gmax = max(float(np.abs(g).max()) for _, g in grads)
    for path, g in grads:
        name = _port_name(path)
        got = _as_flax(name, params[name].grad)
        tol = _grad_tol(g, gmax)
        err = float(np.abs(got - g).max())
        assert err <= tol, f"{name}: max |diff| {err} > {tol}"


def test_float64_loss_and_gradients_match_jax():
    with open(WEIGHTS, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    batch = jts.make_clip_batch(np.random.RandomState(0), 2, (64, 64), 3)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables)
        # eager: XLA's jit of this graph in f64 on the CPU is further from
        # the port (2.1e-4 of a tensor's max) than its own eager run
        (loss, _), grads = jax.value_and_grad(jts.stm_loss, has_aux=True)(
            v64["params"], v64["batch_stats"],
            JSTM(pallas_attention=False, dtype=jnp.float64),
            {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        loss, grads = float(loss), _np(grads)
    model = ts.make_stm_train_state("cpu", init_from=variables).double()
    tb = {k: v.double() for k, v in ts.batch_to_device(batch, "cpu").items()}
    p_loss = ts.stm_loss(model, tb)
    p_loss.backward()
    assert abs(float(p_loss.detach()) - loss) <= 1e-10 * loss
    params = dict(model.named_parameters())
    gmax = max(float(np.abs(g).max()) for _, g in _leaves(grads))
    for path, g in _leaves(grads):
        name = _port_name(path)
        got = _as_flax(name, params[name].grad)
        scale = float(np.abs(g).max())
        tol = 1e-6 * scale if scale > 0 else 1e-12 * gmax
        assert float(np.abs(got - g).max()) <= tol, name


def test_batch_stats_match_jax(run):
    buffers = dict(run["port"].named_buffers())
    stats = list(_leaves(run["stats"]))
    assert len(stats) == sum(k.endswith("running_mean") for k in buffers) * 2
    for path, want in stats:
        name = (f"{_module_path(path[:-1])}."
                f"{'running_mean' if path[-1] == 'mean' else 'running_var'}")
        got = nn_(buffers[name])
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)


def test_adamw_step_matches_optax(run):
    assert float(run["step_loss"]) == float(run["p_loss"].detach())
    params = dict(run["stepped"].named_parameters())
    grads = dict(_leaves(run["grads"]))
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    for path, want in _leaves(run["new_params"]):
        name = _port_name(path)
        got = _as_flax(name, params[name])
        g = grads[path]
        noise = np.abs(g) <= _grad_tol(g, gmax)
        d = np.abs(got - want)
        assert (d[~noise] <= 1e-6 + 1e-4 * np.abs(want[~noise])).all(), (
            name, float(d[~noise].max(initial=0)))
        assert (d[noise] <= 2 * LR).all(), (name, float(d.max()))
    # the statistics the step updated are those of the loss alone
    for (n, a), (_, b) in zip(run["stepped"].named_buffers(),
                              run["port"].named_buffers()):
        assert torch.equal(a, b), n


def test_pair_batch_loss_is_the_two_frame_clip_loss():
    """The 2-frame pair dict of `make_pair_batch` and the T 2 clip it is
    cut from give the same loss."""
    pair = ts.make_pair_batch(np.random.RandomState(9), 1, (64, 64))
    clip = ts.make_clip_batch(np.random.RandomState(9), 1, (64, 64), 2)
    losses = []
    for batch in (pair, clip):
        model = ts.make_stm_train_state("cpu", init_from=WEIGHTS)
        with torch.no_grad():
            losses.append(float(ts.stm_loss(
                model, ts.batch_to_device(batch, "cpu"))))
    assert losses[0] == losses[1]


@pytest.mark.parametrize("shape,shift", [((2, 5, 6, 8), 0.0),
                                         ((3, 4, 4, 16), 3.0)])
def test_batchnorm_matches_flax(shape, shift):
    """One train-mode call of FlaxBatchNorm2d against flax's nn.BatchNorm
    with `mutable=["batch_stats"]` (output, mean and var to 1e-5
    relative), from perturbed statistics and affine; eval mode is
    nn.BatchNorm2d's own forward, unchanged."""
    rng = np.random.RandomState(8)
    x = (rng.randn(*shape) * 2 + shift).astype(np.float32)   # NHWC
    c = shape[-1]
    init = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.randn(c),
            "mean": rng.randn(c), "var": rng.uniform(0.5, 2.0, c)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    variables = {"params": {"scale": init["scale"], "bias": init["bias"]},
                 "batch_stats": {"mean": init["mean"], "var": init["var"]}}
    want, upd = fnn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = FlaxBatchNorm2d(c)
    bn.load_state_dict({"weight": tt(init["scale"]), "bias": tt(init["bias"]),
                        "running_mean": tt(init["mean"]),
                        "running_var": tt(init["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    got = bn(tt(x.transpose(0, 3, 1, 2)))
    for g, w in ((nn_(got).transpose(0, 2, 3, 1), want),
                 (bn.running_mean, upd["batch_stats"]["mean"]),
                 (bn.running_var, upd["batch_stats"]["var"])):
        w = np.asarray(w)
        assert np.abs(nn_(g) - w).max() <= 1e-5 * np.abs(w).max()
    bn.eval()
    ref = torch.nn.BatchNorm2d(c, eps=1e-5)
    ref.load_state_dict(bn.state_dict())
    ref.eval()
    xt = tt(x.transpose(0, 3, 1, 2))
    assert torch.equal(bn(xt), ref(xt))


def test_initialization_matches_flax():
    """Each conv's standard deviation within 10% of flax's lecun-normal
    draw of the same shape, biases 0, BatchNorm scale 1, bias 0, mean 0,
    var 1 (the shapes are the shipped checkpoint's)."""
    model = ts.make_stm_train_state("cpu", seed=3)
    with open(WEIGHTS, "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    params = dict(model.named_parameters())
    init = jax.nn.initializers.lecun_normal()
    key = jax.random.PRNGKey(0)
    n_conv = 0
    for i, (path, arr) in enumerate(_leaves(tree["params"])):
        name = _port_name(path)
        got = nn_(params[name])
        if path[-1] == "kernel":
            want = np.asarray(init(jax.random.fold_in(key, i), arr.shape))
            assert abs(got.std() / want.std() - 1) < 0.1, name
            n_conv += 1
        elif path[-1] == "scale":
            assert (got == 1).all(), name
        else:
            assert (got == 0).all(), name
    assert n_conv > 100
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            assert not buf.any(), name
        elif name.endswith("running_var"):
            assert (buf == 1).all(), name


def test_save_stm_round_trip(tmp_path):
    """save_stm -> the JAX load_variables (against the shipped file's tree
    as the template) -> load_stm: bit for bit, as is the port's own
    reader."""
    model = ts.make_stm_train_state("cpu", seed=4)
    with torch.no_grad():  # statistics that differ from the init's
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    path = str(tmp_path / "stm.msgpack")
    save_stm(path, model)
    with open(WEIGHTS, "rb") as f:
        template = flax.serialization.msgpack_restore(f.read())
    restored = _np(load_variables(path, template))
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    for state in (load_stm(restored), load_stm(path)):
        state = {k: v for k, v in state.items()
                 if not k.endswith("num_batches_tracked")}
        assert state.keys() == want.keys()
        for k in want:
            assert torch.equal(state[k], want[k]), k


def test_tool_trains_and_refuses(tmp_path):
    """tools/train_stm_torch.py on the host: one step from the shipped
    weights writes a checkpoint both readers load; it refuses an --out
    under weights/ and, by default, a missing card."""
    spec = importlib.util.spec_from_file_location(
        "train_stm_torch", os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "train_stm_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "out" / "stm.msgpack"
    tool.main(["--steps", "1", "--batch", "1", "--size", "64", "--device",
               "cpu", "--init_from", WEIGHTS, "--out", str(out)])
    state = load_stm(str(out))
    assert len(state) == len(ts.STM().state_dict())
    with open(WEIGHTS, "rb") as f:
        template = flax.serialization.msgpack_restore(f.read())
    load_variables(str(out), template)
    with pytest.raises(SystemExit):
        tool.main(["--out", "weights/stm_new.msgpack", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--steps", "1", "--out", str(out)])
