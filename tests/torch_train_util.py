"""Shared checks of the trainer tests (`tests/test_torch_train_*.py`): one
JAX value-and-grad and one optax step against the port's loss, gradients,
BatchNorm statistics and one AdamW step, from the same weights on the same
batch, with dropout off on both sides.

Tolerances (those of `tests/test_torch_train_stm.py`):
- the loss to 1e-5 relative;
- each gradient tensor to 1e-3 of its own max |g| plus 2e-6 of the
  largest |g| of the model (f32 sums taken in another order);
- the BatchNorm statistics to 1e-4 of each tensor's max;
- after one step, each parameter to 1e-6 + 1e-4 |p|, except where |g| of
  the reference is within the gradient tolerance: Adam's first step is
  about lr sign(g) there, and a sign the sums do not fix may flip, so the
  bound is 2 lr (`check_step` returns how many entries that is);
- the port's update alone (`check_update_on_jax_grads`: its clip and
  AdamW on JAX's own float32 gradients) to optax's step from them, every
  entry to 1e-8 + 1e-6 |p|;
- where a float64 run of the JAX loss is given (`exact`), as for every
  family but the STM: the float64 gradients of both packages to 1e-6 of
  each tensor's max (the STM's float64 rule: the same function), and the
  port's float32 gradients held to JAX's float64 ones, each tensor to
  5e-3 of its max plus 2e-6 of the model's largest |g|, plus 2 e, e
  being JAX's own float32 error on that tensor (its largest |g32 - g64|
  there); in the step's noise rule |g| within that bound plus e (a sign
  either float32 run may get wrong). Two things move float32 gradients
  here. torch's CPU convolution backward sums in another order than
  XLA's, and on these small nets' cancelling sums (a MattingUNet
  gradient 1/400 of its terms) the port's float32 gradients land up to
  2.5e-3 of a tensor's max from the float64 value, where XLA's land
  within 1e-5. And BatchNorms that normalize a few values a channel (the
  late stages at 64x64, and an image-pooling branch's over the batch:
  DeepLab's ASPP, SCHP's PSP, the ISeg's ASPP, mean^2 / var up to ~80)
  make both packages' float32 gradients of the tensors below them noisy:
  JAX's up to 9.5e-2 of a tensor's max (93 times the STM's tolerance, in
  DeepLab's last Bottleneck), the port's up to 1.5e-2.

This module imports JAX: only the CPU suite uses it."""
import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_util import nn_
from video_unscreen_tpu_torch.models.dropout import dropouts
from video_unscreen_tpu_torch.parallel.train import (apply_gradients,
                                                     init_flax_like,
                                                     make_optimizer)
from video_unscreen_tpu_torch.utils.checkpoint import _leaves, variables_tree


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_variables(port_model, jax_model, *init_args):
    """flax variables from the port's seeded flax-like init of
    `port_model` (`variables_tree`), after checking that they have the
    paths and shapes of `jax_model.init(key, *init_args)` (traced, not
    run)."""
    init_flax_like(port_model, torch.Generator().manual_seed(0))
    tree = variables_tree(port_model)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            *init_args)
    want = {p: tuple(a.shape) for p, a in _shape_leaves(shapes)}
    got = {p: a.shape for p, a in _leaves(tree)}
    assert got == want, sorted(set(got.items()) ^ set(want.items()))[:6]
    return tree


def _shape_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _shape_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def optax_step(opt, grads, params):
    """The params after one step of the optax transformation `opt` from
    its initial state (jitted: one compile, where eager optax compiles
    each of its ops for each leaf's shape)."""
    def step(g, p):
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates)

    return np_tree(jax.jit(step)(grads, params))


def grad_tol(g, gmax):
    return 1e-3 * float(np.abs(g).max()) + 2e-6 * gmax


@contextlib.contextmanager
def flax_dropout_off():
    """flax's `nn.Dropout` as the identity (for a JAX trace made inside)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        yield


def dropout_off(model):
    """The port model's dropouts at rate 0; returns the model."""
    for m in dropouts(model):
        m.rate = 0.0
    return model


def jax_float64_grads(loss_fn, variables, model64, batch, *extra):
    """JAX's float64 gradients of `loss_fn(params, batch_stats, model64,
    batch, *extra)` (`model64` built with dtype float64), flat by path."""
    with jax.enable_x64(True), flax_dropout_off():
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables)
        b64 = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                              else v.dtype) for k, v in batch.items()}
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                     static_argnums=2)
        _, grads = vg(v64["params"], v64["batch_stats"], model64, b64,
                      *extra)
        return dict(_leaves(np_tree(grads)))


def port_float64_grads(model, loss_fn, batch):
    """`model` in float64 (in place) and its gradients of `loss_fn` on
    `batch` (`train.batch_to_device`'s), float tensors made float64."""
    model.double()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    loss_fn(model, batch).backward()
    return model


def grads_tree(model):
    """The port model's gradients as a flax params tree (0 where the loss
    did not reach a parameter, as JAX's)."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(grads[n] if grads[n] is not None else 0.0)
    return variables_tree(twin)["params"]


def _pairs(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), (
        what, sorted(set(got) ^ set(want))[:6])
    return [(path, got[path], want[path]) for path in sorted(want)]


def _f32_errors(want_grads, exact):
    """JAX's own float32 error on each tensor, its largest |g32 - g64|
    there, by path; None without `exact`."""
    if exact is None:
        return None
    return {p: float(np.abs(g - exact[p]).max())
            for p, g in _leaves(want_grads)}


def _float32_tol(ref, gmax, f32_err):
    """The float32 gradient tolerance of one tensor (module docstring);
    `f32_err` is JAX's float32 error on it, None without a float64 run."""
    if f32_err is None:
        return grad_tol(ref, gmax)
    return 5e-3 * float(np.abs(ref).max()) + 2e-6 * gmax + 2 * f32_err


def check_loss_and_grads(p_loss, want_loss, model, want_grads, exact=None):
    """`exact`: JAX's float64 gradients, flat by path (`_leaves`)."""
    assert abs(float(p_loss) - want_loss) <= 1e-5 * abs(want_loss), (
        float(p_loss), want_loss)
    pairs = _pairs(grads_tree(model), want_grads, "gradients")
    gmax = max(float(np.abs(w).max()) for _, _, w in pairs)
    errs = _f32_errors(want_grads, exact)
    for path, got, want in pairs:
        ref = want if exact is None else exact[path]
        err = float(np.abs(got - ref).max())
        tol = _float32_tol(ref, gmax, None if errs is None else errs[path])
        assert err <= tol, f"{'/'.join(path)}: max |diff| {err} > {tol}"


def check_float64_grads(model, exact):
    """The port model's float64 gradients against JAX's (`exact`, flat):
    each tensor to 1e-6 of its max."""
    got = dict(_leaves(grads_tree(model)))
    assert got.keys() == exact.keys()
    gmax = max(float(np.abs(g).max()) for g in exact.values())
    for path, want in exact.items():
        scale = float(np.abs(want).max())
        tol = 1e-6 * scale if scale > 0 else 1e-12 * gmax
        err = float(np.abs(got[path] - want).max())
        assert err <= tol, ("/".join(path), err, scale)


def check_stats(model, want_stats):
    for path, got, want in _pairs(variables_tree(model)["batch_stats"],
                                  want_stats, "batch_stats"):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), ("/".join(path), err)


def check_step(stepped, want_params, want_grads, lr, exact=None):
    """Returns the number of entries held to 2 lr (the noise rule)."""
    grads = dict(_leaves(want_grads))
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    errs = _f32_errors(want_grads, exact)
    n_noise = 0
    for path, got, want in _pairs(variables_tree(stepped)["params"],
                                  want_params, "params"):
        g = grads[path]
        e = None if errs is None else errs[path]
        noise = np.abs(g) <= _float32_tol(g, gmax, e) + (e or 0.0)
        n_noise += int(noise.sum())
        d = np.abs(got - want)
        assert (d[~noise] <= 1e-6 + 1e-4 * np.abs(want[~noise])).all(), (
            "/".join(path), float(d[~noise].max(initial=0)))
        assert (d[noise] <= 2 * lr).all(), ("/".join(path), float(d.max()))
    return n_noise


def check_update_on_jax_grads(model, loader, variables, grads, new_params,
                              lr, steps, clip_norm=None):
    """The port's update (`train.apply_gradients`, with the tool's
    optimizer) on JAX's float32 gradients, on `model` holding
    `variables`, against optax's step from the same gradients
    (`new_params`): each parameter to 1e-8 + 1e-6 |p|, no entry exempt
    (the same gradients leave no sign to flip). `loader` maps a
    variables tree to the model's state dict; its maps are linear, so
    they carry gradients as they carry kernels."""
    state = loader({"params": grads,
                    "batch_stats": variables["batch_stats"]})
    for n, p in model.named_parameters():
        p.grad = state[n].clone()
    apply_gradients(model, *make_optimizer(model, lr, steps), clip_norm)
    for path, got, want in _pairs(variables_tree(model)["params"],
                                  new_params, "params"):
        d = np.abs(got - want)
        assert (d <= 1e-8 + 1e-6 * np.abs(want)).all(), (
            "/".join(path), float(d.max()))


def check_saved_variables(path, template, port_model, apply_jax, inputs,
                          load_variables):
    """A `save_variables` file restored by the JAX package's
    `load_variables` (strict against `template`): bit for bit the port
    model's variables, and the JAX model's eval forward on them within
    1e-5 of the port's."""
    restored = np_tree(load_variables(str(path), template))
    for p, got, want in _pairs(restored, variables_tree(port_model), "file"):
        assert np.array_equal(got, want), "/".join(p)
    port_model.eval()
    with torch.no_grad():
        got = port_model(*[torch.from_numpy(np.ascontiguousarray(a))
                           for a in inputs["port"]])
    want = np.asarray(apply_jax(restored, *inputs["jax"]))
    got = nn_(got)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale, float(
        np.abs(got - want).max())
