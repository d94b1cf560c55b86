"""MattingUNet and the matting agent of the port against the JAX package,
with the parameters carried across from the JAX weight load, to about 1e-5
relative (float32 convolutions summed in another order); the bfloat16 net's
last convolution against JAX's bfloat16 one within a mean relative
difference of 5.5e-3 (same-type runs 4.1e-3, float32 against bfloat16
7.4e-3 and 7.7e-3 on these inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import make_clip
from tests.torch_port_util import (assert_bf16_close, assert_close,
                                   assert_equal, tt)
from video_unscreen_tpu.agents.vmatting import VMattingAgent as JVM
from video_unscreen_tpu_torch.agents.vmatting import VMattingAgent as TVM
from video_unscreen_tpu.models.matting_unet import MattingUNet as JUNet
from video_unscreen_tpu_torch.models.matting_unet import MattingUNet
from video_unscreen_tpu_torch.models.precision import convs_to

WEIGHTS = "weights/matting_unet.msgpack"


@pytest.fixture(scope="module")
def agents():
    jagent = JVM(model_path=WEIGHTS, input_long_side=128, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jagent.variables)
    return jagent, TVM(model_path=variables, input_long_side=128,
                       device="cpu")


def _inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-2, 2, (1, h, w, 3)).astype(np.float32)
    ap = rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)
    cls = rng.randint(0, 3, (h, w))
    tri = np.eye(3, dtype=np.float32)[cls][None]
    return img, ap, tri


def _nchw(a):
    return tt(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("h,w", [(64, 64), (96, 128)])
def test_unet_forward(agents, h, w):
    jagent, tagent = agents
    img, ap, tri = _inputs(h, w, seed=h)
    want = jagent.model.apply(jagent.variables, img, ap, tri)[..., 0]
    with torch.no_grad():
        got = tagent.model(_nchw(img), _nchw(ap), _nchw(tri))[:, 0]
    assert_close(got, want, 1e-5, "alpha")


def test_unet_bf16_against_jax(agents):
    """The bfloat16 net (convolutions and BatchNorm in bfloat16, as flax's
    `dtype=jnp.bfloat16`) against JAX's bfloat16 apply on the same
    variables, at a bound that either net in float32 would miss: the last
    convolution's output, the input of the head, which the port takes in
    float32 where flax stays in bfloat16; the alpha float32 and finite."""
    import copy
    jagent, tagent = agents
    img, ap, tri = _inputs(96, 128, seed=0)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        _, inter = JUNet(dtype=dt).apply(
            jagent.variables, img, ap, tri, capture_intermediates=True,
            mutable=["intermediates"])
        raw = inter["intermediates"]["dec_conv2"]["__call__"][0]
        assert raw.dtype == dt
        want[dt] = np.asarray(raw[..., 0].astype(jnp.float32))
    net16 = convs_to(copy.deepcopy(tagent.model), torch.bfloat16)
    got = {}
    for dt, m in ((torch.float32, tagent.model), (torch.bfloat16, net16)):
        hook = m.dec_conv2.register_forward_hook(
            lambda mod, args, out, dt=dt: got.__setitem__(dt, out[:, 0]))
        with torch.no_grad():
            alpha = m(_nchw(img), _nchw(ap), _nchw(tri))
        hook.remove()
        assert alpha.dtype == torch.float32
        assert bool(torch.isfinite(alpha).all())
    assert got[torch.bfloat16].dtype == torch.bfloat16
    got = {dt: g.float() for dt, g in got.items()}
    assert_bf16_close(got[torch.bfloat16], want[jnp.bfloat16], 5.5e-3,
                      [(got[torch.float32], want[jnp.bfloat16]),
                       (got[torch.bfloat16], want[jnp.float32])],
                      "MattingUNet bfloat16 head input")


def test_transposed_conv_layout():
    """The 4x4 kernel map: flax's SubpixelConvTranspose against
    nn.ConvTranspose2d(k=4, s=2, p=1) on one layer."""
    from video_unscreen_tpu.models.matting_unet import SubpixelConvTranspose
    from video_unscreen_tpu_torch.utils.checkpoint import load_matting_unet
    rng = np.random.RandomState(0)
    x = rng.randn(1, 5, 7, 6).astype(np.float32)
    mod = SubpixelConvTranspose(4)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = mod.apply(params, jnp.asarray(x))
    kernel = np.asarray(params["params"]["kernel"])
    state = load_matting_unet({"params": {"up": {"kernel": kernel}}})
    conv = torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1, bias=False)
    conv.weight.data.copy_(state["up.weight"])
    with torch.no_grad():
        got = conv(_nchw(x)).permute(0, 2, 3, 1)
    assert_close(got, want, 1e-5, "transposed conv")


@pytest.mark.parametrize("src_hw", [(96, 128), (90, 128)])
def test_agent_forward(agents, src_hw):
    jagent, tagent = agents
    frames, gts = make_clip(n=2)
    img = frames[1][:src_hw[0]].astype(np.float32)
    alpha_pre = gts[0][:src_hw[0]].astype(np.float32)
    # a trimap with all three classes around the blob
    tri = np.where(gts[1][:src_hw[0]] > 0, 255.0, 0.0).astype(np.float32)
    tri[np.abs(np.gradient(tri)[1]) > 0] = 128.0
    tri[30:40, 20:60] = 128.0
    want = jagent.device_forward_impl(jagent.variables, jnp.asarray(img),
                                      jnp.asarray(alpha_pre),
                                      jnp.asarray(tri), (96, 128))
    with torch.no_grad():
        got = tagent.device_forward_impl(tt(img), tt(alpha_pre), tt(tri),
                                         (96, 128))
    assert_close(got, want, 1e-5, "alpha")
    assert_equal(got[tt(tri) == 0], np.zeros(int((tri == 0).sum())))


def test_output_saturates_like_the_reference():
    """Beyond |raw| = 7.9988 the reference's float32 tanh is exactly +-1,
    so the alpha is exactly 0 or 1 there; torch's tanh gets there only at
    ~9.01."""
    net = MattingUNet().eval()
    raw = torch.tensor([-9.0, -8.0, -7.99, 0.0, 7.99, 8.0, 9.0])
    conv = net.dec_conv2
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
    # run only the head: feed a bias and read the output
    outs = []
    for r in raw:
        with torch.no_grad():
            conv.bias.fill_(float(r))
            outs.append(float(net(torch.zeros(1, 3, 32, 32),
                                  torch.zeros(1, 1, 32, 32),
                                  torch.zeros(1, 3, 32, 32)).mean()))
    want = np.asarray(jax.jit(lambda v: (jnp.tanh(v) + 1.0) / 2.0)(
        np.asarray(raw)))
    outs = np.asarray(outs, np.float32)
    sat = np.abs(np.asarray(raw)) >= 8.0
    np.testing.assert_array_equal(outs[sat], want[sat])
    assert set(outs[sat].tolist()) == {0.0, 1.0}
    np.testing.assert_allclose(outs[~sat], want[~sat], atol=1e-6)


def test_spectral_normalize_tree_against_jax(agents):
    """The SpectralNorm fold of the shipped weights: the port's
    `spectral_normalize_tree` on the torch state dict against JAX's on its
    params tree (same float64 power iterations, same draws in flax's
    order), every weight bit-equal once mapped."""
    from video_unscreen_tpu.models.matting_unet import \
        spectral_normalize_tree as j_fold
    from video_unscreen_tpu_torch.models.matting_unet import \
        spectral_normalize_tree as t_fold
    from video_unscreen_tpu_torch.utils.checkpoint import load_matting_unet
    jagent, tagent = agents
    variables = jax.tree.map(np.asarray, jagent.variables)
    want = load_matting_unet(dict(variables, params=jax.tree.map(
        np.asarray, j_fold(jagent.variables["params"]))))
    state = tagent.model.state_dict()
    got = t_fold(state)
    n_folded = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        assert_equal(got[key], w, key)
        n_folded += int(w.dim() == 4 and not torch.equal(w, state[key]))
    assert n_folded == 54


def test_agent_reads_the_fold_from_its_sidecar(agents, tmp_path):
    """`VMattingAgent(fold_spectral_norm=None)` folds when the weights'
    `.meta.json` sidecar says `"pre_spectral_norm": true`, as the JAX
    agent does, `fold_spectral_norm=True` folds without one and False
    overrides the sidecar. (The fold itself is held against JAX above.)"""
    import json
    import os
    path = tmp_path / "matting_unet.msgpack"
    os.symlink(os.path.abspath(WEIGHTS), path)
    (tmp_path / "matting_unet.msgpack.meta.json").write_text(
        json.dumps({"pre_spectral_norm": True}))
    _, tagent = agents
    folded = TVM(model_path=str(path), input_long_side=128, device="cpu")
    forced = TVM(model_path=WEIGHTS, input_long_side=128, device="cpu",
                 fold_spectral_norm=True)
    plain = TVM(model_path=str(path), input_long_side=128, device="cpu",
                fold_spectral_norm=False)
    base = tagent.model.state_dict()
    for key, w in folded.model.state_dict().items():
        assert_equal(w, forced.model.state_dict()[key], key)
        assert_equal(plain.model.state_dict()[key], base[key], key)
        if w.dim() == 4:
            assert not torch.equal(w, base[key]), key
