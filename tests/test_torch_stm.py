"""The port's STM (ResNet trunk, KeyValue, Decoder, memorize, segment),
its weight loader and STMAgent against the JAX package on the CPU.

Submodules take seeded flax inits with perturbed BatchNorm statistics,
converted through `load_stm`; the whole net takes the shipped
`weights/stm.msgpack`, at 96x128. Float maps are held to rtol 1e-4 of
their scale (f32 convolutions of XLA and oneDNN sum in other orders, 50
layers deep), the soft-aggregated scores as probabilities to 1e-5; the
agent's uint8 masks must agree on >= 99.9% of pixels (an argmax near a tie
may flip)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import make_clip
from tests.torch_port_util import assert_close, nn_, tt
from video_unscreen_tpu.agents.stm import STMAgent as JAgent
from video_unscreen_tpu.models import resnet as jresnet
from video_unscreen_tpu.models import stm as jstm
from video_unscreen_tpu.ops.geometry import imnormalize as j_imnormalize
from video_unscreen_tpu_torch.agents.stm import STMAgent
from video_unscreen_tpu_torch.models import resnet, stm
from video_unscreen_tpu_torch.utils.checkpoint import load_stm, read_msgpack

WEIGHTS = "weights/stm.msgpack"
HW = (96, 128)


def _np_tree(variables, seed):
    """flax variables as numpy, BatchNorm statistics and affine perturbed
    (a fresh init has mean 0, var 1, scale 1, bias 0, which would hide a
    swapped mapping)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("mean", "scale") or (
                name == "bias" and "BatchNorm" in str(path[-2].key)):
            return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _load(module, tree):
    module.load_state_dict(load_stm(tree))
    return module.eval()


def _nchw(a):
    return tt(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _nhwc(t):
    return np.transpose(nn_(t), (0, 2, 3, 1))


@pytest.mark.parametrize("kw,extra", [
    (dict(block="bottleneck", layers=(2, 1), num_stages=2, width=8), True),
    (dict(block="basic", layers=(1, 2, 1), num_stages=3, width=8,
          stem="deep", replace_stride_with_dilation=(False, True, False)),
     False),
])
def test_resnet(kw, extra):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 48, 64, 3).astype(np.float32)
    se = rng.randn(1, 24, 32, 8).astype(np.float32) if extra else None
    jm = jresnet.ResNet(**kw)
    tree = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = jm.apply(tree, jnp.asarray(x),
                    stem_extra=None if se is None else jnp.asarray(se))
    tm = _load(resnet.ResNet(**kw), tree)
    with torch.no_grad():
        got = tm(_nchw(x), stem_extra=None if se is None else _nchw(se))
    assert set(got) == set(want)
    for key in want:
        assert_close(_nhwc(got[key]), want[key], 1e-4, key)


def test_keyvalue_and_decoder():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 3, 4, 1024).astype(np.float32)
    jkv = jstm.KeyValue()
    tree = _np_tree(jkv.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    want = jkv.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = _load(stm.KeyValue(), tree)(_nchw(x))
    for g, w in zip(got, want):
        assert_close(_nhwc(g), w, 1e-4, "keyvalue")

    r4 = rng.randn(1, 3, 4, 1024).astype(np.float32)
    r3 = rng.randn(1, 6, 8, 512).astype(np.float32)
    r2 = rng.randn(1, 12, 16, 256).astype(np.float32)
    jdec = jstm.Decoder()
    args = [jnp.asarray(a) for a in (r4, r3, r2)]
    tree = _np_tree(jdec.init(jax.random.PRNGKey(2), *args), 5)
    want = jdec.apply(tree, *args)
    with torch.no_grad():
        got = _load(stm.Decoder(), tree)(_nchw(r4), _nchw(r3), _nchw(r2))
    assert_close(_nhwc(got), want, 1e-4, "decoder")


@pytest.fixture(scope="module")
def shipped():
    """The shipped weights as a numpy tree, and the port's net on them."""
    tree = read_msgpack(WEIGHTS)
    net = STMAgent(model_path=tree, input_long_side=128, device="cpu")
    return tree, net


def test_load_stm_consumes_every_leaf(shipped):
    tree, agent = shipped
    leaves = jax.tree_util.tree_leaves(tree)
    state = load_stm(tree)
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) - n_bn == len(leaves)
    assert set(state) == set(agent.model.state_dict())
    extra = copy.deepcopy(tree)
    extra["params"]["decoder"]["Conv_9"] = {
        "kernel": np.zeros((3, 3, 2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        stm.STM().load_state_dict(load_stm(extra))
    extra = copy.deepcopy(tree)
    extra["params"]["kv_q"]["Conv_0"]["lora"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected parameter"):
        load_stm(extra)


@pytest.fixture(scope="module")
def clip():
    frames, gts = make_clip(n=5)
    norm = [np.asarray(j_imnormalize(jnp.asarray(f, jnp.float32)))
            for f in frames]
    return frames, gts, norm


def test_memorize_and_segment(shipped, clip):
    tree, agent = shipped
    _, gts, norm = clip
    jm = jstm.STM()
    variables = jax.tree_util.tree_map(jnp.asarray, tree)
    fg = (gts[0] / 255.0).astype(np.float32)[None]
    bg = 1.0 - fg
    jk, jv = jm.apply(variables, jnp.asarray(norm[0][None]),
                      jnp.asarray(fg), jnp.asarray(bg),
                      method=jstm.STM.memorize)
    with torch.no_grad():
        tk, tv = agent.model.memorize(_nchw(norm[0][None]), tt(fg), tt(bg))
    assert tk.shape == (1, 6, 8, 128) and tv.shape == (1, 6, 8, 512)
    assert_close(tk, jk, 1e-4, "memory key")
    assert_close(tv, jv, 1e-4, "memory value")

    # a 3-slot bank: slot 0 empty (invalid), slots 1-2 the frame-0 memory
    mk = np.concatenate([np.zeros_like(jk), jk, jk])[None]
    mv = np.concatenate([np.zeros_like(jv), jv, jv])[None]
    valid = np.array([[False, True, True]])
    args = (jnp.asarray(norm[1][None]), jnp.asarray(mk), jnp.asarray(mv),
            jnp.asarray(valid))
    targs = (_nchw(norm[1][None]), tt(mk), tt(mv), torch.from_numpy(valid))
    want = jm.apply(variables, *args, method=jstm.STM.segment_raw)
    with torch.no_grad():
        got = agent.model.segment_raw(*targs)
    assert got.shape == (1, 2) + HW
    assert_close(_nhwc(got), want, 1e-4, "decoder logits")
    # the soft aggregation's log-odds log(p / (1 - p)) of a p within 1e-6
    # of 1 rests on the last bits of 1 - p, so the aggregated scores are
    # compared as the probabilities the agent takes from them
    want = jax.nn.softmax(jm.apply(variables, *args,
                                   method=jstm.STM.segment), axis=-1)
    with torch.no_grad():
        got = torch.softmax(agent.model.segment(*targs), dim=1)
    assert_close(_nhwc(got), want, 1e-5, "segment probabilities")


@pytest.mark.parametrize("n,capacity,step", [
    (2, 10, 2),   # as pipeline/bg.py calls it: the bank stays empty
    (5, 2, 1),    # commits on every step: the full bank evicts FIFO twice
])
def test_agent_forward(shipped, clip, n, capacity, step):
    tree, agent = shipped
    frames, gts, _ = clip
    jagent = JAgent(model_path=WEIGHTS, input_long_side=128,
                    memory_step=step, memory_capacity=capacity)
    want = jagent.forward(frames[:n], gts[0])
    port = copy.copy(agent)
    port.memory_capacity, port.memory_step = capacity, step
    got = port.forward(frames[:n], gts[0])
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        g = nn_(g)
        assert g.shape == w.shape and g.dtype == np.uint8
        assert (g == w).mean() >= 0.999, (g != w).sum()
    assert (nn_(got[-1]) == 255).any()
