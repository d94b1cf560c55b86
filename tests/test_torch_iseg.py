"""Interactive segmentation of the port against the JAX package on the CPU:
`Clicker`, `dist_maps`, `DistMapsModel` with the real weights/iseg.msgpack
(logits, the three BRS insertion points), the BRS objective and its
gradient, one-step and 20-step BRS, the click contract of
tests/test_iseg.py, and the MobileNetV2 DeepLab from a seeded JAX tree.
All JAX outputs come from one module-scoped run.

Tolerances:
- `Clicker` exactly; `dist_maps`' distances 2 sqrt(min d^2) exactly,
  its tanh maps to 2 ulp (2.4e-7: XLA's tanh is a rational
  approximation, torch's is not the same one);
- logits, features and probabilities: max |diff| <= 1e-4 of the array's
  scale (measured 8e-7 for logits, 1e-6 for one-step BRS);
- the BRS objective to 1e-5 relative, its gradient to 1e-4 of its scale;
- 20 L-BFGS steps on the shipped weights: on an ordinary pair of clicks
  (one in the subject, one in the background) the probabilities to 1e-4
  and the masks' IoU >= 0.99 (measured 1.0). On the adversarial pair of
  tests/test_iseg.py (a negative click inside the subject) the two
  optimizations follow one path for 8 iterations and then part: the
  objectives differ by 6e-8 in float32, and a 13-step line search of
  iteration 3 (step 1.6e-4) amplifies it. There the port's final click
  loss must be within 10% + 1e-3 of JAX's, the masks' IoU >= 0.97
  (measured 0.981), and both must meet the click contract.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.serialization

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import (assert_bf16_close, assert_close,
                                    assert_equal, tt)
from video_unscreen_tpu.agents import iseg as jagents
from video_unscreen_tpu.models import iseg as jmodels
from video_unscreen_tpu.models.deeplab import build_deeplab as j_build
from video_unscreen_tpu_torch.agents.iseg import Clicker, ISegAgent
from video_unscreen_tpu_torch.models.deeplab import build_deeplab
from video_unscreen_tpu_torch.models.iseg import (DistMapsModel, dist_maps,
                                                  nearest_dist)
from video_unscreen_tpu_torch.utils.checkpoint import load_deeplab, load_iseg

WEIGHTS = "weights/iseg.msgpack"
MODES = ("after_aspp", "after_c4", "after_deeplab")
ADVERSARIAL = [(True, 64, 50), (False, 64, 88)]
ORDINARY = [(True, 64, 64), (False, 10, 10)]
POINTS = np.array([[[1, 10, 20], [0, 40, 50], [-1, -1, -1], [1, 70, 3]],
                   [[0, 5, 100], [-1, -1, -1], [-1, -1, -1], [1, 90, 127]]],
                  np.float32)


def _scene():
    """The scene of tests/test_iseg.py:TestBRSFunctional (cv2's bicubic
    noise and ellipse: the JAX suite's own input)."""
    import cv2
    rng = np.random.RandomState(3)
    h = w = 128
    small = rng.rand(16, 16, 3).astype(np.float32)
    bg = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC).clip(0, 1)
    mask = np.zeros((h, w), np.float32)
    cv2.ellipse(mask, (64, 64), (36, 28), 20, 0, 360, 1.0, -1)
    img = (mask[..., None] * np.array([0.2, 0.5, 0.8], np.float32)
           + (1 - mask[..., None]) * bg)
    return (img.clip(0, 1) * 255).astype(np.uint8)


def _variables():
    with open(WEIGHTS, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def _jax_agent(variables, **kw):
    """The JAX ISegAgent, its own __init__ run with `DistMapsModel.init`
    answered by the restored checkpoint (flax's eager init of the
    ResNet-50 takes ~30 s on the CPU and is then overwritten)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels.DistMapsModel, "init",
                   lambda self, *a, **k: variables)
        return jagents.ISegAgent(model_path=WEIGHTS, **kw)


def _inputs(seed=0, flip=True):
    """A (B, 96, 128, 3) normalized batch (the image and its mirror) and
    its clicks, as ISegAgent builds them at input_long_side 128."""
    rng = np.random.RandomState(seed)
    img = rng.randn(96, 128, 3).astype(np.float32)
    pts = np.full((20, 3), -1.0, np.float32)
    pts[:3] = [(1, 40, 60), (0, 10, 15), (1, 80, 100)]
    if not flip:
        return img[None], pts[None]
    flipped = pts.copy()
    flipped[:3, 2] = 127 - flipped[:3, 2]
    return np.stack([img, img[:, ::-1]]), np.stack([pts, flipped])


def _click_loss(p, clicks, hw=(128, 128)):
    """The BRS data term of `probs` for `clicks` (radius-1 maps)."""
    c = Clicker(hw)
    for rec in clicks:
        c.add_click(*rec)
    pos, neg = c.get_clicks_maps()
    return (((1 - p) * pos) ** 2).sum() / (pos.sum() + 1e-5) + \
        ((p * neg) ** 2).sum() / (neg.sum() + 1e-5)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX output the tests hold the port to."""
    variables = _variables()
    jm = jmodels.DistMapsModel()
    out = {"variables": variables}
    imgs, pts = _inputs()
    out["logits"] = np.asarray(jax.jit(jm.apply)(
        variables, jnp.asarray(imgs), jnp.asarray(pts)))
    rng = np.random.RandomState(7)
    for mode in MODES:
        feats, aux = jax.jit(lambda v, i, p: jm.apply(
            v, i, p, method=lambda m, i, p: m.features(
                i, p, insertion_mode=mode)))(variables, jnp.asarray(imgs),
                                             jnp.asarray(pts))
        c = feats.shape[-1]
        scale = (rng.randn(c) * 0.1).astype(np.float32)
        bias = (rng.randn(c) * 0.1).astype(np.float32)
        logits = jax.jit(lambda v, f, s, b, a: jm.apply(
            v, f, (96, 128), s, b, method=lambda m, f, o, s, b:
            m.logits_from_features(f, o, s, b, insertion_mode=mode,
                                   aux=a)))(variables, feats, scale, bias,
                                            aux)
        out[mode] = dict(feats=np.asarray(feats), scale=scale, bias=bias,
                         aux=None if aux is None else np.asarray(aux),
                         logits=np.asarray(logits))
    # the bfloat16 net (`ISegAgent(dtype=jnp.bfloat16)` builds
    # `DistMapsModel(dtype=dtype)`): its logits, and at each insertion
    # point its features finished by its own head, in one program
    jm16 = jmodels.DistMapsModel(dtype=jnp.bfloat16)

    def bf16_chains(v, i, p):
        res = {"logits": jm16.apply(v, i, p).astype(jnp.float32)}
        for mode in MODES:
            f, a = jm16.apply(v, i, p, method=lambda m, i, p: m.features(
                i, p, insertion_mode=mode))
            res[mode] = jm16.apply(
                v, f, (96, 128), out[mode]["scale"], out[mode]["bias"],
                method=lambda m, f, o, s, b: m.logits_from_features(
                    f, o, s, b, insertion_mode=mode, aux=a)
            ).astype(jnp.float32)
        return res

    out["bf16"] = jax.tree.map(np.asarray, jax.jit(bf16_chains)(
        variables, jnp.asarray(imgs), jnp.asarray(pts)))
    # the BRS objective as ISegAgent.device_predict_brs builds it
    img, clicks = _scene(), ADVERSARIAL
    c_ = jagents.Clicker((128, 128))
    for rec in clicks:
        c_.add_click(*rec)
    pos, neg = c_.get_clicks_maps()
    norm = np.asarray(jagents.imnormalize(jnp.asarray(img, jnp.float32)))
    feats, _ = jm.apply(variables, jnp.asarray(norm[None]),
                        jnp.asarray(c_.points_tensor(20)[None]),
                        method=lambda m, i, p: m.features(i, p))
    c = feats.shape[-1]

    def objective(x):
        logits = jm.apply(variables, feats, (128, 128), x[:c], x[c:],
                          method=lambda m, f, o, s, b:
                          m.logits_from_features(f, o, s, b))
        probs = jax.nn.sigmoid(logits[..., 0])[0]
        loss = ((((1.0 - probs) * pos) ** 2).sum() / (pos.sum() + 1e-5)
                + ((probs * neg) ** 2).sum() / (neg.sum() + 1e-5))
        return loss + 1e-3 * ((x[:c] ** 2).sum()
                              + 10.0 * (x[c:] ** 2).sum())

    x = (rng.randn(2 * c) * 0.05).astype(np.float32)
    value, grad = jax.jit(jax.value_and_grad(objective))(jnp.asarray(x))
    out["objective"] = dict(norm=norm, pos=pos, neg=neg, x=x,
                            value=float(value), grad=np.asarray(grad))
    # BRS: one step at each insertion point, 20 steps at after_aspp
    for mode in MODES:
        agent = _jax_agent(variables, input_long_side=128, with_brs=True,
                           with_flip=False, brs_maxiter=1,
                           insertion_mode=mode)
        out[f"brs1_{mode}"] = agent.predict_probs(img, clicks)
    agent = _jax_agent(variables, input_long_side=128, with_brs=True,
                       with_flip=False, brs_maxiter=20)
    for name, cl in (("adversarial", ADVERSARIAL), ("ordinary", ORDINARY)):
        out[f"brs20_{name}"] = agent.predict_probs(img, cl)
    out["plain_flip"] = _jax_agent(
        variables, input_long_side=128).predict_probs(img, ORDINARY)
    # the MobileNetV2 DeepLab, seeded
    jdl = j_build(variant="mobilenet")
    x = np.random.RandomState(5).randn(1, 65, 97, 3).astype(np.float32)
    tree = jax.jit(jdl.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    out["mobilenet"] = dict(tree=jax.tree.map(np.asarray, tree), x=x,
                            logits=np.asarray(jax.jit(jdl.apply)(
                                tree, jnp.asarray(x))))
    return out


@pytest.fixture(scope="module")
def model():
    m = DistMapsModel().eval().requires_grad_(False)
    m.load_state_dict(load_iseg(WEIGHTS))
    return m


@pytest.fixture(scope="module")
def model16():
    return ISegAgent(WEIGHTS, input_long_side=128, dtype=torch.bfloat16,
                     device="cpu").model


def _nchw(a):
    return tt(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def test_clicker_matches_jax():
    for hw, clicks, n in (((32, 32), [(True, 10, 12), (False, 20, 20)], 4),
                          ((48, 64), [(True, 0, 0), (False, 47, 63),
                                      (True, 47, 0)], 2),
                          ((16, 16), [], 3)):
        got, want = Clicker(hw, 1), jagents.Clicker(hw, 1)
        for rec in clicks:
            got.add_click(*rec)
            want.add_click(*rec)
        for g, w in zip(got.get_clicks_maps(), want.get_clicks_maps()):
            assert_equal(g, w, "click map")
        assert_equal(got.points_tensor(n), want.points_tensor(n), "points")


def test_dist_maps_match_jax():
    """The squared distances exactly (JAX's tanh taken out), the maps to
    2 ulp."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "tanh", lambda x: x)
        want_root = np.asarray(jmodels.dist_maps(jnp.asarray(POINTS), 96,
                                                 128))
    got_root = 2.0 * nearest_dist(tt(POINTS), 96, 128)
    assert_equal(_nhwc(got_root), want_root, "2 sqrt(min d^2)")
    want = np.asarray(jmodels.dist_maps(jnp.asarray(POINTS), 96, 128))
    got = _nhwc(dist_maps(tt(POINTS), 96, 128)).numpy()
    assert np.abs(got - want).max() <= 2.4e-7


def test_logits_with_shipped_weights(jax_ref, model):
    imgs, pts = _inputs()
    got = model(_nchw(imgs), tt(pts))
    assert_close(_nhwc(got), jax_ref["logits"], 1e-4, "logits")


@pytest.mark.parametrize("mode", MODES)
def test_insertion_points_match_jax(jax_ref, model, mode):
    ref = jax_ref[mode]
    imgs, pts = _inputs()
    feats, aux = model.features(_nchw(imgs), tt(pts), mode)
    assert_close(_nhwc(feats), ref["feats"], 1e-4, f"{mode} features")
    assert (aux is None) == (ref["aux"] is None)
    if aux is not None:
        assert_close(_nhwc(aux), ref["aux"], 1e-4, f"{mode} skip")
    # finished from JAX's own features, so only the head is compared
    logits = model.logits_from_features(
        _nchw(ref["feats"]), (96, 128), tt(ref["scale"]), tt(ref["bias"]),
        mode, None if aux is None else _nchw(ref["aux"]))
    assert_close(_nhwc(logits), ref["logits"], 1e-4, f"{mode} logits")


def test_brs_objective_and_gradient(jax_ref):
    ref = jax_ref["objective"]
    agent = ISegAgent(WEIGHTS, input_long_side=128, with_flip=False,
                      device="cpu")
    pts = Clicker((128, 128))
    for rec in ADVERSARIAL:
        pts.add_click(*rec)
    with torch.no_grad():
        feats, aux = agent.model.features(
            _nchw(ref["norm"][None]), tt(pts.points_tensor(20)[None]))
    objective = agent.brs_objective(feats, aux, (128, 128), tt(ref["pos"]),
                                    tt(ref["neg"]))
    x = tt(ref["x"]).requires_grad_(True)
    value = objective(x)
    grad, = torch.autograd.grad(value, x)
    assert abs(float(value.detach()) - ref["value"]) <= 1e-5 * abs(ref["value"])
    assert_close(grad, ref["grad"], 1e-4, "BRS gradient")


@pytest.mark.parametrize("mode", MODES)
def test_brs_one_step_matches_jax(jax_ref, mode):
    agent = ISegAgent(WEIGHTS, input_long_side=128, with_brs=True,
                      with_flip=False, brs_maxiter=1, insertion_mode=mode,
                      device="cpu")
    got = agent.predict_probs(_scene(), ADVERSARIAL)
    assert_close(got, jax_ref[f"brs1_{mode}"], 1e-4, f"BRS 1 step {mode}")
    stats = agent.brs_stats
    assert stats["iterations"] == 1
    assert stats["evaluations"] == stats["linesearch_steps"] + 1
    assert stats["syncs"] == stats["evaluations"]


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def test_brs_twenty_steps_against_jax(jax_ref):
    agent = ISegAgent(WEIGHTS, input_long_side=128, with_brs=True,
                      with_flip=False, brs_maxiter=20, device="cpu")
    img = _scene()
    got = agent.predict_probs(img, ORDINARY)
    want = jax_ref["brs20_ordinary"]
    assert_close(got, want, 1e-4, "BRS 20 steps, ordinary clicks")
    assert _iou(got > 0.5, want > 0.5) >= 0.99
    got = agent.predict_probs(img, ADVERSARIAL)
    want = jax_ref["brs20_adversarial"]
    assert _iou(got > 0.5, want > 0.5) >= 0.97
    assert _click_loss(got, ADVERSARIAL) <= \
        1.1 * _click_loss(want, ADVERSARIAL) + 1e-3
    # 20 iterations: one sync to start each and one a line-search step
    stats = agent.brs_stats
    assert stats["iterations"] == 20
    assert stats["syncs"] == 20 + stats["linesearch_steps"]


def test_plain_with_flip_matches_jax(jax_ref):
    agent = ISegAgent(WEIGHTS, input_long_side=128, device="cpu")
    got = agent.predict_probs(_scene(), ORDINARY)
    assert_close(got, jax_ref["plain_flip"], 1e-4, "plain, flip TTA")


def test_brs_click_contract():
    """tests/test_iseg.py:TestBRSFunctional on the port: the negative click
    inside the subject is missed by the plain prediction and met after
    BRS, the click-miss loss falls, and the subject around the positive
    click stays foreground."""
    img = _scene()
    agent = ISegAgent(WEIGHTS, input_long_side=128, with_brs=True,
                      with_flip=False, brs_maxiter=20, device="cpu")
    p_plain = agent.predict_probs(img, ADVERSARIAL, use_brs=False)
    p_brs = agent.predict_probs(img, ADVERSARIAL, use_brs=True)

    def miss_loss(p):
        return (1.0 - p[64, 50]) ** 2 + p[64, 88] ** 2

    assert p_plain[64, 88] > 0.5
    assert p_brs[64, 50] > 0.5
    assert p_brs[64, 88] < 0.5
    assert miss_loss(p_brs) < miss_loss(p_plain)
    mask = agent.forward(img, ADVERSARIAL)
    assert (mask[56:72, 44:58] == 255).mean() > 0.8
    assert set(np.unique(mask)) <= {0, 255}


@pytest.mark.parametrize("mode", MODES)
def test_forward_contract_seeded(mode):
    """tests/test_iseg.py's forward contract on seeded weights: a
    (48, 64) {0, 255} mask, plain with flip and BRS at each insertion
    point."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    agent = ISegAgent(input_long_side=64, with_brs=True, with_flip=False,
                      brs_maxiter=2, insertion_mode=mode, device="cpu")
    for use_brs in (False, True):
        mask = (agent.predict_probs(img, [(True, 24, 32)], use_brs)
                > 0.5).astype(np.uint8) * 255
        assert mask.shape == (48, 64)
        assert set(np.unique(mask)) <= {0, 255}


def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match="insertion_mode"):
        ISegAgent(input_long_side=64, insertion_mode="after_nothing",
                  device="cpu")


def test_mobilenet_deeplab_from_seeded_tree(jax_ref):
    ref = jax_ref["mobilenet"]
    model = build_deeplab(variant="mobilenet").eval()
    model.load_state_dict(load_deeplab(ref["tree"]))
    with torch.no_grad():
        got = model(_nchw(ref["x"]))
    assert_close(_nhwc(got), ref["logits"], 1e-4, "MobileNetV2 DeepLab")


@pytest.mark.parametrize("mode", MODES)
def test_bf16_agent_runs(mode):
    """`ISegAgent(dtype=torch.bfloat16)` as JAX's `dtype=`: bfloat16
    convolutions, float32 BatchNorms, float32 probabilities in [0, 1]
    from the plain prediction and from BRS at each insertion point, in
    JAX's parameter order (`insertion_mode`, `dtype`, `seed`). Its masks
    are held against float32's on the card (`chip_smoke.py --paths
    iseg`)."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    agent = ISegAgent(None, True, 64, 0.5, False, 0, 20, 1e-3, 10.0, 2,
                      mode, torch.bfloat16, 0, device="cpu")
    assert agent.model.rgb_conv1.weight.dtype == torch.bfloat16
    assert agent.model.inst_head.convs[-1].weight.dtype == torch.bfloat16
    assert agent.model.rgb_bn.weight.dtype == torch.float32
    for use_brs in (False, True):
        probs = agent.predict_probs(img, [(True, 24, 32)], use_brs)
        assert probs.shape == (48, 64) and probs.dtype == np.float32
        assert np.isfinite(probs).all()
        assert probs.min() >= 0.0 and probs.max() <= 1.0


def _chain(model, what, scale_bias):
    """The net's logits ("logits"), or its features at the insertion point
    `what` finished by its own head, as float32 NHWC."""
    imgs, pts = _inputs()
    with torch.no_grad():
        if what == "logits":
            out = model(_nchw(imgs), tt(pts))
        else:
            feats, aux = model.features(_nchw(imgs), tt(pts), what)
            out = model.logits_from_features(
                feats, (96, 128), tt(scale_bias["scale"]),
                tt(scale_bias["bias"]), what, aux)
    return _nhwc(out).float()


@pytest.mark.parametrize("what", ("logits",) + MODES)
def test_bf16_logits_against_jax(jax_ref, model, model16, what):
    """The bfloat16 net against JAX's `DistMapsModel(dtype=jnp.bfloat16)`
    on the same inputs and weights: the plain logits and, at each
    insertion point, the features finished by the head. Bound 6.5e-3 of
    the mean |logit|, chosen as the DeepLab and UNet bounds were: above
    the port's bfloat16 against JAX's (measured 5.0e-3 to 5.9e-3) and
    below every float32-against-bfloat16 pair (7.4e-3 to 9.8e-3), which
    `assert_bf16_close` also checks."""
    ref = None if what == "logits" else jax_ref[what]
    want32 = jax_ref["logits"] if ref is None else ref["logits"]
    want16 = jax_ref["bf16"][what]
    got32 = _chain(model, what, ref)
    got16 = _chain(model16, what, ref)
    assert_bf16_close(got16, want16, 6.5e-3,
                      [(got32, want16), (got16, want32)],
                      f"ISeg bfloat16 {what}")
