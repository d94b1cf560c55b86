"""The SCHP seed of the port against the JAX package on the CPU: the
axis-aligned affine warp, the person-box matrices, the model's resize and
pooling, `SCHPHumanParser` with the real `weights/schp_human.msgpack` and
a seeded small one carried across by `state_dict_from_variables`,
`HumanSegAgent`'s masks, bfloat16 against JAX's bfloat16, the modular bg
run with the "human" seed, and the F3 gate (a bfloat16 train-mode
BatchNorm against flax's).

Tolerances: the warp 1e-5 of its scale; the matrices exactly; the
model's resize and pooling 1e-5; logits |diff| <= 1e-4 |want| + 1e-4 max
|want| (the DeepLab and STM logits' bound); masks equal wherever the JAX
logits' top-two margin exceeds 1e-3; bfloat16 logits against JAX's
bfloat16 within a mean relative difference of 5e-3 (float32 against
bfloat16 exceeds it); the bfloat16 BatchNorm's float32 statistics to
1e-6 and its bfloat16 output within one bfloat16 step (2^-7 relative) of
flax's plus 1e-3 of its largest value (this batch, mean 3 and std 0.05,
makes the one-pass variance cancel to ~4e-4 relative in float32 on both
sides; taken in bfloat16, the statistics miss by ~0.3)."""
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_port_util import (assert_bf16_close, assert_close,
                                   assert_equal, nn_, tt)
from video_unscreen_tpu.agents.binseg import HumanSegAgent as JHuman
from video_unscreen_tpu.models import human_parse as jhp
from video_unscreen_tpu.ops import geometry as jgeo
from video_unscreen_tpu_torch.agents.binseg import (HumanSegAgent,
                                                    build_seg_agent)
from video_unscreen_tpu_torch.models import human_parse as thp
from video_unscreen_tpu_torch.models.batchnorm import FlaxBatchNorm2d
from video_unscreen_tpu_torch.models.precision import convs_to
from video_unscreen_tpu_torch.ops import geometry as tgeo
from video_unscreen_tpu_torch.pipeline import bg as tbg
from video_unscreen_tpu_torch.utils.checkpoint import (
    state_dict_from_variables)

WEIGHTS = "weights/schp_human.msgpack"
HW = (96, 128)
CROP = 129
SMALL = (1, 1, 1, 1)


def _logits_close(got, want, what):
    got, want = nn_(got).astype(np.float64), nn_(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want)
    bound = 1e-4 * np.abs(want) + 1e-4 * np.abs(want).max()
    assert (d <= bound).all(), f"{what}: max |diff| {d.max()}"


def _frames(n=2):
    return [f.astype(np.float32) for f in make_clip(n=n)[0]]


def _small_variables(seed=0):
    """A seeded layers=(1, 1, 1, 1) SCHP with its BatchNorm statistics and
    affine perturbed, so that a swapped mapping would show."""
    model = jhp.SCHPHumanParser(num_classes=20, layers=SMALL)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 65, 65,
                                                                3)))
    rng = np.random.RandomState(seed + 1)

    def perturb(path, a):
        a = np.array(a, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if path[-1].key in ("mean", "scale", "bias"):
            return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _torch_small(variables, dtype=torch.float32):
    model = thp.SCHPHumanParser(20, SMALL)
    model.load_state_dict(state_dict_from_variables(variables))
    return convs_to(model.eval(), dtype)


@pytest.fixture(scope="module")
def shipped():
    """The JAX and the port's agents on the real weights at crop 129."""
    kw = dict(model_path=WEIGHTS, crop_h=CROP, crop_w=CROP)
    return JHuman(**kw), HumanSegAgent(**kw, device="cpu")


@pytest.mark.parametrize("shape", [HW, HW + (3,), (CROP, CROP, 20),
                                   (2,) + HW + (3,)])
def test_affine_warp_axis_aligned(shape):
    """Both warps of the agent (frame -> crop and the 1/4 logits' inverse)
    and a plain scale-and-shift, on images, channel stacks and a batch."""
    rng = np.random.RandomState(len(shape))
    img = rng.uniform(0, 255, shape).astype(np.float32)
    in_hw = shape[1:3] if len(shape) == 4 else shape[:2]
    agent = types.SimpleNamespace(input_size=(CROP, CROP))
    fwd, inv = JHuman._transforms(agent, *in_hw)
    shift = np.array([[0.7, 0.0, 3.25], [0.0, 1.3, -2.5]], np.float32)
    mats = ((inv, HW) if in_hw == (CROP, CROP)
            else (fwd, (CROP, CROP))), (shift, (50, 70))
    for mat, out_hw in mats:
        got = tgeo.affine_warp_axis_aligned(tt(img), mat, out_hw)
        items = img if len(shape) == 4 else img[None]
        want = np.stack([np.asarray(jgeo.affine_warp_axis_aligned(
            jnp.asarray(x), mat, out_hw)) for x in items])
        assert_close(got, want if len(shape) == 4 else want[0], 1e-5,
                     f"warp {shape} -> {out_hw}")
    with pytest.raises(ValueError):
        tgeo.affine_warp_axis_aligned(tt(img), np.array(
            [[1.0, 0.1, 0.0], [0.0, 1.0, 0.0]]), (8, 8))


@pytest.mark.parametrize("hw", [(96, 128), (544, 960), (1080, 1920),
                                (128, 96), (473, 473), (300, 301)])
@pytest.mark.parametrize("crop", [(473, 473), (129, 129), (160, 120)])
def test_transforms(hw, crop):
    agent = types.SimpleNamespace(input_size=crop)
    for got, want in zip(HumanSegAgent._transforms(agent, *hw),
                         JHuman._transforms(agent, *hw)):
        assert got.dtype == want.dtype == np.float32
        assert_equal(got, want, f"{hw} {crop}")


@pytest.mark.parametrize("src,dst", [((6, 6), (30, 30)), ((1, 1), (9, 9)),
                                     ((3, 2), (33, 33)), ((6, 6), (4, 4)),
                                     ((6, 6), (5, 9))])
def test_resize_to(src, dst):
    """The model's "linear" resize: upsampling at every shipped shape; a
    map under PSP's 6 bins is downsampled with antialiasing."""
    x = np.random.RandomState(0).randn(2, *src, 5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="linear")
    got = thp._resize_to(tt(x).permute(0, 3, 1, 2), *dst)
    assert_close(got.permute(0, 2, 3, 1), want, 1e-5, f"{src} -> {dst}")


@pytest.mark.parametrize("hw", [(30, 30), (9, 9), (5, 7), (4, 4), (1, 2)])
def test_adaptive_pool(hw):
    """F.adaptive_avg_pool2d against the JAX package's PyTorch-bin pool,
    maps smaller than the 6 bins included."""
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    for size in (1, 2, 3, 6):
        want = jhp._adaptive_avg_pool(jnp.asarray(x), size)
        got = F.adaptive_avg_pool2d(tt(x).permute(0, 3, 1, 2), size)
        assert_close(got.permute(0, 2, 3, 1), want, 1e-5, f"{hw} {size}")


def test_schp_logits_real_weights(shipped):
    """The full SCHP (ResNet-101) on the shipped weights, two crops of
    129x129."""
    jagent, tagent = shipped
    x = np.random.RandomState(2).randn(2, CROP, CROP, 3).astype(np.float32)
    want = jagent.model.apply(jagent.variables, jnp.asarray(x))
    with torch.no_grad():
        got = tagent.model(tt(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 20, 33, 33)
    _logits_close(got.permute(0, 2, 3, 1), want, "SCHP logits")


def test_seeded_small_model():
    """A seeded layers=(1, 1, 1, 1) model carried from its JAX variables
    by `state_dict_from_variables`, at a crop whose 1/16 map (5x5) is
    smaller than PSP's 6 bins."""
    variables = _small_variables()
    x = np.random.RandomState(3).randn(2, 65, 65, 3).astype(np.float32)
    want = jhp.SCHPHumanParser(num_classes=20, layers=SMALL).apply(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = _torch_small(variables)(tt(x).permute(0, 3, 1, 2))
    _logits_close(got.permute(0, 2, 3, 1), want, "small SCHP logits")


def test_agent_masks(shipped):
    """`predict_mask_impl` on a batch of two frames in one forward against
    the JAX agent frame by frame; `forward` and the counts."""
    jagent, tagent = shipped
    frames = _frames()
    before = (tagent.forwards, tagent.frames)
    logits = tagent.predict_logits(tt(np.stack(frames)))
    masks = tagent.predict_mask_impl(tt(np.stack(frames)))
    assert (tagent.forwards - before[0], tagent.frames - before[1]) == (2, 4)
    fwd, inv = jagent._transforms(*HW)
    for i, f in enumerate(frames):
        warped = jgeo.affine_warp_axis_aligned(jnp.asarray(f), fwd,
                                               (CROP, CROP))
        lg = jagent.model.apply(jagent.variables,
                                jgeo.imnormalize(warped)[None])[0]
        back = np.asarray(jgeo.affine_warp_axis_aligned(
            jgeo.resize(lg.astype(jnp.float32), (CROP, CROP)), inv, HW))
        _logits_close(logits[i].permute(1, 2, 0), back, f"frame {i} logits")
        want = np.asarray(jagent.predict_mask_impl(jagent.variables,
                                                   jnp.asarray(f)))
        top2 = np.sort(back, axis=-1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > 1e-3
        assert_equal(nn_(masks[i])[sure], want[sure], f"frame {i} mask")
        assert 0.0 < want.mean() < 255.0
    mask = tagent.forward(frames[0].astype(np.uint8))
    assert mask.dtype == torch.uint8 and mask.shape == HW
    assert_equal(mask, nn_(masks[0]).astype(np.uint8))


def test_schp_bf16_against_jax():
    """The bfloat16 net (convolutions bf16, BatchNorm f32) against JAX's
    bfloat16 apply on the same seeded variables."""
    variables = _small_variables(4)
    x = jnp.asarray(np.random.RandomState(5).randn(2, 65, 65, 3).astype(
        np.float32))
    want = {dt: np.asarray(jhp.SCHPHumanParser(
        num_classes=20, layers=SMALL, dtype=dt).apply(variables, x).astype(
            jnp.float32)) for dt in (jnp.float32, jnp.bfloat16)}
    with torch.no_grad():
        got = {dt: _torch_small(variables, dt)(
            tt(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            for dt in (torch.float32, torch.bfloat16)}
    assert got[torch.bfloat16].dtype == torch.float32
    assert_bf16_close(got[torch.bfloat16], want[jnp.bfloat16], 5e-3,
                      [(got[torch.float32], want[jnp.bfloat16]),
                       (got[torch.bfloat16], want[jnp.float32])],
                      "SCHP bfloat16 logits")


def test_build_and_parity_kwargs():
    agent = build_seg_agent({"type": "human", "layers": SMALL,
                             "crop_h": 65, "crop_w": 65}, device="cpu")
    assert isinstance(agent, HumanSegAgent)
    assert agent.input_size == (65, 65)
    with pytest.warns(UserWarning, match="ignores 'flip'"):
        HumanSegAgent(layers=SMALL, flip=False, device="cpu")


def test_bg_run_with_the_human_seed():
    """`pipeline/bg.py:run` with the shipped seed type (SCHP from the real
    weights, at crop 129): the seed runs on frame 0 only, then STM
    tracks."""
    cfg = dict(BG_TEST_CFG, binseg={"type": "human", "model_path": WEIGHTS,
                                    "crop_h": CROP, "crop_w": CROP})
    frames = [f.astype(np.uint8) for f in _frames(2)]
    res = tbg.run(cfg, frames, device="cpu")
    assert res["numframes"] == 2
    assert all(a.shape == HW and a.dtype == np.uint8 for a in res["alphas"])


def test_batchnorm_bf16_train_against_flax():
    """F3: a bfloat16 train-mode BatchNorm takes its batch statistics in
    float32, as flax's `nn.BatchNorm(dtype=bfloat16)`; the running
    statistics and the output against flax's."""
    rng = np.random.RandomState(6)
    x = (3.0 + rng.randn(4, 7, 9, 16) * 0.05).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    variables = bn.init(jax.random.PRNGKey(0), xb)
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32),
              "bias": jnp.asarray(rng.randn(16), jnp.float32)}
    want, upd = bn.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, xb,
                         mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16
    tbn = FlaxBatchNorm2d(16).train()
    with torch.no_grad():
        tbn.weight.copy_(tt(params["scale"]))
        tbn.bias.copy_(tt(params["bias"]))
    got = tbn(tt(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    stats = upd["batch_stats"]
    for name, want_s in (("running_mean", stats["mean"]),
                         ("running_var", stats["var"])):
        assert_close(getattr(tbn, name), want_s, 1e-6, name)
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want.astype(jnp.float32))
    d = np.abs(got - want)
    assert (d <= 2.0 ** -7 * np.abs(want)
            + 1e-3 * np.abs(want).max()).all(), d.max()
