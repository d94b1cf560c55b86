"""The DeepLab seed of the port against the JAX package on the CPU: the
crop grid, the model's upsampling, `load_deeplab`, the DeepLabV3+ and
DeepLabV3 forwards, `SegAgent` (scores, masks, the host `forward`) and the
green pipeline with `configs/green.json`'s DeepLab seed, float32 on both
sides.

Tolerances: the crop grid exactly; resizes 1e-5 of their scale; logits
|diff| <= 1e-4 |want| + 1e-4 max |want| (the bound of the STM decoder's
logits); bfloat16 logits against JAX's bfloat16 ones within a mean
relative difference of 6e-3 (same-type runs 4.0e-3, float32 against
bfloat16 1.0e-2 on these inputs); TTA scores 1e-4; masks equal wherever the JAX scores decide by
more than 1e-3; the pipeline's uint8 outputs within the JAX suite's bound,
max |diff| <= 4 and |diff| > 1 on < 0.1% of pixels
(tests/test_fused_green.py)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import (assert_bf16_close, assert_close, nn_,
                                   tt)
from video_unscreen_tpu.agents.binseg import SegAgent as JSeg
from video_unscreen_tpu.agents.binseg import _crop_grid as j_crop_grid
from video_unscreen_tpu.models.deeplab import build_deeplab as j_build
from video_unscreen_tpu.ops import geometry as jgeo
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.agents.binseg import SegAgent, _crop_grid
from video_unscreen_tpu_torch.models.deeplab import build_deeplab
from video_unscreen_tpu_torch.models.precision import convs_to
from video_unscreen_tpu_torch.ops.geometry import resize_nchw
from video_unscreen_tpu_torch.pipeline import fused_green as tfg
from video_unscreen_tpu_torch.utils.checkpoint import load_deeplab

WEIGHTS = "weights/deeplab_binseg.msgpack"
HW = (96, 128)
# the binseg section of tests/test_fused_green.py:test_fused_green_neural_seg
SEG_CFG = {"input_long_side": 128, "crop_h": 128, "crop_w": 128,
           "stride_ratio": 0.5, "flip": True}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _logits_close(got, want, what):
    got, want = nn_(got).astype(np.float64), nn_(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = 1e-4 * np.abs(want) + 1e-4 * np.abs(want).max()
    d = np.abs(got - want)
    assert (d <= bound).all(), f"{what}: max |diff| {d.max()}"


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("stride_ratio", [0.5, 1.0])
@pytest.mark.parametrize("h,w,crop", [(96, 128, 128), (544, 960, 513),
                                      (541, 962, 513)])
def test_crop_grid(h, w, crop, stride_ratio, flip):
    want = j_crop_grid(h, w, crop, crop, stride_ratio, flip)
    assert _crop_grid(h, w, crop, crop, stride_ratio, flip) == want


@pytest.mark.parametrize("src,dst", [(65, 129), (129, 513), (12, 24)])
def test_model_upsampling(src, dst):
    """Both of the model's resizes upsample: the port's bilinear equals
    flax's "linear" `jax.image.resize` (antialiasing on) there."""
    x = np.random.RandomState(src).randn(2, src, src + 3, 5).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst + 5, 5), "linear")
    got = resize_nchw(tt(x).permute(0, 3, 1, 2), (dst, dst + 5))
    assert_close(got.permute(0, 2, 3, 1), want, 1e-5, f"{src}->{dst}")


@pytest.fixture(scope="module")
def shipped():
    """The JAX agent on the shipped weights and the port's agent on the
    same variables, carried across as numpy."""
    jseg = JSeg(model_path=WEIGHTS, dtype=jnp.float32, **SEG_CFG)
    tseg = SegAgent(model_path=_np(jseg.variables), device="cpu", **SEG_CFG)
    return jseg, tseg


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-2.0, 2.0, (n,) + HW + (3,)).astype(np.float32)


def test_load_deeplab_consumes_every_leaf():
    from video_unscreen_tpu_torch.utils.checkpoint import read_msgpack
    tree = read_msgpack(WEIGHTS)
    state = load_deeplab(tree)
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) - n_bn == len(jax.tree_util.tree_leaves(tree))
    assert len(jax.tree_util.tree_leaves(tree["params"])) == 185
    model = build_deeplab()
    model.load_state_dict(state)  # strict: every entry of the net is set
    assert sum(p.numel() for p in model.parameters()) == 39_756_962
    extra = copy.deepcopy(tree)
    extra["params"]["aspp"]["Conv_3"] = {
        "kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        build_deeplab().load_state_dict(load_deeplab(extra))
    extra = copy.deepcopy(tree)
    extra["params"]["cls_out"]["lora"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected parameter"):
        load_deeplab(extra)


def test_deeplabv3plus_forward(shipped):
    jseg, tseg = shipped
    x = _inputs(2, 0)
    want = jseg.model.apply(jseg.variables, jnp.asarray(x))
    with torch.no_grad():
        got = tseg.model(tt(x).permute(0, 3, 1, 2))
    _logits_close(got.permute(0, 2, 3, 1), want, "DeepLabV3+ logits")


def test_deeplabv3plus_bf16_against_jax(shipped):
    """The bfloat16 net (convolutions bf16, BatchNorm f32, as flax's
    `dtype=jnp.bfloat16`) against JAX's bfloat16 apply on the same
    variables, at a bound that either net in float32 would miss."""
    jseg, tseg = shipped
    x = _inputs(2, 0)
    japply = {dt: j_build(num_classes=2, dtype=dt).apply
              for dt in (jnp.float32, jnp.bfloat16)}
    want = {dt: np.asarray(f(jseg.variables, jnp.asarray(x)).astype(
        jnp.float32)) for dt, f in japply.items()}
    net16 = convs_to(copy.deepcopy(tseg.model), torch.bfloat16)
    with torch.no_grad():
        got = {dt: m(tt(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
               for dt, m in ((torch.float32, tseg.model),
                             (torch.bfloat16, net16))}
    assert got[torch.bfloat16].dtype == torch.bfloat16
    got = {dt: g.float() for dt, g in got.items()}
    assert_bf16_close(got[torch.bfloat16], want[jnp.bfloat16], 6e-3,
                      [(got[torch.float32], want[jnp.bfloat16]),
                       (got[torch.bfloat16], want[jnp.float32])],
                      "DeepLabV3+ bfloat16 logits")


def test_deeplabv3_forward():
    """Plain DeepLabV3 at seeded weights, BatchNorm statistics and affine
    perturbed so that a swapped mapping would show."""
    jmodel = j_build(num_classes=2, plus=False)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(1)

    def perturb(path, a):
        a = np.array(a, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if path[-1].key in ("mean", "scale"):
            return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, variables)
    model = build_deeplab(num_classes=2, plus=False)
    model.load_state_dict(load_deeplab(tree))
    x = _inputs(1, 2)
    want = jmodel.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(tt(x).permute(0, 3, 1, 2))
    _logits_close(got.permute(0, 2, 3, 1), want, "DeepLabV3 logits")


def test_mobilenet_variant_raises():
    """The MobileNetV2 variant has the V3+ head only: asking for the plain
    V3 head raises, and the V3+ one builds (its logits are held to JAX's
    in tests/test_torch_iseg.py)."""
    with pytest.raises(ValueError, match="V3\\+ head only"):
        build_deeplab(variant="mobilenet", plus=False)
    x = torch.zeros((1, 3, 33, 47))
    with torch.no_grad():
        out = build_deeplab(variant="mobilenet").eval()(x)
    assert out.shape == (1, 2, 33, 47)


def _masks_agree(got, want, score, what):
    """Masks equal wherever the JAX scores decide by more than 1e-3;
    returns the number of pixels closer than that."""
    score = np.asarray(score)
    sure = np.abs(score[..., 1] - score[..., 0]) > 1e-3
    np.testing.assert_array_equal(nn_(got)[sure], np.asarray(want)[sure],
                                  err_msg=what)
    return int((~sure).sum())


def test_seg_agent_scores_and_masks(shipped):
    """`predict_mask_impl` on two frames in one batch against the JAX
    agent frame by frame."""
    jseg, tseg = shipped
    frames, _ = make_clip(n=3)
    x = np.stack([frames[0], frames[2]]).astype(np.float32)
    n_fwd = tseg.forwards
    with torch.no_grad():
        got_score = tseg.predict_scores(tt(x))
        got_mask = tseg.predict_mask_impl(tt(x))
    assert tseg.forwards == n_fwd + 2
    crop_h, crop_w = min(128, HW[0]), min(128, HW[1])
    locs = j_crop_grid(*HW, crop_h, crop_w, 0.5, True)
    assert len(locs) == 2
    unsure = 0
    for i, f in enumerate(x):
        norm = jgeo.imnormalize(jnp.asarray(f))
        want_score = jseg._tta_scores(jseg.variables, norm, locs, crop_h,
                                      crop_w)
        assert_close(got_score[i], want_score, 1e-4, f"scores {i}")
        want_mask = jseg.predict_mask_impl(jseg.variables, jnp.asarray(f))
        unsure += _masks_agree(got_mask[i], want_mask, want_score,
                               f"mask {i}")
    assert got_score.dtype == torch.float32
    print(f"pixels with |p_fg - p_bg| <= 1e-3: {unsure}")


def _with_crop(agent, crop):
    """The agent with another crop size (the net is shared)."""
    out = copy.copy(agent)
    out.crop_h = out.crop_w = crop
    return out


@pytest.mark.parametrize("crop,n_locs", [(64, 12), (48, 30)])
def test_seg_agent_scores_grid(shipped, crop, n_locs):
    """Several overlapping crop locations and their flips (2x3 at crop 64,
    3x5 at crop 48 with the last column clamped), as the shipped 513 crop
    gives at 544x960: `predict_scores`, `predict_mask_impl` and the host
    `forward` against the JAX agent at the same crop size."""
    jseg, tseg = (_with_crop(a, crop) for a in shipped)
    frames, _ = make_clip(n=3)
    x = np.stack([frames[0], frames[2]]).astype(np.float32)
    locs = j_crop_grid(*HW, crop, crop, 0.5, True)
    assert len(locs) == n_locs
    assert len({(h, w) for h, w, _ in locs}) == n_locs // 2
    with torch.no_grad():
        got_score = tseg.predict_scores(tt(x))
        got_mask = tseg.predict_mask_impl(tt(x))
    unsure = 0
    for i, f in enumerate(x):
        norm = jgeo.imnormalize(jnp.asarray(f))
        want_score = jseg._tta_scores(jseg.variables, norm, locs, crop, crop)
        assert_close(got_score[i], want_score, 1e-4, f"scores {i}")
        want_mask = jseg.predict_mask_impl(jseg.variables, jnp.asarray(f))
        unsure += _masks_agree(got_mask[i], want_mask, want_score,
                               f"mask {i}")
    img = frames[1]
    assert tseg.get_target_size(*HW) == jseg.get_target_size(*HW) == HW
    want_score = jseg._tta_scores(
        jseg.variables, jgeo.imnormalize(jnp.asarray(img, jnp.float32)),
        locs, crop, crop)
    unsure += _masks_agree(tseg.forward(img), jseg.forward(img),
                           want_score, "forward mask")
    print(f"pixels with |p_fg - p_bg| <= 1e-3: {unsure}")


def test_seg_agent_forward(shipped):
    """The host entry on a uint8 frame: pad-resized to the 128x128 crop,
    scores resized back."""
    jseg, tseg = shipped
    frames, _ = make_clip(n=2)
    img = frames[1]
    want = jseg.forward(img)
    got = tseg.forward(img)
    assert got.dtype == torch.uint8 and got.shape == HW
    target = jseg.get_target_size(*HW)
    assert target == tseg.get_target_size(*HW) == (128, 128)
    norm = jgeo.imnormalize(jgeo.pad_resize(jnp.asarray(img, jnp.float32),
                                            target))
    score = jseg._tta_scores(jseg.variables, norm,
                             j_crop_grid(*target, 128, 128, 0.5, True),
                             128, 128)
    score = jgeo.inv_pad_resize(score, HW)
    unsure = _masks_agree(got, want, score, "forward mask")
    print(f"pixels with |p_fg - p_bg| <= 1e-3: {unsure}")


def test_green_pipeline_deeplab_seed():
    """The pipeline with the DeepLab seed (the binseg of
    tests/test_fused_green.py's neural-seed test) against the JAX
    pipeline, float32: the seed runs on frame 0 only."""
    cfg = dict(TEST_CFG, binseg=dict(SEG_CFG, type="deeplab",
                                     model_path=WEIGHTS))
    frames, _ = make_clip(n=4)
    jpipe = JPipe(cfg, HW, work_long_side=128, fetch_fg="device",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32)
    tpipe = tfg.FusedGreenPipeline(cfg, HW, work_long_side=128,
                                   matting_dtype=torch.float32,
                                   seg_dtype=torch.float32, device="cpu")
    assert isinstance(tpipe.seg, SegAgent)
    assert tpipe.seg.model.cls_out.weight.dtype == torch.float32
    want = jpipe.run(frames, chunk_size=4)
    got = tpipe.run(frames)
    for name, g, w in zip(("alpha", "fg", "bg"), got, want):
        assert g.shape == w.shape and g.dtype == np.uint8, name
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= 4, f"{name}: max |diff| {d.max()}"
        assert (d > 1).mean() < 1e-3, f"{name}: |diff| > 1 on {(d > 1).mean()}"
    assert (got[0] >= 128).any() and (got[0] < 128).any()
    assert tpipe.seg.forwards == 1 and tpipe.seg.frames == 1
    assert tpipe.step_tracking == [(False,), (True,), (True,), (True,)]
    assert tpipe.stats["seed_steps"] == tpipe.stats["seeded_frames"] == 1
