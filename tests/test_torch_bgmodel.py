"""The background model and the morphology helpers it uses, in the port
against the JAX package on the CPU.

- `BackgroundAgent.forward` with each method on `tests/test_agents.py`'s
  green-screen frame, at its own size and from twice its size (resized to
  long side 128 and back): the uint8 backgrounds within 1 level (the CG
  and the box-filter loop reassociate float sums; JAX's `mean` runs op by
  op, which compiles in seconds where its jitted program takes minutes,
  to the same bits, as the `slow` test
  `test_mean_reference_op_by_op_is_the_jitted_program` checks); `pcov`'s
  iteration count equal to that of JAX's `lax.while_loop` (run here with
  a counter); the two early exits (no background: float zeros; no
  foreground: the frame itself) and the unknown method, as JAX's.
- `box_filter` against JAX to 1e-5 of its scale and against
  `cv2.boxFilter` to 1e-4; `morph_open`, `morph_close` and
  `get_outer_boundary` bit-exact; the K1/K2 dispatch refuses a
  channels-last (H, W, 3) mask on either device."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_agents import make_greenscreen
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, assert_equal, soft_mask, tt
from video_unscreen_tpu.agents.bgmodel import BackgroundAgent as JAgent
from video_unscreen_tpu.ops import morphology as jmorph
from video_unscreen_tpu.ops.geometry import (get_target_size,
                                             resize as j_resize)
from video_unscreen_tpu_torch.agents.bgmodel import BackgroundAgent
from video_unscreen_tpu_torch.ops import morphology as tmorph
from video_unscreen_tpu_torch.ops.kernels import morph as km


def _within_one(got, want, what):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    assert d.max() <= 1, f"{what}: max |diff| {d.max()}"


def _jax_pcov_iters(agent, img, mask):
    """The iterations of JAX's `device_pcov` loop: its cond and body with
    a counter, on the same resized inputs."""
    h, w = mask.shape
    th, tw = get_target_size(h, w, agent.input_long_side)
    img_d = j_resize(jnp.asarray(img, jnp.float32), (th, tw))
    mask_d = j_resize(jnp.asarray(mask, jnp.float32), (th, tw))
    dmask = jmorph.dilate(mask_d, agent.dilation_ksize, agent.dilation_iters)
    hole = dmask > 0
    bg = jnp.where(hole[..., None], 0.0, img_d)
    count = (~hole).astype(jnp.float32)

    def cond(state):
        _, count, it = state
        return (count.sum() < float(th * tw)) & (it < 100)

    def body(state):
        bg, count, it = state
        bg_f = jmorph.box_filter(bg, agent.pcov_ksize)
        cnt_f = jmorph.box_filter(count, agent.pcov_ksize)
        filled = cnt_f > 0
        bg = jnp.where(filled[..., None],
                       jnp.clip(bg_f / jnp.maximum(cnt_f, 1e-6)[..., None],
                                0, 255), bg)
        return bg, filled.astype(jnp.float32), it + 1

    return int(jax.lax.while_loop(cond, body, (bg, count, 0))[2])


@pytest.fixture(scope="module")
def jax_agent():
    """One JAX agent for the file: its jitted methods are keyed on the
    agent, and both frame sizes work at 96x128, so each method compiles
    once."""
    return JAgent(input_long_side=128)


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("method", ["mean", "rf", "pcov"])
def test_background_agent_against_jax(jax_agent, method, scale):
    img, gt = make_greenscreen(h=96 * scale, w=128 * scale, noise=2)
    jag = jax_agent
    tag = BackgroundAgent(input_long_side=128, device="cpu")
    if method == "mean":
        # op by op: XLA's CPU fusion pass takes minutes on the jitted
        # `device_mean` (the 7x7 ellipse chain of 10 iterations feeds two
        # reductions), op by op seconds; at both sizes the values are the
        # jitted program's bit for bit
        with jax.disable_jit():
            want = jag.forward(img, gt, method=method)
    else:
        want = jag.forward(img, gt, method=method)
    got = tag.forward(img, gt, method=method)
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    _within_one(got, want, method)
    if method == "pcov":
        assert tag.pcov_iters == _jax_pcov_iters(jag, img, gt) > 1
    hole = gt > 0
    err = np.abs(got[hole].astype(float) - np.array([40, 190, 50])).mean()
    assert err < 40, err


@pytest.mark.slow
@pytest.mark.parametrize("scale", [1, 2])
def test_mean_reference_op_by_op_is_the_jitted_program(jax_agent, scale):
    """The op-by-op `mean` reference of `test_background_agent_against_jax`
    has the bytes of the jitted `device_mean` that users run, at both
    sizes. Slow: XLA takes many minutes to compile the jitted program on
    a cold cache."""
    img, gt = make_greenscreen(h=96 * scale, w=128 * scale, noise=2)
    want = jax_agent.forward(img, gt, method="mean")
    with jax.disable_jit():
        got = jax_agent.forward(img, gt, method="mean")
    assert_equal(got, want)


def test_background_agent_exits_against_jax():
    img, _ = make_greenscreen()
    jag, tag = JAgent(input_long_side=128), BackgroundAgent(
        input_long_side=128, device="cpu")
    for mask in (np.full(img.shape[:2], 255, np.uint8),
                 np.zeros(img.shape[:2], np.uint8)):
        want = jag.forward(img, mask, method="nope")
        got = tag.forward(img, mask, method="nope")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert_equal(got, want)
    _, gt = make_greenscreen()
    for agent in (jag, tag):
        with pytest.raises(NameError, match="nope"):
            agent.forward(img, gt, method="nope")


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("shape", [(40, 56, 3), (33, 47)])
def test_box_filter_against_jax_and_cv2(ksize, shape):
    img = np.random.RandomState(ksize).uniform(0, 255, shape).astype(
        np.float32)
    got = tmorph.box_filter(tt(img), ksize)
    assert_close(got, jmorph.box_filter(jnp.asarray(img), ksize), 1e-5,
                 "against JAX")
    assert_close(got, cv2.boxFilter(img, -1, (ksize, ksize)), 1e-4,
                 "against cv2")


@pytest.mark.parametrize("k,iters", [(5, 1), (3, 2), (7, 3)])
def test_open_close_boundary_bit_exact(k, iters):
    m = soft_mask(48, 64, seed=k)
    for name in ("morph_open", "morph_close", "get_outer_boundary"):
        want = getattr(jmorph, name)(jnp.asarray(m), k, iters)
        assert_equal(getattr(tmorph, name)(tt(m), k, iters), want, name)


def test_dispatch_refuses_channels_last():
    """A 3-channel (H, W, 3) mask would read as H planes of W x 3: K1 and
    K2 refuse it; as (3, H, W) planes it is each channel's own."""
    m = np.stack([soft_mask(24, 32, seed=s) for s in range(3)], -1)
    offs = tmorph.ellipse_offsets(3)
    for fn in (lambda x: km.morph(x, offs, 2, True),
               lambda x: km.trimap(x, offs, 2),
               lambda x: tmorph.dilate(x, 3, 2)):
        with pytest.raises(ValueError, match="channels"):
            fn(tt(m))
    planes = tmorph.dilate(tt(m).permute(2, 0, 1).contiguous(), 3, 2)
    want = jmorph.dilate(jnp.asarray(m), 3, 2)  # per channel in JAX
    assert_equal(planes.permute(1, 2, 0), want)
