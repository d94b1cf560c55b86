"""The port's green pipeline end to end against the JAX
`FusedGreenPipeline` (float32 matting and seed, fg computed on the device,
no wire packing) on the JAX suite's synthetic clip. uint8 alphas are held
to the JAX suite's own bound for reassociated float math: max |diff| <= 4
and |diff| > 1 on under 0.1% of pixels (tests/test_fused_green.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_port_util import assert_close, assert_equal, tt
from video_unscreen_tpu.pipeline.fused_green import \
    FusedGreenPipeline as JPipe
from video_unscreen_tpu_torch.pipeline import fused_green as tfg

HW = (96, 128)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipe(TEST_CFG, HW, work_long_side=128, fetch_fg="device",
                  pack_d2h=False, matting_dtype=jnp.float32,
                  seg_dtype=jnp.float32)
    tpipe = tfg.FusedGreenPipeline(TEST_CFG, HW, work_long_side=128,
                                   matting_dtype=torch.float32,
                                   seg_dtype=torch.float32, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def runs(pipes):
    jpipe, tpipe = pipes
    frames, _ = make_clip(n=4)
    return jpipe.run(frames, chunk_size=4), tpipe.run(frames)


def _within_bound(got, want, what):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


def test_alphas_within_bound(runs):
    (ja, _, _), (ta, _, _) = runs
    assert ta.shape == ja.shape == (4,) + HW and ta.dtype == np.uint8
    _within_bound(ta, ja, "alpha")
    assert (ta >= 128).any() and (ta < 128).any()


def test_fg_and_bg_within_bound(runs):
    (_, jf, jb), (_, tf, tb) = runs
    assert tf.shape == jf.shape and tb.shape == jb.shape
    _within_bound(tf, jf, "fg")
    _within_bound(tb, jb, "bg")


def test_run_fused_on_host():
    frames, _ = make_clip(n=2)
    out = tfg.run_fused(TEST_CFG, frames, work_long_side=128, device="cpu")
    assert out["numframes"] == 2 and len(out["alphas"]) == 2
    assert out["alphas"][0].shape == HW and out["fps"] > 0


def _carry_pair(pipes, alpha_pre):
    jpipe, tpipe = pipes
    jc = jpipe.init_carry()._replace(alpha_pre=jnp.asarray(alpha_pre))
    tc = tpipe.init_carry()._replace(alpha_pre=tt(alpha_pre))
    return jc, tc


@pytest.mark.parametrize("shift", [0, 8, 14, 17, 40])
def test_band_tier(pipes, shift):
    jpipe, tpipe = pipes
    _, gts = make_clip(n=1)
    a0 = gts[0].astype(np.float32)
    a1 = np.roll(a0, shift, axis=1)
    assert int(tpipe._band_tier(tt(a0), tt(a1))) == \
        int(jpipe._band_tier(jnp.asarray(a0), jnp.asarray(a1)))


@pytest.mark.parametrize("tier", [1, 2, 3])
def test_widened_band(pipes, tier):
    jpipe, tpipe = pipes
    frames, gts = make_clip(n=1)
    img = frames[0].astype(np.float32)
    mask = gts[0].astype(np.float32)
    # a screen color unlike the frame's: the chroma guard keeps no ring
    # pixel as background, so the widening shows
    bg = np.array([200, 30, 30], np.float32)
    want = jpipe._gen_trimap(jnp.asarray(mask), jnp.asarray(img),
                             jnp.asarray(bg), jnp.asarray(tier))
    got = tpipe._gen_trimap(tt(mask), tt(img), tt(bg), tier)
    assert_equal(got, want)
    assert (np.asarray(want) == 128).sum() > (
        np.asarray(jpipe._gen_trimap(jnp.asarray(mask), jnp.asarray(img),
                                     jnp.asarray(bg), jnp.asarray(0)))
        == 128).sum()


def test_refit_flag(pipes):
    jpipe, tpipe = pipes
    jc, tc = _carry_pair(pipes, np.zeros(HW, np.float32))
    for fid in (0, 1, 30):
        for tracking in (False, True):
            for trained in (False, True):
                j = jc._replace(fid=jnp.asarray(fid, jnp.int32),
                                tracking=jnp.asarray(tracking),
                                cf_state=jc.cf_state._replace(
                                    trained=jnp.asarray(trained)))
                t = tc._replace(fid=torch.tensor(fid, dtype=torch.int32),
                                tracking=torch.tensor(tracking),
                                cf_state=tc.cf_state._replace(
                                    trained=torch.tensor(trained)))
                assert bool(tpipe._cf_refit_flag(t)) == \
                    bool(jpipe._cf_refit_flag(j))


def test_score_map_on_device(pipes):
    jpipe, tpipe = pipes
    assert_close(tpipe.score_map, jpipe.score_map, 0.0)
