"""The person replacement and harmonization in the port against the JAX
package on the CPU.

- `mask_centroid` to 1e-5 of its scale; `_compose` (the bilinear shift
  with zero fill, the 1.2 rescale about the centre, the composite) at
  fractional, negative and out-of-frame shifts to 1e-4 of 255;
- `runtime.bgr_to_gray` equal to cv2's COLOR_BGR2GRAY on uint8, where the
  float `bgr2gray` is not;
- `run` end to end on `tests/test_replace.py`'s on-disk layout, with and
  without `harmonize`: each composite, before its JPEG encode, within the
  JAX suite's bound of JAX's (max |diff| <= 4, > 1 on < 0.1%), and the
  decoded `res_` and `compare_` files max |diff| <= 4 and mean |diff|
  < 0.05 (a JPEG encode turns a 1-level difference in a pixel into small
  changes over its 8x8 block, so the files' share above 1 is not the
  arrays');
- `_lab2bgr`, `device_foreground_toning`, `device_smooth` and the host
  API to 1e-4 of 255 (uint8 outputs within 1 level), and the toning's
  shift clamp."""
import os.path as osp

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_replace import _write_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_close, nn_, tt
from video_unscreen_tpu.agents import harmonization as jharm
from video_unscreen_tpu.ops.color import bgr2lab as j_bgr2lab
from video_unscreen_tpu.pipeline import replace as jrep
from video_unscreen_tpu_torch import runtime
from video_unscreen_tpu_torch.agents import harmonization as tharm
from video_unscreen_tpu_torch.ops.color import bgr2gray
from video_unscreen_tpu_torch.pipeline import replace as trep


def _within_one(got, want, what):
    d = np.abs(nn_(got).astype(np.int64) - nn_(want).astype(np.int64))
    assert d.max() <= 1, f"{what}: max |diff| {d.max()}"


def test_mask_centroid():
    rng = np.random.RandomState(0)
    m = np.zeros((64, 96), np.float32)
    m[10:40, 50:80] = 255.0
    m *= rng.uniform(0.5, 1.0, m.shape).astype(np.float32)
    for mask in (m, np.zeros_like(m)):
        assert_close(trep.mask_centroid(tt(mask)),
                     jrep.mask_centroid(jnp.asarray(mask)), 1e-5)


@pytest.mark.parametrize("shift", [(3.3, -2.7), (-5.25, 4.5),
                                   (150.0, 10.0), (-0.5, -90.2)])
def test_compose_against_jax(shift):
    """Fractional, negative, and beyond the border (everything shifted
    out on one axis)."""
    rng = np.random.RandomState(1)
    h, w = 48, 80
    fg = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    bg = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w, 3), np.float32)
    mask[8:40, 20:60] = 255.0
    mask[8:40, 20:24] = 128.0
    s = np.asarray(shift, np.float32)
    want = jrep._compose(jnp.asarray(fg), jnp.asarray(mask), jnp.asarray(bg),
                         jnp.asarray(s), 1.2)
    got = trep._compose(tt(fg), tt(mask), tt(bg), tt(s), 1.2)
    assert_close(got, want, 1e-4, f"compose {shift}")


def test_gray_helper_is_cv2s():
    """On a million random BGR triples and on gray ones (B = G = R)."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    img[:1, :256] = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(runtime.bgr_to_gray(img), want)
    np.testing.assert_array_equal(want[0, :256], np.arange(256))
    floats = bgr2gray(torch.from_numpy(img).float()).to(torch.uint8).numpy()
    assert (floats != want).any()  # truncation is not cv2's rounding
    with pytest.raises(ValueError):
        runtime.bgr_to_gray(img.astype(np.float32))


@pytest.mark.parametrize("harmonize", [False, True])
def test_run_against_jax(tmp_path, monkeypatch, harmonize):
    args, _ = _write_clip(tmp_path)
    args.harmonize = harmonize
    out, arrays = {}, {"jax": [], "torch": []}
    for mod, name, key in ((jrep, "_compose", "jax"),
                           (trep, "compose_frames", "torch")):
        def spy(*a, _fn=getattr(mod, name), _key=key, **kw):
            res = _fn(*a, **kw)
            arrays[_key].append(np.asarray(res))
            return res
        monkeypatch.setattr(mod, name, spy)
    for name, run in (("jax", jrep.run),
                      ("torch", lambda a: trep.run(a, device="cpu"))):
        args.dst_data_dir = str(tmp_path / f"dst_{name}")
        run(args)
        out[name] = {(k, i): cv2.imread(osp.join(args.dst_data_dir,
                                                 f"{k}_{i:06d}.jpg"))
                     for k in ("res", "compare") for i in range(3)}
    got = arrays["torch"][0]
    for i, want in enumerate(arrays["jax"]):
        d = np.abs(got[i].astype(np.int64) - want.astype(np.uint8))
        assert d.max() <= 4 and (d > 1).mean() < 1e-3, (i, d.max(),
                                                         (d > 1).mean())
    for k, want in out["jax"].items():
        got = out["torch"][k]
        assert got is not None and got.shape == want.shape, k
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 4 and d.mean() < 0.05, (k, d.max(), d.mean())


def test_centroid_offset_against_jax(tmp_path):
    args, _ = _write_clip(tmp_path)
    want = jrep.comp_dx_dy(args.src_data_dir, args.tgt_data_dir, 3)
    got = trep.comp_dx_dy(args.src_data_dir, args.tgt_data_dir, 3,
                          device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] > 10  # the source subject sits right of the target's


def test_lab2bgr_against_jax():
    rng = np.random.RandomState(3)
    bgr = rng.uniform(0, 255, (32, 40, 3)).astype(np.float32)
    lab = np.array(j_bgr2lab(jnp.asarray(bgr)))
    lab[:4] = rng.uniform(0, 255, (4, 40, 3))  # out-of-gamut Lab too
    want = jharm._lab2bgr(jnp.asarray(lab))
    got = tharm._lab2bgr(tt(lab))
    assert_close(got, want, 1e-4, "_lab2bgr")
    assert_close(got[4:], bgr[4:], 1e-3, "round trip")


@pytest.fixture(scope="module")
def agents():
    return jharm.HarmonizationAgent(), tharm.HarmonizationAgent(device="cpu")


def test_device_cores_against_jax(agents):
    jag, tag = agents
    rng = np.random.RandomState(4)
    fg = rng.uniform(60, 220, (48, 64, 3)).astype(np.float32)
    bg = rng.uniform(0, 120, (48, 64, 3)).astype(np.float32)
    alpha = np.zeros((48, 64), np.float32)
    alpha[10:40, 16:50] = 255.0
    want = jag.device_foreground_toning(jnp.asarray(fg), jnp.asarray(bg),
                                        jnp.asarray(alpha))
    got = tag.device_foreground_toning(tt(fg), tt(bg), tt(alpha))
    assert_close(got, want, 1e-4, "foreground toning")
    work = jag.blur_work_hw(48, 64, 32)
    assert tag.blur_work_hw(48, 64, 32) == work
    want = jag.device_smooth(jnp.asarray(bg), 3, 3, tuple(work))
    got = tag.device_smooth(tt(bg), 3, 3, tuple(work))
    assert_close(got, want, 1e-4, "smooth")


def test_host_api_against_jax(agents):
    jag, tag = agents
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    alpha = np.zeros((60, 90), np.uint8)
    alpha[15:50, 20:70] = 255
    for mask in (None, (alpha > 0).astype(np.float32)):
        assert_close(tag.get_means(img, mask), jag.get_means(img, mask),
                     1e-5, "get_means")
    _within_one(tag.foreground_toning(img, img[::-1].copy(), alpha),
                jag.foreground_toning(img, img[::-1].copy(), alpha),
                "foreground_toning")
    _within_one(tag.alpha_smoothing(alpha, target_long_side=45),
                jag.alpha_smoothing(alpha, target_long_side=45),
                "alpha_smoothing")
    _within_one(tag.background_blurring(img), jag.background_blurring(img),
                "background_blurring")


def test_shift_clamp_against_jax(agents):
    """A black fg toned toward a white bg: the unclamped L shift (~127)
    is held at +15 (tests/test_replace.py's case)."""
    jag, tag = agents
    fg = np.zeros((32, 32, 3), np.uint8)
    bg = np.full((32, 32, 3), 255, np.uint8)
    alpha = np.full((32, 32), 255, np.uint8)
    got = tag.foreground_toning(fg, bg, alpha)
    _within_one(got, jag.foreground_toning(fg, bg, alpha), "clamped")
    lab = np.asarray(j_bgr2lab(jnp.asarray(got, jnp.float32)))
    assert lab[..., 0].mean() <= 25.0
