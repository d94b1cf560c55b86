"""The port's cv2-free training clips against the JAX package's.

The port draws from the `RandomState` in the JAX package's order, so one
seed gives the same figures; only the rasterization differs, at a
boundary pixel where cv2 clips a segment to the image and at the hair
cap's arc (the port writes cv2's fixed-point drawing in Python but fills
the arc as a convex polygon). So, for a few seeds of `make_clip_batch`
at 128x128 and T 3: the generator ends in the same state, the masks agree
on >= 99% of the pixels of every frame, and the frames agree to 1e-4
except within 2 px of an edge of a mask or of a person's part map (the
part maps are recorded from both packages' `draw_person`). The cv2
resamplers have exact counterparts and are held to cv2 itself."""
import cv2
import numpy as np
import pytest

from video_unscreen_tpu.parallel import data_synth as jds
from video_unscreen_tpu.parallel import train_stm as jts
from video_unscreen_tpu_torch.parallel import data_synth as ds
from video_unscreen_tpu_torch.parallel import train_stm as ts

HW = (128, 128)


def _edges(label, r=2):
    """Pixels within r (Chebyshev) of a change of `label`."""
    e = np.zeros(label.shape, bool)
    dy, dx = label[1:] != label[:-1], label[:, 1:] != label[:, :-1]
    e[1:] |= dy
    e[:-1] |= dy
    e[:, 1:] |= dx
    e[:, :-1] |= dx
    p = np.pad(e, r)
    h, w = label.shape
    return np.any([p[i:i + h, j:j + w] for i in range(2 * r + 1)
                   for j in range(2 * r + 1)], axis=0)


def _recording(monkeypatch, module):
    """Record the part maps `module.draw_person` returns."""
    parts, real = [], module.draw_person

    def wrapped(*args, **kwargs):
        img, p = real(*args, **kwargs)
        parts.append(p)
        return img, p

    monkeypatch.setattr(module, "draw_person", wrapped)
    return parts


def _part_maps(parts, masks, clip_len):
    """{(sample, t): part map shifted as in the clip}: person clips call
    draw_person clip_len times; frame t is the figure rolled by t * dx,
    found as the roll whose foreground is the frame's mask."""
    out, calls = {}, iter(range(0, len(parts), clip_len))
    first = next(calls, None)
    for i in range(masks.shape[0]):
        if first is None or not np.array_equal(parts[first] > 0,
                                               masks[i, 0] > 0.5):
            continue  # a blob clip
        for t in range(clip_len):
            p = parts[first + t]
            rolls = [np.roll(p, s, axis=1) for s in range(-10 * t, 10 * t + 1)]
            hit = [r for r in rolls if np.array_equal(r > 0, masks[i, t] > 0)]
            assert hit, (i, t)
            out[i, t] = hit[0]
        first = next(calls, None)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clip_batch_matches_jax(seed, monkeypatch):
    j_parts = _recording(monkeypatch, jts)
    p_parts = _recording(monkeypatch, ts)
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    want = jts.make_clip_batch(rj, 4, HW, 3)
    got = ts.make_clip_batch(rp, 4, HW, 3)
    assert rj.rand() == rp.rand()           # the generator stayed in step
    assert len(j_parts) == len(p_parts)
    for key in ("frames", "masks"):
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
    agree = (got["masks"] == want["masks"]).mean(axis=(2, 3))
    assert agree.min() >= 0.99, agree
    j_maps = _part_maps(j_parts, want["masks"], 3)
    p_maps = _part_maps(p_parts, got["masks"], 3)
    assert j_maps.keys() == p_maps.keys()
    for i in range(4):
        for t in range(3):
            near = _edges(want["masks"][i, t]) | _edges(got["masks"][i, t])
            if (i, t) in j_maps:
                near |= _edges(j_maps[i, t]) | _edges(p_maps[i, t])
            d = np.abs(got["frames"][i, t] - want["frames"][i, t]).max(-1)
            assert d[~near].max(initial=0) <= 1e-4, (seed, i, t)


def test_pair_batch_layout():
    got = ts.make_pair_batch(np.random.RandomState(5), 2, (64, 64))
    want = jts.make_pair_batch(np.random.RandomState(5), 2, (64, 64))
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key


@pytest.mark.parametrize("h,w,scale", [(128, 128, 8), (128, 128, 21),
                                       (96, 128, 5), (64, 64, 16)])
def test_smooth_noise_matches_cv2(h, w, scale):
    """The bicubic upsample: cv2's INTER_CUBIC to f32 rounding."""
    want = jds._smooth_noise(np.random.RandomState(scale), h, w, scale)
    got = ds._smooth_noise(np.random.RandomState(scale), h, w, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blur_and_translate_match_cv2(k):
    rng = np.random.RandomState(k)
    x = (rng.rand(64, 80) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(ds._gaussian_blur(x, k),
                                  cv2.GaussianBlur(x, (k, k), 0))
    img = rng.rand(64, 80, 3).astype(np.float32)
    for tx, ty in ((3, -5), (-10, 10), (0, 0), (k * 7, -k * 6)):
        m = np.float32([[1, 0, tx], [0, 1, ty]])
        for a in (img, img[..., 0]):
            np.testing.assert_array_equal(ds.translate(a, tx, ty),
                                          cv2.warpAffine(a, m, (80, 64)))


@pytest.mark.parametrize("figure", ["person", "alpha"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_figures_match_jax(seed, figure):
    """`draw_person`'s part map and `_random_alpha`'s mask alone: the same
    draws (the generator ends in step), >= 99% of the pixels equal."""
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    if figure == "person":
        want = jds.draw_person(rj, *HW, phase=0.7)[1]
        got = ds.draw_person(rp, *HW, phase=0.7)[1]
    else:
        want = jds._random_alpha(rj, *HW) > 0.5
        got = ds._random_alpha(rp, *HW) > 0.5
    assert rj.rand() == rp.rand()
    assert (got == want).mean() >= 0.99


def test_filled_circle_matches_cv2():
    a, b = np.zeros((40, 50), np.int32), np.zeros((40, 50), np.int32)
    for c, r in (((10, 12), 7), ((45, 3), 9), ((25, 20), 3)):
        cv2.circle(a, c, r, 5, -1)
        ds._fill_circle(b, c, r, 5)
    np.testing.assert_array_equal(a, b)


def test_hair_strands_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.draw_person(np.random.RandomState(0), 64, 64, hair_strands=True)
