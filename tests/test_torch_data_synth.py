"""The port's cv2-free training and evaluation clips against the JAX
package's.

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
    """`hair_strands` raised while the eval-clip makers were not ported;
    now it draws the JAX package's wisps: the same draws (the generator
    ends in step) and >= 99% of the part map's pixels equal, at the eval
    clips' 4x supersampled size."""
    for seed in range(3):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jds.draw_person(rj, 256, 384, hair_strands=True, phase=0.3)[1]
        got = ds.draw_person(rp, 256, 384, hair_strands=True, phase=0.3)[1]
        assert rj.rand() == rp.rand()
        assert (got == want).mean() >= 0.99


# -- the evaluation clips ----------------------------------------------------
# Bounds against the JAX package's clips (uint8), measured over seeds 0-7
# at 64x96: the natural-background clips are equal but for two_person;
# elsewhere the frames and GTs differ on <= 1% of the pixels (measured
# 0.48%: the hair wisps and cap where cv2 fills a partly clipped polygon
# or an arc, see the module docstring), and the JPEG variant's frames on
# <= 8% (4.3%: a changed pixel moves its 8x8 block's coefficients).
# The resamplers themselves are bit-equal to cv2 (below).
CLIP_FRAC, JPEG_FRAC = 0.01, 0.08


def _differ(a, b):
    a, b = np.stack(a), np.stack(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a != b).mean())


@pytest.mark.parametrize("variant", ds.EVAL_VARIANTS)
@pytest.mark.parametrize("kind", ["green", "natural"])
@pytest.mark.parametrize("seed", [4, 11])
def test_eval_clip_matches_jax(kind, variant, seed):
    fj, gj = jds.make_eval_clip(kind, n=3, h=64, w=96, seed=seed,
                                variant=variant)
    fp, gp = ds.make_eval_clip(kind, n=3, h=64, w=96, seed=seed,
                               variant=variant)
    assert _differ(gp, gj) <= CLIP_FRAC
    assert _differ(fp, fj) <= (JPEG_FRAC if variant == "jpeg" else CLIP_FRAC)


def test_eval_clip_rejects_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        ds.make_eval_clip("green", n=1, h=32, w=32, variant="fog")


@pytest.mark.parametrize("seed", [5, 9])
def test_multishot_clip_matches_jax(seed):
    """The masks equal (the ellipse and cv2's float warp are bit-equal),
    the frames within 1 level on <= 1e-4 of the pixels (the bicubic
    background to float32 rounding)."""
    fj, gj, cj = jds.make_multishot_clip(seed=seed)
    fp, gp, cp = ds.make_multishot_clip(seed=seed)
    assert cp == cj
    assert _differ(gp, gj) == 0.0
    d = np.abs(np.stack(fp).astype(int) - np.stack(fj))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4


def test_nongreen_clip_matches_jax():
    """Equal but for <= 0.1% of the pixels (measured 0.026%: the hair cap's
    arc)."""
    fj, gj, pj = jds.make_nongreen_clip(n=3, seed=2, walk=True)
    fp, gp, pp = ds.make_nongreen_clip(n=3, seed=2, walk=True)
    assert _differ(gp, gj) <= 1e-3 and _differ(fp, fj) <= 1e-3
    assert (np.stack(pp) == np.stack(pj)).mean() >= 0.999


@pytest.mark.parametrize("ss", [2, 4])
def test_area_downsample_matches_cv2(ss):
    x = np.random.RandomState(ss).rand(64, 96, 3).astype(np.float32)
    for a in (x, x[..., 0].copy()):
        want = cv2.resize(a, (96 // ss, 64 // ss),
                          interpolation=cv2.INTER_AREA)
        got = ds._resize_area(a, ss)
        if ss == 4 or a.ndim == 3:
            np.testing.assert_array_equal(got, want)
        else:  # cv2 takes a vector path for 2x2 of one channel
            np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("w", [64, 96, 53])
def test_box_and_gaussian_filters_match_cv2(w):
    """cv2.filter2D's 1 x k box (fused multiply-adds, its scalar tail
    without) bit for bit; GaussianBlur with a sigma bit for bit where the
    width is a multiple of cv2's 8 float lanes, within 2 ulp elsewhere."""
    x = np.random.RandomState(w).rand(40, w, 3).astype(np.float32)
    for k in (3, 7, 25):
        kern = np.full((1, k), 1.0 / k, np.float32)
        for a in (x, x[..., 1].copy()):
            np.testing.assert_array_equal(ds._correlate_rows(a, kern[0]),
                                          cv2.filter2D(a, -1, kern))
    for sigma in (1.0, 64 / 72.0 + 0.5, 3.0):
        want = cv2.GaussianBlur(x[..., 0], (0, 0), sigma)
        got = ds._gaussian_blur_sigma(x[..., 0], sigma)
        if w % 8 == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_float_warp_matches_cv2():
    """cv2's warpAffine translation of a float32 image, bit for bit, also
    where the shift pushes the figure across the border."""
    rng = np.random.RandomState(0)
    base = np.zeros((64, 80), np.float32)
    cv2.ellipse(base, (40, 30), (20, 12), 33, 0, 360, 1.0, -1)
    for src in (base, rng.rand(64, 80).astype(np.float32)):
        for t in range(10):
            tx, ty = float(np.float32(3.37 * t)), float(np.float32(-1.13 * t))
            m = np.float32([[1, 0, tx], [0, 1, ty]])
            np.testing.assert_array_equal(ds._warp_translate(src, tx, ty),
                                          cv2.warpAffine(src, m, (80, 64)))


def test_thin_lines_and_polylines_match_cv2():
    """Thickness 1 (LINE_8, clipped to the image) bit for bit, also off
    the image; thick polylines inside the image bit for bit."""
    rng = np.random.RandomState(1)
    for _ in range(300):
        p1 = (int(rng.randint(-30, 80)), int(rng.randint(-30, 70)))
        p2 = (int(rng.randint(-30, 80)), int(rng.randint(-30, 70)))
        a, b = np.zeros((40, 50), np.int32), np.zeros((40, 50), np.int32)
        cv2.line(a, p1, p2, 3, 1)
        ds._line8(b, p1, p2, 3)
        np.testing.assert_array_equal(a, b)
    for _ in range(200):
        th = int(rng.choice([1, 2, 3, 9]))
        pts = [(int(rng.randint(10, 60)), int(rng.randint(10, 50)))
               for _ in range(rng.randint(2, 5))]
        a, b = np.zeros((60, 70), np.int32), np.zeros((60, 70), np.int32)
        cv2.polylines(a, [np.asarray(pts, np.int32)], False, 7, th)
        ds._polyline(b, pts, 7, th)
        np.testing.assert_array_equal(a, b)


def test_jpeg_roundtrip_matches_cv2():
    rng = np.random.RandomState(2)
    frame = cv2.GaussianBlur(
        rng.randint(0, 256, (48, 64, 3)).astype(np.uint8), (5, 5), 1)
    for q in (40, 47, 59):
        ok, enc = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, q])
        np.testing.assert_array_equal(ds._jpeg_roundtrip(frame, q),
                                      cv2.imdecode(enc, cv2.IMREAD_COLOR))


def test_make_eval_set_torch_writes_the_layout(tmp_path):
    """tools/make_eval_set_torch.py: tools/make_eval_set.py's clips and
    layout (JPEG frames, PNG GTs equal to the clip maker's, the meta
    lists), at a tiny size."""
    import importlib.util
    from pathlib import Path

    from video_unscreen_tpu_torch.utils.fileio import read_png
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_eval_set_torch", root / "tools" / "make_eval_set_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jspec = importlib.util.spec_from_file_location(
        "make_eval_set", root / "tools" / "make_eval_set.py")
    jtool = importlib.util.module_from_spec(jspec)
    jspec.loader.exec_module(jtool)
    assert tool.CLIPS == jtool.CLIPS
    tool.main(["--data_root", str(tmp_path), "--frames", "2", "--height",
               "32", "--width", "48"])
    vids = (tmp_path / "meta" / "vid_list.txt").read_text().split()
    assert vids == [c[0] for c in tool.CLIPS]
    green = (tmp_path / "meta" / "vid_list_green.txt").read_text().split()
    assert green == [c[0] for c in tool.CLIPS if c[1] == "green"]
    vid, kind, seed, variant = tool.CLIPS[0]
    _, gts = ds.make_eval_clip(kind, n=2, h=32, w=48, seed=seed,
                               variant=variant)
    for i in range(2):
        assert (tmp_path / "src_img" / vid / f"frame_{i:06d}.jpg").is_file()
        np.testing.assert_array_equal(read_png(str(
            tmp_path / "alpha_img" / vid / f"frame_{i:06d}.png")), gts[i])
