"""Frames from disk and JPEG artifacts in the port, on the CPU.

- `pipeline/common.py:read_frames` with a `range` equals the JAX
  `read_frames` on a temp dir of JPEGs (bit-equal decodes); a file
  that is not JPEG raises and names its format.
- `utils/fileio.py`: `save_img` with and without `long_side` (the resize
  is cv2's INTER_LINEAR, bit for bit: the decoded files stay within
  `tests/test_runtime.py`'s bound of the JAX `save_img`'s), gray images as
  one-channel JPEGs, the text lists; the lossless PNG codec: the port's
  files read back equal through cv2 and cv2's through the port (gray and
  BGR), every row filter type read, `save_img` and `parallel_read_img`
  on `.png` as cv2's IMREAD_COLOR reads; another format raises;
  `save_video` of PNG frames is a video cv2 reads
  (`tests/test_torch_video.py` holds it to the JAX package's).
- `config.py:attach_data_section` equals the JAX one; `select_device`
  names no card here; `utils/profiling.py:StageTimer.report` is the JAX
  report.
- `run_fused(save=True, frames=None)` of both fused pipelines and
  `pipeline/bg.py:run(save=True, frames=None)` read the clip from disk and
  write every artifact kind; the decoded alphamasks are within
  `tests/test_run_fused_artifacts.py`'s bound (mean |diff| < 8) of the
  returned alphas;
  the bg_offline and replacement CLIs from disk, the stage-3 resume from
  the store among them.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import TEST_CFG, make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu import config as jconfig
from video_unscreen_tpu.pipeline import common as jcommon
from video_unscreen_tpu.utils import fileio as jfileio
from video_unscreen_tpu.utils.profiling import StageTimer as JTimer
from video_unscreen_tpu_torch import config as tconfig
from video_unscreen_tpu_torch.pipeline import bg as tbg
from video_unscreen_tpu_torch.pipeline import common as tcommon
from video_unscreen_tpu_torch.pipeline import fused_bg as tfb
from video_unscreen_tpu_torch.pipeline import fused_green as tfg
from video_unscreen_tpu_torch.utils import fileio as tfileio
from video_unscreen_tpu_torch.utils.profiling import StageTimer

N = 4


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A data root with clip `c0`: N green-screen JPEGs of 96x128."""
    root = tmp_path_factory.mktemp("vut_data")
    src = root / "src_img" / "c0"
    src.mkdir(parents=True)
    frames, _ = make_clip(n=N)
    for i, f in enumerate(frames):
        cv2.imwrite(str(src / f"frame_{i:06d}.jpg"), f)
    return str(root)


@pytest.mark.parametrize("frame_range", [None, "1-3"])
def test_read_frames_against_jax(data_root, frame_range):
    cfg = tconfig.attach_data_section({}, "c0", "green", data_root,
                                      frame_range)
    got = tcommon.read_frames(cfg)
    want = jcommon.read_frames(cfg)
    assert len(got) == len(want) == (N if frame_range is None else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_read_frames_refuses_other_formats(tmp_path):
    src = tmp_path / "src_img" / "c1"
    src.mkdir(parents=True)
    cv2.imwrite(str(src / "frame_000000.bmp"),
                np.zeros((8, 8, 3), np.uint8))
    cfg = tconfig.attach_data_section({}, "c1", "green", str(tmp_path))
    with pytest.raises(ValueError, match="BMP images are not supported"):
        tcommon.read_frames(cfg)
    cfg["data"]["src_img_tmpl"] = "*.jpg"
    with pytest.raises(FileNotFoundError, match="no frames matching"):
        tcommon.read_frames(cfg)


@pytest.mark.parametrize("long_side", [-1, 64, 300])
def test_save_img_against_jax(tmp_path, long_side):
    frames, _ = make_clip(n=1)
    img = frames[0]
    got, want = str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg")
    tfileio.save_img(got, img, long_side=long_side)
    jfileio.save_img(want, img, long_side=long_side)
    g, w = cv2.imread(got), cv2.imread(want)
    assert g.shape == w.shape == ((48, 64, 3) if long_side == 64
                                  else img.shape)
    assert np.abs(g.astype(int) - w.astype(int)).mean() < 2.0


def test_save_img_gray_and_refuses_other_formats(tmp_path):
    mask = np.zeros((40, 60), np.uint8)
    mask[10:30, 20:40] = 255
    path = str(tmp_path / "sub" / "mask.jpg")
    tfileio.save_img(path, mask)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.shape == (40, 60)
    assert np.abs(back.astype(int) - mask.astype(int)).mean() < 8.0
    with pytest.raises(ValueError, match="TIF"):
        tfileio.save_img(str(tmp_path / "mask.tif"), mask)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (96, 128, 3)])
def test_png_round_trip_with_cv2(tmp_path, shape):
    """The port's PNG read back by cv2 bit for bit, and cv2's (which
    filters its rows) read back by the port; noise and smooth ramps."""
    rng = np.random.RandomState(len(shape))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    ramp = ((3 * yy + 5 * xx) % 256).astype(np.uint8)
    if len(shape) == 3:
        ramp = np.stack([ramp, ramp // 2, 255 - ramp], -1)
    for img in (rng.randint(0, 256, shape).astype(np.uint8), ramp):
        ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "c.png")
        tfileio.write_png(ours, img)
        np.testing.assert_array_equal(
            cv2.imread(ours, cv2.IMREAD_UNCHANGED), img)
        cv2.imwrite(theirs, img)
        np.testing.assert_array_equal(tfileio.read_png(theirs), img)


def _png_with_filters(img, filters):
    """A PNG of `img` (gray or BGR uint8) whose row y uses filter type
    filters[y % len(filters)], filtered by the PNG rules (a test-side
    encoder independent of the reader)."""
    import struct
    import zlib
    rows = img[..., ::-1] if img.ndim == 3 else img
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    data = rows.reshape(h, -1).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ft, cur = filters[y % len(filters)], data[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(ft)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    hdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3)])
def test_png_reads_every_filter_type(tmp_path, shape):
    img = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, (0, 1, 2, 3, 4)))
    np.testing.assert_array_equal(cv2.imread(str(path),
                                             cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(tfileio.read_png(str(path)), img)


def test_png_through_save_img_and_parallel_read_img(tmp_path):
    """`.png` paths: written losslessly, read as cv2.IMREAD_COLOR reads
    (a gray PNG as three equal channels); `save_video` of the two PNGs
    is a 2-frame video that cv2 reads at their size."""
    rng = np.random.RandomState(8)
    gray = rng.randint(0, 256, (20, 30)).astype(np.uint8)
    bgr = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    paths = [str(tmp_path / "sub" / n) for n in ("g.png", "c.png")]
    tfileio.save_img(paths[0], gray)
    tfileio.save_img(paths[1], bgr)
    got = tfileio.parallel_read_img(paths)
    for g, p in zip(got, paths):
        np.testing.assert_array_equal(g, cv2.imread(p, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(got[1], bgr)
    video = str(tmp_path / "v.mp4")
    assert tfileio.save_video(str(tmp_path / "sub"), video) == 2
    cap = cv2.VideoCapture(video)
    try:
        assert (cap.get(cv2.CAP_PROP_FRAME_COUNT),
                cap.get(cv2.CAP_PROP_FRAME_HEIGHT),
                cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == (2, 20, 30)
    finally:
        cap.release()


def test_txt_lists(tmp_path):
    path = str(tmp_path / "list.txt")
    tfileio.write_txt_list(path, ["a", "b c", "d"])
    assert tfileio.read_txt_list(path) == jfileio.read_txt_list(path) == [
        "a", "b c", "d"]


@pytest.mark.parametrize("kw", [
    dict(video_id="v1", mode="green"),
    dict(video_id="v2", mode="bg", data_root="/data/x", frame_range="3-9",
         src_tmpl="*.jpg")])
def test_attach_data_section_against_jax(kw, monkeypatch):
    monkeypatch.setenv("UNSCREEN_DATA_ROOT", "/env/root")
    cfg = {"fg_exist_thr": 0.01}
    got = tconfig.attach_data_section(cfg, **kw)
    assert got == jconfig.attach_data_section(cfg, **kw)
    assert "data" not in cfg
    assert tconfig.default_data_root() == "/env/root"


def test_select_device_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("UNSCREEN_DEVICE_ID", "0")
    assert tconfig.select_device() is None
    monkeypatch.setenv("UNSCREEN_DEVICE_ID", "x")
    assert tconfig.select_device() is None


def test_stage_timer_report_is_jax_format():
    got, want = StageTimer(), JTimer()
    for t in (got, want):
        t.add("dispatch", 0.5)
        t.add("fetch", 0.25)
        with t.stage("reconstruct"):
            pass
    got.times["reconstruct"] = want.times["reconstruct"] = 0.125
    assert got.report(numframes=4) == want.report(numframes=4)
    assert dict(got.counts) == dict(want.counts)


def _kinds(dst):
    return {k: sorted(glob.glob(os.path.join(dst, f"{k}_*.jpg")))
            for k in ("alphamask", "segmask", "fg", "bg")}


def _check_alphamasks(paths, alphas):
    assert len(paths) == len(alphas)
    for p, a in zip(paths, alphas):
        back = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        assert back.shape == a.shape
        assert np.abs(back.astype(int) - a.astype(int)).mean() < 8.0


@pytest.mark.parametrize("mode", ["green", "bg"])
def test_run_fused_from_disk_writes_artifacts(data_root, mode):
    base = TEST_CFG if mode == "green" else BG_TEST_CFG
    cfg = tconfig.attach_data_section(base, "c0", f"fused_{mode}", data_root)
    run = tfg.run_fused if mode == "green" else tfb.run_fused
    out = run(cfg, save=True, chunk_size=2, work_long_side=128,
              segments=2, wire="yuv420", device="cpu")
    assert out["numframes"] == N
    kinds = _kinds(cfg["data"]["dst_img_dir"])
    want = ("alphamask", "fg", "bg") + (("segmask",) if mode == "bg" else ())
    for k in want:
        assert len(kinds[k]) == N, (k, kinds[k])
        assert cv2.imread(kinds[k][0]).shape == (96, 128, 3)
    assert kinds["segmask"] == [] or mode == "bg"
    _check_alphamasks(kinds["alphamask"], out["alphas"])


def test_bg_run_from_disk_writes_artifacts(data_root):
    cfg = tconfig.attach_data_section(BG_TEST_CFG, "c0", "bg", data_root,
                                      "0-2")
    out = tbg.run(cfg, save=True, device="cpu")
    assert out["numframes"] == 2
    kinds = _kinds(cfg["data"]["dst_img_dir"])
    for k in ("segmask", "bg", "alphamask", "fg"):
        assert len(kinds[k]) == 2, (k, kinds[k])
    assert cv2.imread(kinds["segmask"][0], cv2.IMREAD_UNCHANGED).ndim == 2
    _check_alphamasks(kinds["alphamask"], out["alphas"])


def _cli(rel):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(
            os.path.dirname(os.path.dirname(__file__)), rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bg_offline_and_replace_clis_from_disk(data_root, tmp_path,
                                              monkeypatch):
    """`tools/unscreen/bg_offline_torch.py` (stages 1,2,3, then stage 3
    alone from the store) and `tools/replace/replace_torch.py` on that
    store, with and without `--harmonize`, through their `main`: every
    artifact written, the PNG pair lossless as cv2 reads it, the resumed
    alphas within mean 8 of the first run's (the store's segmasks and
    backgrounds went through JPEG). The CLI, as JAX's, has no work-size
    flag: the test runs `run` at the clip's own size (long side 128)."""
    import functools
    import json
    import shutil
    from video_unscreen_tpu_torch.pipeline import bg_offline
    monkeypatch.setattr(bg_offline, "run", functools.partial(
        bg_offline.run, work_long_side=128))
    cfg_path = tmp_path / "bg.json"
    cfg_path.write_text(json.dumps(BG_TEST_CFG))
    offline = _cli("tools/unscreen/bg_offline_torch.py")
    args = ["--cfg", str(cfg_path), "-vid", "c0", "--data_root", data_root,
            "--device", "cpu", "--chunk", "2"]
    first = offline.main(args)
    resumed = offline.main(args + ["--stages", "3"])
    store = os.path.join(data_root, "test_bg_step_img", "c0")
    for k, paths in _kinds(store).items():
        assert len(paths) == N, (k, paths)
    for name in ("always_bg.jpg", "ema_bg.png", "ema_seen.png"):
        assert os.path.isfile(os.path.join(store, name)), name
    np.testing.assert_array_equal(
        cv2.imread(os.path.join(store, "ema_seen.png"), cv2.IMREAD_UNCHANGED),
        first["ema"][1])
    assert resumed["stage2_cg_iters"] is None and len(resumed["alphas"]) == N
    for a, b in zip(resumed["alphas"], first["alphas"]):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.mean() < 8.0, d.mean()
    rep = tmp_path / "rep"
    dirs = [rep / "unscreenbg_img" / "out5", rep / "unscreen_img" / "test5",
            rep / "unscreen_img" / "bg"]
    for d in dirs:
        d.mkdir(parents=True)
    for name in os.listdir(store):
        if name.startswith(("alphamask_", "fg_")):
            shutil.copy(os.path.join(store, name), dirs[0] / name)
        if name.startswith("alphamask_"):
            shutil.copy(os.path.join(store, name), dirs[1] / name)
    shutil.copy(os.path.join(store, "always_bg.jpg"), dirs[2] / "bg_case.jpg")
    replace = _cli("tools/replace/replace_torch.py")
    for extra in ([], ["--harmonize"]):
        replace.main(["--data_root", str(rep), "--device", "cpu"] + extra)
        out = rep / "merge_test_img" / "test5_out5"
        for kind in ("res", "compare"):
            assert len(list(out.glob(f"{kind}_*.jpg"))) == N, (extra, kind)
        assert cv2.imread(str(out / "compare_000000.jpg")).shape == (
            96, 256, 3)
