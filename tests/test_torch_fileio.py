"""Frames from disk and JPEG artifacts in the port, on the CPU.

- `pipeline/common.py:read_frames` with a `range` equals the JAX
  `read_frames` on a temp dir of JPEGs (the same libjpeg decode); a file
  that is not JPEG raises and names its format.
- `utils/fileio.py`: `save_img` with and without `long_side` (the resize
  is cv2's INTER_LINEAR, bit for bit: the decoded files stay within
  `tests/test_runtime.py`'s bound of the JAX `save_img`'s), gray images as
  one-channel JPEGs, the text lists.
- `config.py:attach_data_section` equals the JAX one; `select_device`
  names no card here; `utils/profiling.py:StageTimer.report` is the JAX
  report.
- `run_fused(save=True, frames=None)` of both fused pipelines and
  `pipeline/bg.py:run(save=True, frames=None)` read the clip from disk and
  write every artifact kind; the decoded alphamasks are within
  `tests/test_run_fused_artifacts.py`'s bound (mean |diff| < 8) of the
  returned alphas.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import TEST_CFG, make_clip
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
    cv2.imwrite(str(src / "frame_000000.png"),
                np.zeros((8, 8, 3), np.uint8))
    cfg = tconfig.attach_data_section({}, "c1", "green", str(tmp_path))
    with pytest.raises(ValueError, match="PNG images are not supported"):
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
    with pytest.raises(ValueError, match="PNG"):
        tfileio.save_img(str(tmp_path / "mask.png"), mask)


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
