"""The port's video probes and `save_video` (`utils/video.py`,
`utils/fileio.py:save_video`; ISO-BMFF boxes, no cv2) against the JAX
package's (cv2 through FFmpeg).

- On files JAX's `save_video` writes (MPEG-4 Part 2 in MP4) at 25, 30 and
  29.97 fps and odd sizes, on cv2's own MJPEG MP4 and on the port's files,
  the port's `get_frame_count`, `get_frame_size` and `get_duration` equal
  JAX's.
- The port's `save_video` of a directory gives JAX's count, size and fps
  through JAX's probes; its samples are the frames' JPEG bytes (at odd
  sizes, the even crop cv2 writes, encoded at quality 95); cv2's decode of
  it is no further from the frames than cv2's decode of JAX's file.
- A directory like the replacement's (`compare_*.jpg` twice as wide as
  `res_*.jpg`) gives JAX's frame count.
- Another container raises and names itself.
"""
import struct

import cv2
import numpy as np
import pytest

from video_unscreen_tpu.utils import fileio as jfileio
from video_unscreen_tpu.utils import video as jvideo
from video_unscreen_tpu_torch import runtime as rt
from video_unscreen_tpu_torch.utils import fileio, video
from video_unscreen_tpu_torch.utils import (get_frame_count as
                                            exported_count)

CLIPS = [((72, 96), 25.0, 5), ((37, 53), 29.97, 4), ((41, 67), 30.0, 6)]


def _frame(h, w, i):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 3 + i * 20) % 256, (y * 5) % 256,
                     ((x + y) * 2 + i * 7) % 256], -1).astype(np.uint8)


def _probes(mod, path):
    return (mod.get_frame_count(path), tuple(mod.get_frame_size(path)),
            mod.get_duration(path))


def _samples(path):
    """The sample bytes of the file's one track (stsz sizes, one stco
    chunk), read with a box walk of its own."""
    data = open(path, "rb").read()

    def find(start, end, kind):
        at = start
        while at < end:
            size, k = struct.unpack_from(">I4s", data, at)
            if k == kind:
                return at + 8, at + size
            if k in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                got = find(at + 8, at + size, kind)
                if got:
                    return got
            at += size
        return None

    b, _ = find(0, len(data), b"stsz")
    n = struct.unpack_from(">I", data, b + 8)[0]
    sizes = struct.unpack_from(f">{n}I", data, b + 12)
    b, _ = find(0, len(data), b"stco")
    at = struct.unpack_from(">I", data, b + 8)[0]
    out = []
    for s in sizes:
        out.append(data[at:at + s])
        at += s
    return out


@pytest.fixture(scope="module", params=CLIPS,
                ids=lambda c: f"{c[0][0]}x{c[0][1]}@{c[1]}")
def clip(request, tmp_path_factory):
    (h, w), fps, n = request.param
    d = tmp_path_factory.mktemp("frames")
    for i in range(n):
        cv2.imwrite(str(d / f"{i:06d}.jpg"), _frame(h, w, i))
    jax_mp4, port_mp4 = str(d) + "_jax.mp4", str(d) + "_port.mp4"
    jfileio.save_video(str(d), jax_mp4, fps=fps)
    assert fileio.save_video(str(d), port_mp4, fps=fps) == n
    return d, fps, n, jax_mp4, port_mp4


def test_probes_equal_jax_on_jax_files(clip):
    _, fps, n, jax_mp4, _ = clip
    got, want = _probes(video, jax_mp4), _probes(jvideo, jax_mp4)
    assert got[:2] == want[:2] and got[0] == n
    assert got[2] == pytest.approx(want[2], rel=1e-12)
    assert exported_count(jax_mp4) == n


def test_port_file_equals_jax_file_through_jax_probes(clip):
    _, _, _, jax_mp4, port_mp4 = clip
    want = _probes(jvideo, jax_mp4)
    for probes in (jvideo, video):
        got = _probes(probes, port_mp4)
        assert got[:2] == want[:2]
        assert got[2] == pytest.approx(want[2], rel=1e-12)
    cap = cv2.VideoCapture(port_mp4)
    try:
        assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(
            cv2.VideoCapture(jax_mp4).get(cv2.CAP_PROP_FPS), rel=1e-12)
        assert int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little") == \
            b"MJPG"
    finally:
        cap.release()


def test_samples_are_the_frames_jpeg_bytes(clip):
    d, _, n, _, port_mp4 = clip
    paths = sorted(d.glob("*.jpg"))
    samples = _samples(port_mp4)
    assert len(samples) == n
    h, w = rt.probe(str(paths[0]))
    for p, s in zip(paths, samples):
        if (h % 2, w % 2) == (0, 0):
            assert s == p.read_bytes()
        else:  # cv2's even crop, encoded at quality 95
            crop = cv2.imread(str(p))[:h & ~1, :w & ~1]
            assert s == rt.encode_jpeg(np.ascontiguousarray(crop), 95)


def _decoded(path):
    cap = cv2.VideoCapture(path)
    out = []
    try:
        while True:
            ok, fr = cap.read()
            if not ok:
                return out
            out.append(fr)
    finally:
        cap.release()


def test_port_file_decodes_no_further_from_the_frames(clip):
    d, _, n, jax_mp4, port_mp4 = clip
    frames = [cv2.imread(str(p)) for p in sorted(d.glob("*.jpg"))]
    errs = {}
    for name, path in (("jax", jax_mp4), ("port", port_mp4)):
        dec = _decoded(path)
        assert len(dec) == n, name
        errs[name] = np.mean([
            np.abs(g.astype(int) - f[:g.shape[0], :g.shape[1]]).mean()
            for g, f in zip(dec, frames)])
    assert errs["port"] <= errs["jax"], errs


@pytest.mark.parametrize("fps", [25.0, 29.97])
def test_probes_equal_jax_on_cv2_mjpeg(tmp_path, fps):
    """cv2's own MJPEG MP4 (FFmpeg stores it under an mp4v entry)."""
    path = str(tmp_path / "cv2_mjpg.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (53, 37))
    for i in range(7):
        writer.write(_frame(37, 53, i))
    writer.release()
    got, want = _probes(video, path), _probes(jvideo, path)
    assert got[:2] == want[:2] == (7, (36, 52))
    assert got[2] == pytest.approx(want[2], rel=1e-12)


def test_mixed_widths_give_jax_frame_count(tmp_path):
    """The replacement's directory: `compare_*` (2w wide) sorts first, so
    the `res_*` frames (w wide) are left out, as cv2.VideoWriter leaves
    them out of JAX's video."""
    h, w = 48, 64
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"res_{i:06d}.jpg"), _frame(h, w, i))
        cv2.imwrite(str(tmp_path / f"compare_{i:06d}.jpg"),
                    _frame(h, 2 * w, i))
    jax_mp4, port_mp4 = (str(tmp_path / f"{k}.mp4")
                         for k in ("jax", "port"))
    jfileio.save_video(str(tmp_path), jax_mp4)
    assert fileio.save_video(str(tmp_path), port_mp4) == 3
    assert _probes(jvideo, port_mp4)[:2] == _probes(jvideo, jax_mp4)[:2] \
        == (3, (h, 2 * w))
    assert len(_decoded(port_mp4)) == len(_decoded(jax_mp4)) == 3


def test_png_frames_encoded_at_95(tmp_path):
    """A PNG frame goes in encoded at quality 95 (a gray one as BGR)."""
    img = _frame(20, 30, 1)
    fileio.write_png(str(tmp_path / "a.png"), img)
    fileio.write_png(str(tmp_path / "b.png"), img[..., 0])
    path = str(tmp_path / "v.mp4")
    assert fileio.save_video(str(tmp_path), path, fps=30.0) == 2
    gray3 = np.repeat(img[..., :1], 3, axis=2)
    assert _samples(path) == [rt.encode_jpeg(img, 95),
                              rt.encode_jpeg(gray3, 95)]
    assert _probes(jvideo, path)[:2] == (2, (20, 30))


def test_other_containers_raise_by_name(tmp_path):
    avi = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                             (32, 24))
    writer.write(_frame(24, 32, 0))
    writer.release()
    with pytest.raises(ValueError, match="RIFF"):
        video.get_frame_count(avi)
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, _frame(24, 32, 0))
    with pytest.raises(ValueError, match="JPEG image"):
        video.get_frame_size(jpg)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no frames"):
        fileio.save_video(str(empty), str(tmp_path / "empty.mp4"))
