"""Video probes and the video writer, on ISO-BMFF (MP4, MOV) boxes alone.

Port of `video_unscreen_tpu/utils/video.py` without cv2. The probes read
the first video track of an MP4 or MOV file and answer what cv2 (through
FFmpeg) answers for it:

- `get_frame_count`: the track's sample count (`stsz`);
- `get_frame_size`: (h, w) of its sample entry (`stsd`), else of `tkhd`;
- `get_duration`: the count over the frame rate, which is the media
  timescale (`mdhd`) over the frame duration (`stts`), as FFmpeg's
  average frame rate takes it.

Any other container raises and names itself.

`write_mjpeg_mp4` writes JPEG frames as an MJPEG track of an MP4 in the
layout `cv2.VideoWriter(path, fourcc "MJPG", ...)` writes: an `mp4v`
sample entry whose `esds` has object type 0x6C (JPEG), the frame timing
FFmpeg's muxer chooses for `fps`, and every sample one frame's JPEG
bytes, in one chunk right after the header (so `stco` always fits).
"""

from __future__ import annotations

import math
import struct
from typing import BinaryIO, Dict, Iterable, List, Optional, Tuple

_TOP_LEVEL = {b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
              b"uuid", b"pnot", b"meta", b"pdin", b"moof", b"mfra",
              b"styp", b"sidx"}
# what a file that is not ISO-BMFF starts with
_OTHER_CONTAINERS = ((b"RIFF", "RIFF (AVI or WAV)"),
                     (b"\x1a\x45\xdf\xa3", "Matroska or WebM"),
                     (b"FLV", "FLV"), (b"OggS", "Ogg"),
                     (b"\x00\x00\x01\xba", "MPEG program stream"),
                     (b"\x47", "MPEG transport stream"),
                     (b"\xff\xd8", "a JPEG image, not a video"),
                     (b"\x89PNG", "a PNG image, not a video"))

_MOVIE_TIMESCALE = 1000


def _not_iso_bmff(path: str, head: bytes) -> ValueError:
    name = next((n for magic, n in _OTHER_CONTAINERS
                 if head.startswith(magic)), None)
    what = f"a {name} file" if name else f"a file starting {head[:8]!r}"
    return ValueError(f"{path} is {what}; only MP4 and MOV (ISO-BMFF) "
                      f"videos are read")


def _box_header(f: BinaryIO, end: int) -> Optional[Tuple[bytes, int, int]]:
    """(kind, body start, box end) of the box at f's position, or None at
    `end`."""
    start = f.tell()
    if start + 8 > end:
        return None
    size, kind = struct.unpack(">I4s", f.read(8))
    body = start + 8
    if size == 1:
        size = struct.unpack(">Q", f.read(8))[0]
        body += 8
    elif size == 0:
        size = end - start
    if size < body - start or start + size > end:
        raise ValueError(f"a broken {kind!r} box at byte {start}")
    return kind, body, start + size


def _read_moov(path: str) -> bytes:
    """The body of the file's `moov` box; raises for a file that is not
    ISO-BMFF or has none."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        f.seek(0)
        head = f.read(16)
        f.seek(0)
        if len(head) < 8 or head[4:8] not in _TOP_LEVEL:
            raise _not_iso_bmff(path, head)
        while True:
            try:
                box = _box_header(f, end)
            except (ValueError, struct.error) as e:
                raise ValueError(f"{path}: {e}") from None
            if box is None:
                raise ValueError(f"{path}: an MP4/MOV file with no moov box")
            kind, body, box_end = box
            if kind == b"moov":
                f.seek(body)
                return f.read(box_end - body)
            f.seek(box_end)


def _children(data: bytes, start: int, end: int):
    """(kind, body start, end) of each box in data[start:end]."""
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, at)
        body = at + 8
        if size == 1:
            size = struct.unpack_from(">Q", data, at + 8)[0]
            body += 8
        elif size == 0:
            size = end - at
        if size < body - at or at + size > end:
            raise ValueError(f"a broken {kind!r} box")
        yield kind, body, at + size
        at += size


def _child(data: bytes, start: int, end: int, kind: bytes):
    return next(((b, e) for k, b, e in _children(data, start, end)
                 if k == kind), None)


def _video_track(path: str) -> Dict:
    """count, (h, w) and fps of the first video track of an MP4/MOV."""
    moov = _read_moov(path)
    for kind, tb, te in _children(moov, 0, len(moov)):
        if kind != b"trak":
            continue
        mdia = _child(moov, tb, te, b"mdia")
        hdlr = mdia and _child(moov, *mdia, b"hdlr")
        if not hdlr or moov[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _track_info(path, moov, tb, te, mdia)
    raise ValueError(f"{path}: no video track")


def _track_info(path: str, moov: bytes, tb: int, te: int, mdia) -> Dict:
    mdhd = _child(moov, *mdia, b"mdhd")
    minf = _child(moov, *mdia, b"minf")
    stbl = minf and _child(moov, *minf, b"stbl")
    if not (mdhd and stbl):
        raise ValueError(f"{path}: a video track with no mdhd or stbl")
    at = mdhd[0]
    if moov[at] == 1:   # version 1: 64-bit times
        timescale = struct.unpack_from(">I", moov, at + 20)[0]
    else:
        timescale = struct.unpack_from(">I", moov, at + 12)[0]
    boxes = {k: (b, e) for k, b, e in _children(moov, *stbl)}
    if b"stsz" not in boxes or b"stts" not in boxes:
        raise ValueError(f"{path}: a video track with no stsz or stts")
    count = struct.unpack_from(">I", moov, boxes[b"stsz"][0] + 8)[0]
    n_stts = struct.unpack_from(">I", moov, boxes[b"stts"][0] + 4)[0]
    stts = [struct.unpack_from(">II", moov, boxes[b"stts"][0] + 8 + 8 * i)
            for i in range(n_stts)]
    return {"count": count, "hw": _frame_hw(path, moov, tb, te, boxes),
            "fps": _avg_fps(timescale, stts)}


def _frame_hw(path, moov, tb, te, boxes) -> Tuple[int, int]:
    if b"stsd" in boxes:
        b, e = boxes[b"stsd"]
        entry = next(_children(moov, b + 8, e), None)
        if entry is not None:
            w, h = struct.unpack_from(">HH", moov, entry[1] + 24)
            if w and h:
                return h, w
    tkhd = _child(moov, tb, te, b"tkhd")
    if tkhd is None:
        raise ValueError(f"{path}: a video track with no frame size")
    at = tkhd[0] + (88 if moov[tkhd[0]] == 1 else 76)
    w, h = struct.unpack_from(">II", moov, at)
    return h >> 16, w >> 16


def _avg_fps(timescale: int, stts: List[Tuple[int, int]]) -> float:
    """FFmpeg's average frame rate of a track: timescale over the frame
    duration when every frame has one (the last may differ), else frames
    over the total duration."""
    if not stts or timescale == 0:
        return 0.0
    if len(stts) == 1 or (len(stts) == 2 and stts[1][0] == 1):
        return timescale / stts[0][1] if stts[0][1] else 0.0
    total = sum(n * d for n, d in stts)
    return sum(n for n, _ in stts) * timescale / total if total else 0.0


def get_frame_count(video_path: str) -> int:
    return _video_track(video_path)["count"]


def get_frame_size(video_path: str) -> Tuple[int, int]:
    """(h, w) of the first video track."""
    return _video_track(video_path)["hw"]


def get_duration(video_path: str) -> float:
    """Clip duration in seconds: frame count over frame rate (0 when the
    rate is unknown)."""
    t = _video_track(video_path)
    return float(t["count"] / t["fps"]) if t["fps"] > 0 else 0.0


# ---------------------------------------------------------------- writer
def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                      0x40000000)


def _frame_timing(fps: float) -> Tuple[int, int]:
    """(timescale, frame duration) as cv2 and FFmpeg's MP4 muxer write
    them: cv2 takes fps as rate / base with base a power of 10 such that
    it is within 0.001 of fps; the muxer doubles the reduced rate until it
    reaches 10000 ticks a second."""
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    base, rate = 1, int(fps + 0.5)
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    g = math.gcd(rate, base)
    rate, base = rate // g, base // g
    scale = 1
    while rate * scale < 10000:
        scale *= 2
    return rate * scale, base * scale


def _esds(avg_bitrate: int) -> bytes:
    def descr(tag: int, body: bytes) -> bytes:  # FFmpeg's 4-byte lengths
        n = len(body)
        return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                      0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body
    config = descr(0x04, struct.pack(">BBBHII", 0x6C, 0x11, 0, 0,
                                     avg_bitrate, avg_bitrate))
    es = descr(0x03, struct.pack(">HB", 1, 0) + config + descr(0x06, b"\x02"))
    return _full_box(b"esds", 0, 0, es)


def _moov(sizes: List[int], w: int, h: int, timescale: int, delta: int,
          offset: int) -> bytes:
    n = len(sizes)
    media_dur = n * delta
    movie_dur = (media_dur * _MOVIE_TIMESCALE + timescale // 2) // timescale
    secs = media_dur / timescale if media_dur else 1.0
    bitrate = int(sum(sizes) * 8 / secs)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
        ">IIIIIH10x", 0, 0, _MOVIE_TIMESCALE, movie_dur, 0x10000, 0x100),
        _MATRIX, bytes(24), struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIII8xhhH2x", 0, 0, 1, 0, movie_dur, 0, 0, 0), _MATRIX,
        struct.pack(">II", w << 16, h << 16))
    elst = _box(b"edts", _full_box(b"elst", 0, 0, struct.pack(
        ">IIiI", 1, movie_dur, 0, 0x10000)))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, timescale, media_dur, 0x55C4, 0))
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                     b"VideoHandler\x00")
    entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                 bytes(32), struct.pack(">Hh", 0x18, -1), _esds(bitrate),
                 _box(b"btrt", struct.pack(">III", 0, bitrate, bitrate)))
    stbl = _box(
        b"stbl",
        _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
        _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
        _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                  struct.pack(f">{n}I", *sizes)),
        _full_box(b"stco", 0, 0, struct.pack(">II", 1, offset)))
    minf = _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full_box(b"url ", 0, 1))),
                stbl)
    trak = _box(b"trak", tkhd, elst, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


def write_mjpeg_mp4(path: str, frames: Iterable[bytes], size: Tuple[int, int],
                    fps: float) -> int:
    """Write JPEG frames (bytes each) as an MJPEG MP4 of `size` (w, h) at
    `fps`; returns the frame count. The frames are streamed to the file,
    the index (`moov`) follows them."""
    w, h = size
    timescale, delta = _frame_timing(fps)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isomiso2mp41")
    sizes = []
    with open(path, "wb") as f:
        # a `free` box, then `mdat`: the two become one 64-bit `mdat`
        # header when the frames pass 4 GiB (FFmpeg's layout); the frames,
        # one chunk, start at the same offset either way
        f.write(ftyp + struct.pack(">I4s", 8, b"free"))
        mdat_at = f.tell()
        f.write(struct.pack(">I4s", 8, b"mdat"))
        for data in frames:
            f.write(data)
            sizes.append(len(data))
        total = 8 + sum(sizes)
        end = f.tell()
        if total < 1 << 32:
            f.seek(mdat_at)
            f.write(struct.pack(">I", total))
        else:
            f.seek(mdat_at - 8)
            f.write(struct.pack(">I4sQ", 1, b"mdat", total + 8))
        f.seek(end)
        f.write(_moov(sizes, w, h, timescale, delta, mdat_at + 8))
    return len(sizes)
