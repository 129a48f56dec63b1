"""ISO base media files (``.mp4``, ``.m4v``, ``.mov``): the port's demuxer
and muxer, without OpenCV or FFmpeg.

The JAX package writes its clips with ``cv2.VideoWriter(mp4v)``
(``lameness_tpu/video/decode.py``), whose muxer lays a file out as
``ftyp``, ``free``, ``mdat`` and then ``moov`` with one video track.

- ``Mp4Reader`` reads the first video track: ``mvhd``, the track's
  ``tkhd`` and ``mdhd`` (its timescale), and in ``stbl`` the sample
  description (``stsd``: the codec's four-character code, and for ``mp4v``
  the ``esds`` decoder configuration, which holds the VOL header), the
  timing (``stts``), the chunking (``stsc``, ``stco`` or ``co64``), the
  sizes (``stsz``) and the sync samples (``stss``; without it every sample
  is one).  ``sample(i)`` reads one sample's bytes.  The frame rate is the
  sample count over the ``stts`` duration in timescale units, as FFmpeg's
  demuxer reports it to OpenCV.
- ``Mp4Writer`` writes the same layout as cv2's muxer (``stss`` only when
  some sample is not a sync sample; ``co64`` once an offset passes 2^32).

Every box is checked against its parent and the file: a box that runs
past its parent, a table whose entry count does not fit its size, and a
sample past the end of the file raise :class:`Mp4Error`, before anything
is read out of bounds.
"""
from __future__ import annotations

import fractions
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

# the object type of MPEG-4 Visual in an esds (ISO/IEC 14496-1 Table 5)
MPEG4_VISUAL = 0x20
CONTAINERS = (".mp4", ".m4v", ".mov")


class Mp4Error(ValueError):
    """A file the demuxer cannot read; the message names it."""


@dataclass
class Track:
    """The first video track of a file."""
    codec: str                # the sample entry's four-character code
    width: int
    height: int
    timescale: int
    duration: int             # in timescale units (the stts total)
    offsets: np.ndarray       # int64 per sample
    sizes: np.ndarray         # int64 per sample
    sync: np.ndarray          # bool per sample
    config: bytes = b""       # mp4v: the DecoderSpecificInfo
    object_type: int = 0      # mp4v: the esds objectTypeIndication

    @property
    def count(self) -> int:
        return len(self.sizes)

    @property
    def fps(self) -> float:
        return (self.timescale * self.count / self.duration
                if self.duration > 0 else 0.0)


def _boxes(data: bytes, start: int, end: int, name: str):
    """(type, payload start, payload end) of each box in data[start:end]."""
    at = start
    while at < end:
        if end - at < 8:
            raise Mp4Error(f"{name}: a box header runs past its parent")
        size, kind = struct.unpack_from(">I4s", data, at)
        head = 8
        if size == 1:
            if end - at < 16:
                raise Mp4Error(f"{name}: a box header runs past its parent")
            size, = struct.unpack_from(">Q", data, at + 8)
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise Mp4Error(f"{name}: box {kind!r} at {at} ({size} bytes) "
                           f"runs past its parent")
        yield kind, at + head, at + size
        at += size


def _child(data: bytes, start: int, end: int, kind: bytes, name: str
           ) -> Optional[Tuple[int, int]]:
    for k, s, e in _boxes(data, start, end, name):
        if k == kind:
            return s, e
    return None


def _need(data: bytes, start: int, end: int, kind: bytes, name: str
          ) -> Tuple[int, int]:
    found = _child(data, start, end, kind, name)
    if found is None:
        raise Mp4Error(f"{name}: no {kind.decode()} box")
    return found


def _table(data: bytes, start: int, end: int, fmt: str, head: int,
           name: str, box: str) -> np.ndarray:
    """A full box's entry table: ``head`` bytes after the version/flags,
    then a big-endian u32 count and count entries of ``fmt``."""
    if end - start < 8 + head:
        raise Mp4Error(f"{name}: {box} is too short")
    count, = struct.unpack_from(">I", data, start + 4 + head)
    width = struct.calcsize(">" + fmt)
    body = start + 8 + head
    if count * width > end - body:
        raise Mp4Error(f"{name}: {box} claims {count} entries, its size "
                       f"holds {(end - body) // width}")
    dt = np.dtype([(f"f{i}", ">" + c) for i, c in enumerate(fmt)])
    return np.frombuffer(data, dt, count, body)


def _descriptor(data: bytes, at: int, end: int, name: str
                ) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    if at >= end:
        raise Mp4Error(f"{name}: esds ends inside a descriptor")
    tag, at, size = data[at], at + 1, 0
    for _ in range(4):
        if at >= end:
            raise Mp4Error(f"{name}: esds ends inside a descriptor")
        b = data[at]
        at += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    if at + size > end:
        raise Mp4Error(f"{name}: an esds descriptor runs past its box")
    return tag, at, at + size


def parse_esds(data: bytes, start: int, end: int, name: str
               ) -> Tuple[int, bytes]:
    """An esds box's payload -> (objectTypeIndication, DecoderSpecificInfo)."""
    tag, s, e = _descriptor(data, start + 4, end, name)
    if tag != 0x03 or e - s < 3:
        raise Mp4Error(f"{name}: esds holds no ES descriptor")
    flags = data[s + 2]
    at = s + 3
    if flags & 0x80:
        at += 2
    if flags & 0x40:
        if at >= e:
            raise Mp4Error(f"{name}: esds ends inside its URL")
        at += 1 + data[at]
    if flags & 0x20:
        at += 2
    tag, s, e = _descriptor(data, at, e, name)
    if tag != 0x04 or e - s < 13:
        raise Mp4Error(f"{name}: esds holds no decoder configuration")
    object_type = data[s]
    config = b""
    at = s + 13
    while at < e:
        tag, ds, de = _descriptor(data, at, e, name)
        if tag == 0x05:
            config = bytes(data[ds:de])
            break
        at = de
    return object_type, config


def _video_track(data: bytes, moov: Tuple[int, int], name: str
                 ) -> Tuple[int, int]:
    for kind, s, e in _boxes(data, *moov, name):
        if kind != b"trak":
            continue
        mdia = _child(data, s, e, b"mdia", name)
        if mdia is None:
            continue
        hdlr = _child(data, *mdia, b"hdlr", name)
        if hdlr and hdlr[1] - hdlr[0] >= 12 \
                and data[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
            return s, e
    raise Mp4Error(f"{name}: no video track")


def parse_moov(data: bytes, moov: Tuple[int, int], name: str,
               file_size: Optional[int] = None) -> Track:
    """The first video track of a ``moov`` box's payload (``file_size``
    bounds the sample count a uniform ``stsz`` may claim)."""
    trak = _video_track(data, moov, name)
    mdia = _need(data, *trak, b"mdia", name)
    mdhd = _need(data, *mdia, b"mdhd", name)
    version = data[mdhd[0]] if mdhd[1] > mdhd[0] else 0
    need = 32 if version == 1 else 20
    if mdhd[1] - mdhd[0] < need:
        raise Mp4Error(f"{name}: mdhd is too short")
    timescale, = struct.unpack_from(">I", data, mdhd[0]
                                    + (20 if version == 1 else 12))
    minf = _need(data, *mdia, b"minf", name)
    stbl = _need(data, *minf, b"stbl", name)

    stsd = _need(data, *stbl, b"stsd", name)
    entries = list(_boxes(data, stsd[0] + 8, stsd[1], name))
    if not entries:
        raise Mp4Error(f"{name}: stsd has no sample description")
    kind, s, e = entries[0]
    codec = kind.decode("latin-1")
    if e - s < 78:
        raise Mp4Error(f"{name}: the {codec} sample entry is too short")
    width, height = struct.unpack_from(">HH", data, s + 24)
    object_type, config = 0, b""
    if kind == b"mp4v":
        esds = _child(data, s + 78, e, b"esds", name)
        if esds is None:
            raise Mp4Error(f"{name}: an mp4v sample entry without esds")
        object_type, config = parse_esds(data, *esds, name)

    stts = _table(data, *_need(data, *stbl, b"stts", name), "II", 0, name,
                  "stts")
    counts = stts["f0"].astype(np.int64)
    duration = int((counts * stts["f1"].astype(np.int64)).sum())
    stsz_at = _need(data, *stbl, b"stsz", name)
    if stsz_at[1] - stsz_at[0] < 12:
        raise Mp4Error(f"{name}: stsz is too short")
    uniform, n = struct.unpack_from(">II", data, stsz_at[0] + 4)
    if uniform:
        if file_size is not None and n * uniform > file_size:
            raise Mp4Error(f"{name}: stsz claims {n} samples of {uniform} "
                           f"bytes, more than the file holds")
        sizes = np.full(n, uniform, np.int64)
    else:
        sizes = _table(data, *stsz_at, "I", 4, name, "stsz")["f0"].astype(
            np.int64)
    stsc = _table(data, *_need(data, *stbl, b"stsc", name), "III", 0, name,
                  "stsc")
    co = _child(data, *stbl, b"stco", name)
    if co is not None:
        chunks = _table(data, *co, "I", 0, name, "stco")["f0"]
    else:
        co = _child(data, *stbl, b"co64", name)
        if co is None:
            raise Mp4Error(f"{name}: no stco or co64 box")
        chunks = _table(data, *co, "Q", 0, name, "co64")["f0"]
    offsets = _sample_offsets(stsc, chunks.astype(np.int64), sizes, name)
    stss = _child(data, *stbl, b"stss", name)
    if stss is None:
        sync = np.ones(len(sizes), bool)
    else:
        idx = _table(data, *stss, "I", 0, name, "stss")["f0"].astype(np.int64)
        if len(idx) and (idx.min() < 1 or idx.max() > len(sizes)):
            raise Mp4Error(f"{name}: stss names a sample the track lacks")
        sync = np.zeros(len(sizes), bool)
        sync[idx - 1] = True
    return Track(codec=codec, width=width, height=height,
                 timescale=timescale, duration=duration, offsets=offsets,
                 sizes=sizes, sync=sync, config=config,
                 object_type=object_type)


def _sample_offsets(stsc: np.ndarray, chunks: np.ndarray, sizes: np.ndarray,
                    name: str) -> np.ndarray:
    """Each sample's file offset from the chunk table and the sample-to-
    chunk runs."""
    first = stsc["f0"].astype(np.int64)
    per = stsc["f1"].astype(np.int64)
    nchunk = len(chunks)
    if len(first) and (first[0] != 1 or np.any(np.diff(first) <= 0)
                       or first[-1] > max(nchunk, 1)):
        raise Mp4Error(f"{name}: stsc's runs are out of order")
    if len(per) and per.max() > len(sizes):
        raise Mp4Error(f"{name}: stsc puts more samples in a chunk than "
                       f"stsz lists")
    per_chunk = np.zeros(nchunk, np.int64)
    for i in range(len(first)):
        stop = first[i + 1] - 1 if i + 1 < len(first) else nchunk
        per_chunk[first[i] - 1:stop] = per[i]
    if per_chunk.sum() < len(sizes):
        raise Mp4Error(f"{name}: the chunks hold {per_chunk.sum()} samples, "
                       f"stsz lists {len(sizes)}")
    chunk_of = np.repeat(np.arange(nchunk), per_chunk)[:len(sizes)]
    starts = np.concatenate([[0], np.cumsum(per_chunk)[:-1]])
    ends = np.cumsum(sizes)
    within = ends - sizes - np.concatenate([[0], ends])[starts[chunk_of]]
    return chunks[chunk_of] + within


class Mp4Reader:
    """The first video track of an ISO base media file: ``track`` and
    ``sample(i)``, ``close`` and the context manager."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.name = self.path.name
        self.file: BinaryIO = open(self.path, "rb")
        try:
            self.size = self.path.stat().st_size
            self.track = self._read_track()
        except BaseException:
            self.file.close()
            raise

    def _read_track(self) -> Track:
        moov = None
        at = 0
        while at + 8 <= self.size:
            self.file.seek(at)
            head = self.file.read(16)
            size, kind = struct.unpack_from(">I4s", head)
            hlen = 8
            if size == 1:
                if len(head) < 16:
                    raise Mp4Error(f"{self.name}: a box header runs past "
                                   f"the file")
                size, = struct.unpack_from(">Q", head, 8)
                hlen = 16
            elif size == 0:
                size = self.size - at
            if size < hlen or at + size > self.size:
                raise Mp4Error(f"{self.name}: box {kind!r} at {at} "
                               f"({size} bytes) runs past the file")
            if kind == b"moov":
                self.file.seek(at + hlen)
                moov = self.file.read(size - hlen)
                break
            at += size
        if moov is None:
            raise Mp4Error(f"{self.name}: no moov box (not an ISO base "
                           f"media file, or a truncated one)")
        track = parse_moov(moov, (0, len(moov)), self.name, self.size)
        if len(track.sizes) and np.any(track.offsets + track.sizes
                                       > self.size):
            raise Mp4Error(f"{self.name}: a sample lies past the end of "
                           f"the file")
        return track

    def sample(self, i: int) -> bytes:
        t = self.track
        if not 0 <= i < t.count:
            raise IndexError(f"{self.name}: sample {i} of {t.count}")
        self.file.seek(int(t.offsets[i]))
        data = self.file.read(int(t.sizes[i]))
        if len(data) != t.sizes[i]:
            raise Mp4Error(f"{self.name}: sample {i} is cut short")
        return data

    def sync_before(self, i: int) -> int:
        """The last sync sample at or before sample ``i``."""
        sync = np.flatnonzero(self.track.sync[:i + 1])
        if not len(sync):
            raise Mp4Error(f"{self.name}: no sync sample before sample {i}")
        return int(sync[-1])

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def frame_rate(fps: float) -> Tuple[int, int]:
    """``fps`` as (ticks a second, ticks a frame), the ticks at most 65535
    (an MPEG-4 VOL's vop_time_increment_resolution has 16 bits)."""
    f = fractions.Fraction(fps).limit_denominator(65535)
    while f.numerator > 65535:
        f = fractions.Fraction(fps).limit_denominator(f.denominator // 2)
    if f <= 0:
        raise ValueError(f"fps must be positive, got {fps}")
    return f.numerator, f.denominator


def media_timing(fps: float) -> Tuple[int, int]:
    """(timescale, sample duration) for ``fps``, the timescale doubled up
    to 10000 or more as FFmpeg's muxer does."""
    scale, delta = frame_rate(fps)
    while scale < 10000:
        scale, delta = 2 * scale, 2 * delta
    return scale, delta


class Mp4Writer:
    """One mp4v video track written as cv2's muxer writes it:
    ``Mp4Writer(path, width, height, fps, config)``, ``add(sample,
    sync=True)``, ``close()``.  ``config`` is the decoder configuration
    (VOS, VO and VOL headers) that goes into the esds."""

    def __init__(self, path: Union[str, Path], width: int, height: int,
                 fps: float, config: bytes):
        self.path = Path(path)
        self.width, self.height, self.config = width, height, config
        self.timescale, self.delta = media_timing(fps)
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.sync: List[bool] = []
        self.file = open(self.path, "wb")
        self.file.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                             b"isom", b"iso2", b"mp41"))
        self.mdat_at = self.file.tell()
        self.file.write(_box(b"free"))           # room for a 64-bit mdat
        self.file.write(struct.pack(">I4s", 8, b"mdat"))
        self.at = self.file.tell()

    def add(self, sample: bytes, sync: bool = True) -> None:
        self.offsets.append(self.at)
        self.sizes.append(len(sample))
        self.sync.append(bool(sync))
        self.file.write(sample)
        self.at += len(sample)

    def _stbl(self) -> bytes:
        n = len(self.sizes)
        esds = _full(b"esds", 0, 0, _descr(0x03, struct.pack(">HB", 1, 0)
                     + _descr(0x04, struct.pack(
                         ">BB3sII", MPEG4_VISUAL, 0x11, b"\0\0\0",
                         max(self.sizes, default=0) * 8, 0)
                         + _descr(0x05, self.config))
                     + _descr(0x06, b"\x02")))
        entry = _box(b"mp4v", b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                     struct.pack(">HHIIIH", self.width, self.height,
                                 0x480000, 0x480000, 0, 1),
                     b"\0" * 32, struct.pack(">Hh", 0x18, -1), esds)
        parts = [_full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                 _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta)
                       if n else struct.pack(">I", 0))]
        if not all(self.sync):
            idx = [i + 1 for i, s in enumerate(self.sync) if s]
            parts.append(_full(b"stss", 0, 0, struct.pack(
                f">I{len(idx)}I", len(idx), *idx)))
        parts.append(_full(b"stsc", 0, 0, struct.pack(
            ">IIII", 1, 1, 1, 1) if n else struct.pack(">I", 0)))
        parts.append(_full(b"stsz", 0, 0, struct.pack(
            f">II{n}I", 0, n, *self.sizes)))
        if self.offsets and self.offsets[-1] >= 1 << 32:
            parts.append(_full(b"co64", 0, 0, struct.pack(
                f">I{n}Q", n, *self.offsets)))
        else:
            parts.append(_full(b"stco", 0, 0, struct.pack(
                f">I{n}I", n, *self.offsets)))
        return _box(b"stbl", *parts)

    def _moov(self) -> bytes:
        n = len(self.sizes)
        media = n * self.delta
        movie = media * 1000 // self.timescale
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie),
                     struct.pack(">IH", 0x10000, 0x100), b"\0" * 10,
                     _MATRIX, b"\0" * 24, struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie),
                     b"\0" * 8, struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", self.width << 16,
                                 self.height << 16))
        elst = _full(b"elst", 0, 0, struct.pack(">IIiI", 1, movie, 0,
                                                 0x10000))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.timescale, media, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, b"\0" * 4, b"vide", b"\0" * 12,
                     b"VideoHandler\0")
        vmhd = _full(b"vmhd", 0, 1, b"\0" * 8)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        minf = _box(b"minf", vmhd, dinf, self._stbl())
        trak = _box(b"trak", tkhd, _box(b"edts", elst),
                    _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def close(self) -> None:
        if self.file.closed:
            return
        try:
            size = self.at - self.mdat_at - 8     # mdat's box, header in
            self.file.seek(self.mdat_at)
            if size < 1 << 32:
                self.file.write(_box(b"free"))
                self.file.write(struct.pack(">I4s", size, b"mdat"))
            else:                                  # free + mdat -> largesize
                self.file.write(struct.pack(">I4sQ", 1, b"mdat", size + 8))
            self.file.seek(self.at)
            self.file.write(self._moov())
        finally:
            self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
