"""Video decode and encode without OpenCV (port of
``lameness_tpu/video/decode.py``).

The JAX package reads with cv2's bundled FFmpeg and writes
``cv2.VideoWriter(mp4v)`` files, re-encoded with libx264 when an
``ffmpeg`` binary exists.  The card's machine has neither, so the port
carries its own codecs for the two formats it writes:

- **MPEG-4 Part 2 in ``.mp4``** (``.m4v``, ``.mov``): a file whose video
  track is ``mp4v`` is demuxed by ``video/mp4.py`` and decoded by
  ``video/mpeg4.py`` (Simple Profile, I- and P-VOPs: what cv2's mp4v writer
  writes), to the planes FFmpeg's decoder gives.  ``read_selected`` starts
  at the sync sample before each wanted frame and decodes from there;
  intra-only files (the port's own) decode only the wanted frames.  Any
  other codec in such a file, and any other container, is decoded by the
  ``ffmpeg`` binary into a Y4M pipe (``ffmpeg -v error -i IN -f
  yuv4mpegpipe -pix_fmt yuv420p -``), with fps and frame count from
  ``ffprobe``; without the binary it raises, naming the codec.
- **YUV4MPEG2 (``.y4m``)**: a public raw format that ffmpeg and OpenCV
  read and write, which carries I420 frames as they are.  A file is one
  header line, ``YUV4MPEG2 W<w> H<h> F<num>:<den> ...``, then for each
  frame a ``FRAME`` line and the Y, U and V planes.  Only 4:2:0 is accepted
  (a ``C420``, ``C420jpeg``, ``C420mpeg2`` or ``C420paldv`` tag, or none);
  any other colourspace raises.  A file's frame count comes from its size,
  and ``read_selected`` seeks past unwanted frames.

Frames come out as the raw I420 planes (``i420_chunks``, what curation
sends to the device) or as RGB converted on the reader's ``device`` by
``yuv.i420_to_rgb`` (cv2's ``COLOR_YUV2RGB_I420``, bit for bit), a batch
at a time.

``write_video`` writes by the suffix the caller names: ``.mp4``, ``.m4v``
or ``.mov`` as an intra-only mp4v stream at ``mpeg4.QP``, any other
name as ``.y4m`` (that suffix); frames are converted on ``device`` with
``yuv.rgb_to_i420`` (cv2's ``COLOR_RGB2YUV_I420``).  With ``reencode``
(the default, as in JAX) an ``.mp4`` is re-encoded by JAX's libx264
command when ``shutil.which("ffmpeg")`` finds a binary.  It returns the
path it wrote.
"""
from __future__ import annotations

import concurrent.futures
import fractions
import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from . import mp4, mpeg4
from .yuv import i420_shape, i420_to_rgb, rgb_to_i420

MAGIC = b"YUV4MPEG2"
# threads for the mp4 codec's host half (its library releases the GIL)
HOST_THREADS = min(8, os.cpu_count() or 1)
_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
FRAME = b"FRAME"
CHROMA_420 = ("420", "420jpeg", "420mpeg2", "420paldv")
# frames converted to RGB on the device at once
RGB_BATCH = 16


def host_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = concurrent.futures.ThreadPoolExecutor(
            HOST_THREADS, thread_name_prefix="mp4-host")
    return _pool


def parse_header(line: bytes) -> Dict[str, float]:
    """The stream header line -> {"width", "height", "fps"}."""
    parts = line.split()
    if not parts or parts[0] != MAGIC:
        raise ValueError(f"not a YUV4MPEG2 stream: {line[:40]!r}")
    tags = {p[:1].decode(): p[1:].decode() for p in parts[1:]}
    chroma = tags.get("C", "420")
    if chroma not in CHROMA_420:
        raise ValueError(f"YUV4MPEG2 colourspace C{chroma}: only 4:2:0 "
                         f"(C420, C420jpeg, C420mpeg2, C420paldv) is read")
    num, _, den = tags.get("F", "0:0").partition(":")
    fps = int(num) / int(den) if int(den or 0) else 0.0
    w, h = int(tags["W"]), int(tags["H"])
    i420_shape(h, w)                         # even dimensions
    return {"width": w, "height": h, "fps": fps}


def header_line(width: int, height: int, fps: float) -> bytes:
    f = fractions.Fraction(fps).limit_denominator(1_000_000)
    return (f"YUV4MPEG2 W{width} H{height} F{f.numerator}:{f.denominator} "
            f"Ip A1:1 C420jpeg\n").encode()


class VideoReader:
    """``VideoReader(path, device=None)``: ``info`` ({"fps", "width",
    "height", "total_frames", "duration"}), ``frames``, ``read_sampled``,
    ``read_selected``, ``i420_chunks``, ``release`` and the context
    manager.  ``device`` is where mp4v frames are reconstructed and frames
    converted to RGB (the card by default)."""

    def __init__(self, path: Path, device=None):
        self.path = Path(path)
        self.device = resolve_device(device)
        self.proc: Optional[subprocess.Popen] = None
        self.mp4: Optional[mp4.Mp4Reader] = None
        self.stream = None
        if not self.path.exists():
            raise IOError(f"failed to open video: {path}")
        suffix = self.path.suffix.lower()
        if suffix == ".y4m":
            self.stream = open(self.path, "rb")
            try:
                self._open_stream()
            except BaseException:
                self.stream.close()
                raise
            self.seekable = True
        elif suffix in mp4.CONTAINERS and self._open_mp4():
            self.seekable = True
        else:
            self._open_pipe()
            self.seekable = False
        self.pos = 0                          # index of the next frame

    def _open_mp4(self) -> bool:
        """An ISO base media file whose video track is mp4v: the port's own
        demuxer and decoder.  False for another codec, or a file the
        demuxer cannot read (both the pipe's)."""
        try:
            reader = mp4.Mp4Reader(self.path)
        except mp4.Mp4Error as e:
            self.codec = f"undemuxable file ({e})"
            return False
        try:
            t = reader.track
            if t.codec != "mp4v" or t.object_type != mp4.MPEG4_VISUAL:
                self.codec = (t.codec if t.codec != "mp4v"
                              else f"mp4v (object type 0x{t.object_type:02x})")
                reader.close()
                return False
            config = t.config or (reader.sample(0) if t.count else b"")
            layer = mpeg4.read_config(config, self.path.name)
            self.decoder = mpeg4.Mpeg4Decoder(layer, self.device, RGB_BATCH)
        except BaseException:
            reader.close()
            raise
        self.mp4 = reader
        self.meta = {"width": layer.width, "height": layer.height,
                     "fps": t.fps}
        self.total = t.count
        return True

    def _open_stream(self):
        """A ``.y4m`` file: its header, and its frame count from its size
        (every frame a bare FRAME line and its planes)."""
        self.meta = parse_header(self.stream.readline())
        self.data_start = self.stream.tell()
        self.frame_bytes = int(np.prod(i420_shape(self.meta["height"],
                                                  self.meta["width"])))
        self.stride = len(FRAME) + 1 + self.frame_bytes
        size = self.path.stat().st_size
        self.total = max(0, (size - self.data_start) // self.stride)
        if self.total and self.stream.read(len(FRAME) + 1) != FRAME + b"\n":
            raise ValueError(f"{self.path}: a frame header with parameters "
                             f"(only a bare FRAME line is read)")
        self.stream.seek(self.data_start)

    def _open_pipe(self):
        ffmpeg, ffprobe = shutil.which("ffmpeg"), shutil.which("ffprobe")
        if ffmpeg is None or ffprobe is None:
            codec = getattr(self, "codec", None)
            what = f"its {codec} video" if codec else self.path.name
            raise RuntimeError(
                f"cannot decode {self.path.name}: no "
                f"{'ffmpeg' if ffmpeg is None else 'ffprobe'} binary on "
                f"PATH for {what}; lameness_tpu_torch reads mp4v in "
                f".mp4/.m4v/.mov and .y4m (YUV4MPEG2, 4:2:0) itself, and "
                f"other codecs and containers through ffmpeg")
        probe = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "v:0",
             "-count_packets", "-show_entries",
             "stream=r_frame_rate,nb_frames,nb_read_packets",
             "-of", "json", str(self.path)],
            capture_output=True, text=True, timeout=120)
        if probe.returncode != 0:
            raise IOError(f"failed to open video: {self.path}: "
                          f"{probe.stderr.strip()}")
        streams = json.loads(probe.stdout or "{}").get("streams") or [{}]
        st = streams[0]
        self.proc = subprocess.Popen(
            [ffmpeg, "-v", "error", "-nostdin", "-i", str(self.path),
             "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p", "-"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.stream = self.proc.stdout
        try:
            line = self.stream.readline()
            if not line:
                err = self.proc.stderr.read().decode(errors="replace")
                raise IOError(f"failed to open video: {self.path}: "
                              f"{err.strip()}")
            self.meta = parse_header(line)
            self.frame_bytes = int(np.prod(i420_shape(self.meta["height"],
                                                      self.meta["width"])))
        except BaseException:
            self.release()
            raise
        num, _, den = str(st.get("r_frame_rate", "0/0")).partition("/")
        if int(den or 0):
            self.meta["fps"] = int(num) / int(den)
        total = st.get("nb_frames") or st.get("nb_read_packets") or 0
        self.total = int(total) if str(total).isdigit() else 0

    @property
    def info(self) -> Dict[str, float]:
        fps = self.meta["fps"]
        return {"fps": fps, "width": self.meta["width"],
                "height": self.meta["height"], "total_frames": self.total,
                "duration": self.total / fps if fps > 0 else 0}

    # -- raw frames ---------------------------------------------------------
    def _read_frame(self) -> Optional[np.ndarray]:
        """The next frame's I420 planes, or None at the end."""
        line = self.stream.readline()
        if not line.startswith(FRAME):
            return None
        data = self.stream.read(self.frame_bytes)
        if len(data) < self.frame_bytes:
            return None
        self.pos += 1
        return np.frombuffer(data, np.uint8).reshape(
            i420_shape(self.meta["height"], self.meta["width"]))

    def _skip_to(self, index: int) -> bool:
        """Move to frame ``index`` (>= the current one): a seek in a file,
        frames read and dropped in a pipe."""
        if self.seekable:
            if index >= self.total:
                return False
            self.stream.seek(self.data_start + index * self.stride)
            self.pos = index
            return True
        while self.pos < index:
            if self._read_frame() is None:
                return False
        return True

    def _mp4_decode(self, wanted: Iterable[int]
                    ) -> Iterator[Tuple[List[int], torch.Tensor]]:
        """(indices, (n, H*3//2, W) uint8 I420 on the device) of the wanted
        mp4v frames (ascending), RGB_BATCH decoded at a time.  Each starts
        at the sync sample before it, unless decoding on from the last
        frame gets there without passing one."""
        samples: List[bytes] = []
        keep: List[Optional[int]] = []
        layer, name = self.decoder.layer, self.path.name

        def flush():
            if samples:
                vops = list(host_pool().map(
                    lambda s: mpeg4.decode_vop(layer, s, name), samples))
                out = self.decoder.reconstruct(vops)
                rows = [j for j, k in enumerate(keep) if k is not None]
                if rows:
                    yield [keep[j] for j in rows], out[rows]
                samples.clear()
                keep.clear()

        for i in wanted:
            if i >= self.total:
                break
            sync = self.mp4.sync_before(i)
            if i < self.pos or sync > self.pos:
                yield from flush()
                self.decoder.reset()
                self.pos = sync
            while self.pos <= i:
                samples.append(self.mp4.sample(self.pos))
                keep.append(self.pos if self.pos == i else None)
                self.pos += 1
                if len(samples) >= RGB_BATCH:
                    yield from flush()
        yield from flush()

    def i420_chunks(self, size: int) -> Iterator[Tuple[int, np.ndarray]]:
        """(index of the first frame, (n <= size, H*3//2, W) uint8 I420)
        over the rest of the stream."""
        if self.mp4 is not None:
            while self.pos < self.total:
                start = self.pos
                parts = [f for _, f in self._mp4_decode(
                    range(start, min(start + size, self.total)))]
                yield start, torch.cat(parts).cpu().numpy()
            return
        while True:
            start, rows = self.pos, []
            while len(rows) < size:
                f = self._read_frame()
                if f is None:
                    break
                rows.append(f)
            if not rows:
                return
            yield start, np.stack(rows)
            if len(rows) < size:
                return

    def to_rgb(self, i420: np.ndarray) -> np.ndarray:
        """(N, H*3//2, W) I420 -> (N, H, W, 3) RGB, converted on the
        reader's device."""
        dev = torch.from_numpy(np.ascontiguousarray(i420)).to(self.device)
        return i420_to_rgb(dev).cpu().numpy()

    # -- decoded frames -------------------------------------------------------
    def frames(self, interval: int = 1, rgb: bool = True
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (frame_index, HWC uint8) every ``interval``-th frame (BGR
        with ``rgb=False``)."""
        if self.mp4 is not None:
            wanted = [i for i in range(self.pos, self.total)
                      if i % interval == 0]
            for got, i420 in self._mp4_decode(wanted):
                for i, f in zip(got, i420_to_rgb(i420).cpu().numpy()):
                    yield i, f if rgb else f[..., ::-1]
            return
        for start, chunk in self.i420_chunks(RGB_BATCH * interval):
            keep = [i for i in range(len(chunk))
                    if (start + i) % interval == 0]
            if not keep:
                continue
            out = self.to_rgb(chunk[keep])
            for i, f in zip(keep, out):
                yield start + i, f if rgb else f[..., ::-1]

    def read_sampled(self, interval: int = 1, rgb: bool = True,
                     max_frames: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode sampled frames into one array: (frames (T,H,W,3), idx (T,))."""
        out, indices = [], []
        for i, f in self.frames(interval, rgb):
            out.append(f)
            indices.append(i)
            if max_frames and len(out) >= max_frames:
                break
        if not out:
            return (np.zeros((0, 0, 0, 3), np.uint8), np.zeros(0, np.int64))
        return np.stack(out), np.asarray(indices, np.int64)

    def read_selected(self, indices, rgb: bool = True
                      ) -> Dict[int, np.ndarray]:
        """Decode only the requested frame indices: {index: (H, W, 3)
        uint8}.  Unwanted frames are skipped (a seek in a ``.y4m`` file;
        in an mp4v file, decoding starts at the sync sample before each),
        and the wanted ones converted as one batch."""
        wanted = sorted(set(int(i) for i in indices))
        if self.mp4 is not None:
            out = {}
            for got, i420 in self._mp4_decode(wanted):
                for i, f in zip(got, i420_to_rgb(i420).cpu().numpy()):
                    out[i] = f if rgb else f[..., ::-1]
            return out
        if not self.seekable:                 # a pipe cannot go back
            wanted = [i for i in wanted if i >= self.pos]
        got, raw = [], []
        for i in wanted:
            if not self._skip_to(i):
                break
            f = self._read_frame()
            if f is None:
                break
            got.append(i)
            raw.append(f)
        if not raw:
            return {}
        out = self.to_rgb(np.stack(raw))
        return {i: f if rgb else f[..., ::-1] for i, f in zip(got, out)}

    def release(self):
        if self.mp4 is not None:
            self.mp4.close()
        elif self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            for s in (self.proc.stdout, self.proc.stderr):
                s.close()
            self.proc = None
        elif not self.stream.closed:
            self.stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.release()


def sample_interval(fps: float, target_fps: float) -> int:
    """The reference's sampling rule: max(1, int(fps) // target)."""
    return max(1, int(fps) // int(target_fps))


def _rgb_batches(frames, is_rgb: bool, device) -> Iterator[torch.Tensor]:
    """(n <= RGB_BATCH, H, W, 3) uint8 RGB batches of ``frames`` on
    ``device``."""
    for o in range(0, len(frames), RGB_BATCH):
        batch = frames[o:o + RGB_BATCH]
        if isinstance(batch, torch.Tensor):
            rgb = batch.to(device)
        else:
            rgb = torch.from_numpy(np.ascontiguousarray(
                np.stack(batch))).to(device)
        yield rgb if is_rgb else rgb.flip(-1)


def _write_y4m(path: Path, frames, fps: float, is_rgb: bool, device) -> None:
    h, w = frames[0].shape[:2]
    with open(path, "wb") as out:
        out.write(header_line(w, h, fps))
        for rgb in _rgb_batches(frames, is_rgb, device):
            for f in rgb_to_i420(rgb).cpu().numpy():
                out.write(FRAME + b"\n")
                out.write(f.tobytes())


def _write_mp4(path: Path, frames, fps: float, is_rgb: bool,
               device) -> None:
    """An intra-only mp4v stream: the transforms on ``device``, the bit
    coding on the host, HOST_THREADS frames at once."""
    h, w = frames[0].shape[:2]
    i420_shape(h, w)
    res, step = mp4.frame_rate(fps)
    config = mpeg4.write_config(w, h, res)
    t = 0
    with mp4.Mp4Writer(path, w, h, fps, config) as out:
        for rgb in _rgb_batches(frames, is_rgb, device):
            enc = mpeg4.encode_forward(rgb_to_i420(rgb))
            coefs = enc.coefs.cpu().numpy()
            acpred = enc.acpred.cpu().numpy()
            ticks = [(t + i) * step for i in range(len(coefs))]
            for sample in host_pool().map(
                    lambda k: mpeg4.encode_ivop(
                        w, h, res, ticks[k] // res, ticks[k] % res,
                        coefs[k], acpred[k]), range(len(coefs))):
                out.add(sample)
            t += len(coefs)


def reencode_x264(path: Path) -> None:
    """JAX's libx264 pass over ``path`` (``lameness_tpu/video/decode.py``),
    when an ``ffmpeg`` binary exists; the mp4v file stays if it fails."""
    if not shutil.which("ffmpeg"):
        return
    tmp = path.with_suffix(".temp.mp4")
    path.rename(tmp)
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", str(tmp), "-c:v", "libx264",
             "-preset", "medium", "-crf", "23", "-pix_fmt", "yuv420p",
             str(path)], capture_output=True, check=True)
        tmp.unlink()
    except Exception:
        if tmp.exists():
            tmp.rename(path)


def write_video(path: Path, frames: Union[List[np.ndarray], np.ndarray,
                                          torch.Tensor],
                fps: float, is_rgb: bool = True, reencode: bool = True,
                device=None) -> Optional[Path]:
    """Write frames (HWC uint8, RGB or with ``is_rgb=False`` BGR) to
    ``path``: an ``.mp4``, ``.m4v`` or ``.mov`` name as intra-only mp4v
    (then, with ``reencode``, JAX's libx264 pass when an
    ``ffmpeg`` binary exists), any other name with the suffix ``.y4m``.
    Frames are converted to I420 (and encoded) on ``device`` (a tensor's
    own device; the card by default) ``RGB_BATCH`` at a time.  Returns the
    path written, or None for no frames."""
    if len(frames) == 0:
        return None
    path = Path(path)
    is_mp4 = path.suffix.lower() in mp4.CONTAINERS
    if not is_mp4:
        path = path.with_suffix(".y4m")
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(frames, torch.Tensor):
        device = frames.device
    else:
        device = resolve_device(device)
    if is_mp4:
        _write_mp4(path, frames, fps, is_rgb, device)
        if reencode:
            reencode_x264(path)
    else:
        _write_y4m(path, frames, fps, is_rgb, device)
    return path
