"""Video decode and encode without OpenCV (port of
``lameness_tpu/video/decode.py``).

The port's container is YUV4MPEG2 (``.y4m``): a public raw format that
ffmpeg and OpenCV read and write, which carries I420 frames as they are.
A file is one header line, ``YUV4MPEG2 W<w> H<h> F<num>:<den> ...``, then
for each frame a ``FRAME`` line and the Y, U and V planes.  Only 4:2:0 is
accepted (a ``C420``, ``C420jpeg``, ``C420mpeg2`` or ``C420paldv`` tag, or
none); any other colourspace raises.

- ``VideoReader`` reads a ``.y4m`` file directly (a file's frame count
  comes from its size, and ``read_selected`` seeks past unwanted frames).
  Any other container is decoded by the ``ffmpeg`` binary into a Y4M pipe
  (``ffmpeg -v error -i IN -f yuv4mpegpipe -pix_fmt yuv420p -``), with fps
  and frame count from ``ffprobe``; without the binary it raises.
- Frames come out as the raw I420 planes (``i420_chunks``, what curation
  sends to the device) or as RGB converted on the reader's ``device`` by
  ``yuv.i420_to_rgb`` (cv2's ``COLOR_YUV2RGB_I420``, bit for bit), a batch
  at a time.
- ``write_video`` always writes ``.y4m`` (the stem the caller names, with
  that suffix), converting on ``device`` with ``yuv.rgb_to_i420`` (cv2's
  ``COLOR_RGB2YUV_I420``); it returns the path it wrote.  A 720p frame is
  1,382,400 bytes on disk.  mp4 encoding is not ported.
"""
from __future__ import annotations

import fractions
import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from .yuv import i420_shape, i420_to_rgb, rgb_to_i420

MAGIC = b"YUV4MPEG2"
FRAME = b"FRAME"
CHROMA_420 = ("420", "420jpeg", "420mpeg2", "420paldv")
# frames converted to RGB on the device at once
RGB_BATCH = 16


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
    manager.  ``device`` is where frames are converted to RGB (the card by
    default)."""

    def __init__(self, path: Path, device=None):
        self.path = Path(path)
        self.device = resolve_device(device)
        self.proc: Optional[subprocess.Popen] = None
        if not self.path.exists():
            raise IOError(f"failed to open video: {path}")
        if self.path.suffix.lower() == ".y4m":
            self.stream = open(self.path, "rb")
            try:
                self._open_stream()
            except BaseException:
                self.stream.close()
                raise
            self.seekable = True
        else:
            self._open_pipe()
            self.seekable = False
        self.pos = 0                          # index of the next frame

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
            raise RuntimeError(
                f"cannot decode {self.path.name}: no "
                f"{'ffmpeg' if ffmpeg is None else 'ffprobe'} binary on "
                f"PATH; lameness_tpu_torch reads .y4m (YUV4MPEG2, 4:2:0) "
                f"itself and other containers through ffmpeg")
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

    def i420_chunks(self, size: int) -> Iterator[Tuple[int, np.ndarray]]:
        """(index of the first frame, (n <= size, H*3//2, W) uint8 I420)
        over the rest of the stream."""
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
        uint8}.  Unwanted frames are skipped (a seek in a ``.y4m`` file),
        and the wanted ones converted as one batch."""
        wanted = sorted(set(int(i) for i in indices))
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
        if self.proc is not None:
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


def write_video(path: Path, frames: Union[List[np.ndarray], np.ndarray,
                                          torch.Tensor],
                fps: float, is_rgb: bool = True, device=None
                ) -> Optional[Path]:
    """Write frames (HWC uint8, RGB or with ``is_rgb=False`` BGR) to
    ``path`` with the suffix ``.y4m``, converted to I420 on ``device`` (a
    tensor's own device; the card by default) ``RGB_BATCH`` frames at a
    time.  Returns the path written, or None for no frames."""
    if len(frames) == 0:
        return None
    path = Path(path).with_suffix(".y4m")
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(frames, torch.Tensor):
        device = frames.device
    else:
        device = resolve_device(device)
    h, w = frames[0].shape[:2]
    with open(path, "wb") as out:
        out.write(header_line(w, h, fps))
        for o in range(0, len(frames), RGB_BATCH):
            batch = frames[o:o + RGB_BATCH]
            if isinstance(batch, torch.Tensor):
                rgb = batch.to(device)
            else:
                rgb = torch.from_numpy(np.ascontiguousarray(
                    np.stack(batch))).to(device)
            if not is_rgb:
                rgb = rgb.flip(-1)
            for f in rgb_to_i420(rgb).cpu().numpy():
                out.write(FRAME + b"\n")
                out.write(f.tobytes())
    return path
