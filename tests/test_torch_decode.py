"""The port's decoder and encoder (``lameness_tpu_torch/video/decode.py``)
and its cv2 conversions (``video/yuv.py`` ``i420_to_rgb``,
``rgb_to_gray``) on the CPU.

- ``i420_to_rgb`` equals ``cv2.cvtColor(.., COLOR_YUV2RGB_I420)`` over
  every (Y, U, V) triple, and ``rgb_to_gray`` ``COLOR_RGB2GRAY`` over every
  (R, G, B): equal, bit for bit.
- A Y4M round trip: the frames read back are the I420 planes written,
  converted; ``info``, ``read_sampled``, ``read_selected`` (seeking),
  ``frames`` and the raw chunks.
- OpenCV's ``VideoCapture`` (its FFMPEG backend) reads a ``.y4m`` the port
  wrote with the same frame count, fps and size, and RGB within 3 LSB of
  the port's (swscale's conversion against cvtColor's): the file is real
  YUV4MPEG2.
- ``read_selected`` and ``read_sampled`` against the JAX ``VideoReader``
  on the same file, its capture swapped for ``CvY4MCapture`` (a Y4M reader
  on ``cvtColor``): equal.
- Other containers: without an ``ffmpeg`` binary the reader raises an
  error naming it; with a fake ``ffmpeg`` and ``ffprobe`` on ``PATH``
  (writing a Y4M stream, printing JSON) the pipe gives the file's frames.

``CvY4MCapture``, ``JaxY4MReader`` and ``jax_write_y4m`` are the JAX side's
Y4M pair for the curation and chain tests: they let the JAX package and
the port see the same pixels.
"""
import os
import stat
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from lameness_tpu.video import decode as jdecode
from lameness_tpu_torch.video import decode as tdecode
from lameness_tpu_torch.video import yuv as tyuv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tests run many small tensor
    ops (MOG2 a frame at a time), and a pool of threads per op crawls when
    the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side's Y4M pair (numpy parsing, cv2 conversions)
# ---------------------------------------------------------------------------
class CvY4MCapture:
    """A ``cv2.VideoCapture`` look-alike over a ``.y4m`` file (the path's
    stem with that suffix), parsed with numpy and converted with
    ``cv2.cvtColor(.., COLOR_YUV2BGR_I420)``."""

    def __init__(self, path):
        path = Path(path).with_suffix(".y4m")
        self.f = open(path, "rb") if path.exists() else None
        if self.f is None:
            return
        tags = self.f.readline().split()[1:]
        tags = {t[:1].decode(): t[1:].decode() for t in tags}
        self.w, self.h = int(tags["W"]), int(tags["H"])
        num, den = tags["F"].split(":")
        self.fps = int(num) / int(den)
        self.size = self.w * self.h * 3 // 2
        start = self.f.tell()
        self.n = (path.stat().st_size - start) // (self.size + 6)

    def isOpened(self):
        return self.f is not None

    def get(self, prop):
        return {cv2.CAP_PROP_FPS: self.fps, cv2.CAP_PROP_FRAME_COUNT: self.n,
                cv2.CAP_PROP_FRAME_WIDTH: self.w,
                cv2.CAP_PROP_FRAME_HEIGHT: self.h}[prop]

    def grab(self):
        self._planes = None
        if self.f.readline() != b"FRAME\n":
            return False
        data = self.f.read(self.size)
        if len(data) < self.size:
            return False
        self._planes = np.frombuffer(data, np.uint8).reshape(
            self.h * 3 // 2, self.w)
        return True

    def read(self):
        if not self.grab():
            return False, None
        return True, cv2.cvtColor(self._planes, cv2.COLOR_YUV2BGR_I420)

    def release(self):
        if self.f is not None:
            self.f.close()


class JaxY4MReader(jdecode.VideoReader):
    """The JAX ``VideoReader`` (its frame loops as they are) over
    ``CvY4MCapture``."""

    def __init__(self, path):
        self.path = Path(path)
        self.cap = CvY4MCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"failed to open video: {path}")


def jax_write_y4m(path, frames, fps, is_rgb=True, reencode=True) -> bool:
    """The JAX ``write_video`` signature, writing ``path`` with the suffix
    ``.y4m`` through ``cv2.cvtColor(.., COLOR_RGB2YUV_I420)``."""
    if not frames:
        return False
    path = Path(path).with_suffix(".y4m")
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = frames[0].shape[:2]
    num, den = (30000, 1001) if abs(fps - 30000 / 1001) < 1e-9 \
        else (int(fps), 1)
    with open(path, "wb") as out:
        out.write(f"YUV4MPEG2 W{w} H{h} F{num}:{den} Ip A1:1 "
                  f"C420jpeg\n".encode())
        for f in frames:
            f = np.ascontiguousarray(f if is_rgb else f[..., ::-1])
            out.write(b"FRAME\n")
            out.write(cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420).tobytes())
    return True


def swap_jax_io(monkeypatch):
    """The JAX curation and driver read and write ``.y4m`` through the
    cvtColor pair (the test's only change to the JAX side)."""
    from lameness_tpu.serve import driver as jdriver
    from lameness_tpu.video import curation as jcur
    for mod in (jcur, jdriver):
        monkeypatch.setattr(mod, "VideoReader", JaxY4MReader)
        monkeypatch.setattr(mod, "write_video", jax_write_y4m)


def seeded_frames(n=7, h=90, w=160, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# the conversions over every input
# ---------------------------------------------------------------------------
def test_i420_to_rgb_matches_cv2_every_triple():
    """A 4096x4096 I420 image in which every (Y, U, V) triple occurs once:
    each chroma sample's 2x2 block holds four Y values, 64 blocks a (U, V)
    pair."""
    h = w = 4096
    block = np.arange(h // 2 * w // 2)
    uv, sub = block // 64, block % 64
    ys = (sub[:, None] * 4 + np.arange(4)).astype(np.uint8)
    y = np.zeros((h, w), np.uint8)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y[dy::2, dx::2] = ys[:, k].reshape(h // 2, w // 2)
    i420 = np.concatenate([y.ravel(), (uv // 256).astype(np.uint8),
                           (uv % 256).astype(np.uint8)]).reshape(h * 3 // 2,
                                                                  w)
    want = cv2.cvtColor(i420, cv2.COLOR_YUV2RGB_I420)
    got = tyuv.i420_to_rgb(torch.from_numpy(i420)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rgb_to_gray_matches_cv2_every_triple():
    idx = np.arange(1 << 24, dtype=np.int64).reshape(4096, 4096)
    rgb = np.stack([idx >> 16, (idx >> 8) & 255, idx & 255],
                   -1).astype(np.uint8)
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    got = tyuv.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_i420_to_rgb_batched_and_odd_plane_rows():
    """Leading dims, and an H/2 that is odd (the chroma planes do not align
    to buffer rows)."""
    frames = seeded_frames(3, h=30, w=40)
    i420 = tyuv.rgb_to_i420(frames)
    got = tyuv.i420_to_rgb(torch.from_numpy(i420)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], cv2.cvtColor(i420[i], cv2.COLOR_YUV2RGB_I420))


def test_rgb_to_i420_tensor_matches_host():
    frames = seeded_frames(3)
    np.testing.assert_array_equal(
        tyuv.rgb_to_i420(torch.from_numpy(frames)).numpy(),
        tyuv.rgb_to_i420(frames))


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------
def _written(tmp_path, n=7, fps=30000 / 1001, name="clip.mp4"):
    frames = seeded_frames(n)
    path = tdecode.write_video(tmp_path / name, list(frames), fps,
                               device="cpu")
    want = tyuv.i420_to_rgb(torch.from_numpy(
        tyuv.rgb_to_i420(frames))).numpy()
    return path, frames, want


def test_y4m_round_trip(tmp_path):
    path, frames, want = _written(tmp_path)
    assert path == tmp_path / "clip.y4m"
    assert path.stat().st_size == len(tdecode.header_line(160, 90, 1)) \
        - len(b"F1:1") + len(b"F30000:1001") + 7 * (6 + 160 * 90 * 3 // 2)
    with tdecode.VideoReader(path, device="cpu") as vr:
        assert vr.info == {"fps": 30000 / 1001, "width": 160, "height": 90,
                           "total_frames": 7, "duration": 7 / (30000 / 1001)}
        got, idx = vr.read_sampled()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(idx, np.arange(7))
    with tdecode.VideoReader(path, device="cpu") as vr:
        got, idx = vr.read_sampled(interval=3, rgb=False, max_frames=2)
    np.testing.assert_array_equal(idx, [0, 3])
    np.testing.assert_array_equal(got, want[[0, 3]][..., ::-1])
    with tdecode.VideoReader(path, device="cpu") as vr:
        sel = vr.read_selected([5, 1, 1, 3, 40])
        again = vr.read_selected([0])          # a file seeks back
    assert sorted(sel) == [1, 3, 5] and list(again) == [0]
    for i, f in sel.items():
        np.testing.assert_array_equal(f, want[i])
    with tdecode.VideoReader(path, device="cpu") as vr:
        chunks = list(vr.i420_chunks(3))
    assert [(s, len(c)) for s, c in chunks] == [(0, 3), (3, 3), (6, 1)]
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]),
                                  tyuv.rgb_to_i420(frames))


def test_write_video_bgr_tensor_and_empty(tmp_path):
    frames = seeded_frames(3)
    a = tdecode.write_video(tmp_path / "a", torch.from_numpy(frames), 25)
    b = tdecode.write_video(tmp_path / "b.mp4", frames[..., ::-1], 25,
                            is_rgb=False, device="cpu")
    assert a.read_bytes() == b.read_bytes()
    assert tdecode.write_video(tmp_path / "c", [], 25, device="cpu") is None


def test_cv2_reads_the_port_y4m(tmp_path):
    path, _, want = _written(tmp_path, n=9)
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(30000 / 1001, rel=1e-9)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (160, 90)
    n = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        diff = np.abs(bgr[..., ::-1].astype(int) - want[n]).max()
        assert diff <= 3, (n, diff)
        n += 1
    cap.release()
    assert n == 9


@pytest.mark.parametrize("indices", [[0, 2, 3, 6], [6], [4, 1], [9, 2]])
def test_reader_matches_jax_reader(tmp_path, monkeypatch, indices):
    path, _, _ = _written(tmp_path, n=7, fps=25)
    monkeypatch.setattr(jdecode.cv2, "VideoCapture", CvY4MCapture)
    for interval, rgb in ((1, True), (2, False)):
        with jdecode.VideoReader(path) as jr, \
                tdecode.VideoReader(path, device="cpu") as tr:
            assert tr.info == jr.info
            a, ai = jr.read_sampled(interval, rgb)
            b, bi = tr.read_sampled(interval, rgb)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ai, bi)
    with jdecode.VideoReader(path) as jr, \
            tdecode.VideoReader(path, device="cpu") as tr:
        want, got = jr.read_selected(indices), tr.read_selected(indices)
    assert list(got) == list(want)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("line,error", [
    (b"YUV4MPEG2 W160 H90 F25:1 C444\n", "colourspace"),
    (b"YUV4MPEG2 W160 H90 F25:1 C420p10\n", "colourspace"),
    (b"YUV4MPEG2 W161 H90 F25:1\n", "even"),
    (b"RIFF....\n", "YUV4MPEG2")])
def test_header_rejects(line, error):
    with pytest.raises(ValueError, match=error):
        tdecode.parse_header(line)


def test_frame_header_with_parameters_raises(tmp_path):
    path = tmp_path / "p.y4m"
    path.write_bytes(b"YUV4MPEG2 W4 H2 F25:1\nFRAME Ixyz\n" + bytes(12))
    with pytest.raises(ValueError, match="frame header"):
        tdecode.VideoReader(path, device="cpu")


def test_header_tags():
    assert tdecode.parse_header(b"YUV4MPEG2 W4 H2 F30000:1001 Ip A1:1 "
                                b"C420mpeg2 XYSCSS=420MPEG2\n") == \
        {"width": 4, "height": 2, "fps": 30000 / 1001}
    assert tdecode.parse_header(b"YUV4MPEG2 H2 W4\n")["fps"] == 0.0


# ---------------------------------------------------------------------------
# other containers: the ffmpeg binary
# ---------------------------------------------------------------------------
def test_no_ffmpeg_names_it(tmp_path, monkeypatch):
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0" * 64)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match=r"ffmpeg.*\.y4m"):
        tdecode.VideoReader(clip, device="cpu")
    with pytest.raises(IOError, match="failed to open"):
        tdecode.VideoReader(tmp_path / "missing.y4m", device="cpu")


def _fake_tools(bindir: Path, y4m: Path, frames: int):
    """``ffmpeg`` that writes ``y4m`` to stdout for any input (checking
    the arguments the reader passes) and ``ffprobe`` that prints its
    frame rate and count."""
    bindir.mkdir()
    scripts = {
        "ffmpeg": f"""
            import sys
            args = sys.argv[1:]
            assert args[args.index("-f") + 1] == "yuv4mpegpipe", args
            assert args[args.index("-pix_fmt") + 1] == "yuv420p", args
            assert args[-1] == "-", args
            sys.stdout.buffer.write(open({str(y4m)!r}, "rb").read())
            """,
        "ffprobe": f"""
            import json
            print(json.dumps({{"streams": [{{"r_frame_rate": "30000/1001",
                                             "nb_frames": "{frames}"}}]}}))
            """}
    for name, body in scripts.items():
        p = bindir / name
        p.write_text(f"#!{sys.executable}\n" + textwrap.dedent(body))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)


def test_ffmpeg_pipe(tmp_path, monkeypatch):
    path, _, want = _written(tmp_path, n=7)
    _fake_tools(tmp_path / "bin", path, 7)
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep
                       + os.environ["PATH"])
    clip = tmp_path / "upload.mp4"
    clip.write_bytes(b"not read by the fake")
    with tdecode.VideoReader(clip, device="cpu") as vr:
        assert vr.info == {"fps": 30000 / 1001, "width": 160, "height": 90,
                           "total_frames": 7, "duration": 7 / (30000 / 1001)}
        sel = vr.read_selected([2, 5])          # frames 0, 1, 3, 4 read past
        rest = vr.read_sampled()
    assert sorted(sel) == [2, 5]
    for i, f in sel.items():
        np.testing.assert_array_equal(f, want[i])
    np.testing.assert_array_equal(rest[0], want[6:])
    with tdecode.VideoReader(clip, device="cpu") as vr:
        got, idx = vr.read_sampled(interval=2)
        proc = vr.proc
    np.testing.assert_array_equal(got, want[::2])
    assert proc.returncode is not None          # released: no process left
