"""The port's curation (``lameness_tpu_torch/video/curation.py``) against
the JAX package's (``lameness_tpu/video/curation.py``) on the CPU.

- The batched YOLO detector: the tiny YOLO and the 37 seeded frames of
  tests/test_curation_batched.py (not chunk-aligned), the JAX weights
  carried to the port by ``weights.from_jax_params``.  Gates are the JAX
  test's own: the same ``None`` pattern, bbox and centroid within 1e-4,
  confidence within 1e-5.
- ``blur_score`` and ``brightness_score`` against cv2's Laplacian and
  numpy's mean: within 1e-12 relative (the brightness equal).
- MOG2 against ``cv2.createBackgroundSubtractorMOG2(50, 32)`` frame by
  frame (the frames of tests/test_video.py's ``_synthetic_walk_video``, and
  a textured walk over a still textured background with +-2 LSB of noise):
  masks at least 99.9% equal a frame (they are equal), the opening equal to
  ``cv2.morphologyEx``, and the motion detector's picks equal to JAX's.
- ``ClipCurator.curate_video`` against JAX's on the same ``.y4m`` upload
  (JAX reading and writing through the cvtColor pair of
  tests/test_torch_decode.py, so both see the same pixels): with the
  motion fallback, a serial detector and a streamed one, left to right and
  right to left, the frame cache on and off, and the pass-through.  Passes,
  windows, flips, status and the detector-only metrics are equal; the
  visual score (and so the overall one) within 1e-12 relative (the
  Laplacian variance is rounded once here, by numpy's summation there);
  the canonical clips (mp4v ``<id>_canonical.mp4``, both written by the
  port's lossy encoder) have the same frames and size, the frames handed
  to each writer within 4 LSB (cv2's INTER_LINEAR against the port's
  bilinear resize, within 1, through the I420 conversion).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from lameness_tpu.models.yolo import YoloV8 as JYolo
from lameness_tpu.models.yolo import init_params
from lameness_tpu.video import curation as jcur
from lameness_tpu_torch.models.yolo import YoloV8
from lameness_tpu_torch.video import curation as tcur
from lameness_tpu_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tests run many small tensor
    ops (MOG2 a frame at a time), and a pool of threads per op crawls when
    the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_yolo():
    jm = JYolo(variant="n", num_classes=8)
    params = init_params(jm, jax.random.PRNGKey(0), img=64)
    tm = YoloV8("n", num_classes=8, device="cpu")
    tm.load_state_dict(from_jax_params({"m": params})["m"], strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def frames():
    import cv2
    rng = np.random.default_rng(3)
    out = []
    for _ in range(37):                     # deliberately not chunk-aligned
        base = rng.uniform(0, 255, (6, 8, 3)).astype(np.float32)
        out.append(cv2.resize(base, (96, 72),
                              interpolation=cv2.INTER_CUBIC
                              ).clip(0, 255).astype(np.uint8))
    return np.stack(out)                    # BGR by convention here


def _detectors(tiny_yolo, **kw):
    jm, params, tm = tiny_yolo
    args = dict(conf=0.0, cow_class_id=2, size=64)
    args.update(kw)
    return (jcur.BatchedYoloDetector(jm, params, **args),
            tcur.BatchedYoloDetector(tm, **args))


def _same(got, want):
    assert len(got) == len(want)
    hits = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert g is not None, i
        hits += 1
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4,
                                   err_msg=str(i))
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   atol=1e-5)
        np.testing.assert_allclose(g["centroid"], w["centroid"], atol=1e-4)
        np.testing.assert_allclose(g["area"], w["area"], rtol=1e-5)
    return hits


@pytest.mark.parametrize("bgr", [True, False])
def test_detect_batch_matches_jax(tiny_yolo, frames, bgr):
    jd, td = _detectors(tiny_yolo, chunk=16)
    want = jd.detect_batch(frames, bgr=bgr)
    got = td.detect_batch(frames, bgr=bgr)
    assert _same(got, want) > 0
    # 37 frames -> 3 chunks, the tail zero-padded
    assert td.dispatches == jd.dispatches == 3


def test_detect_stream_ragged_counts(tiny_yolo, frames):
    """Chunks of 8 with ragged valid counts (tails zero-padded by the
    caller), RGB."""
    rgb = np.ascontiguousarray(frames[..., ::-1])
    counts = [8, 3, 8, 5, 1]

    def chunks():
        o = 0
        for c in counts:
            block = np.zeros((8,) + rgb.shape[1:], np.uint8)
            block[:c] = rgb[o:o + c]
            o += c
            yield c, block
    jd, td = _detectors(tiny_yolo)
    want = jd.detect_stream(chunks())
    got = td.detect_stream(chunks())
    assert len(got) == sum(counts)
    _same(got, want)
    assert td.dispatches == len(counts)


def test_single_frame_call_and_per_frame_detector(tiny_yolo, frames):
    jm, params, tm = tiny_yolo
    jd, td = _detectors(tiny_yolo, chunk=4)
    per_frame = tcur.yolo_detector(tm, conf=0.0, cow_class_id=2, size=64)
    want = jcur.yolo_detector(jm, params, conf=0.0, cow_class_id=2,
                              size=64)
    for f in frames[:6]:
        _same([td(f), per_frame(f)], [jd(f), want(f)])


def test_yuv420_route_matches_jax(tiny_yolo, frames):
    """The I420 transfer (host conversion, RGB rebuilt on the device)
    against JAX's ``_jit_yuv`` route; 96x72 is even, so it is taken."""
    jd, td = _detectors(tiny_yolo, chunk=16, transfer="yuv420")
    assert td._resolve_transfer(72, 96) == "yuv420"
    _same(td.detect_batch(frames), jd.detect_batch(frames))


def test_resolve_transfer(tiny_yolo, monkeypatch):
    jd, td = _detectors(tiny_yolo)
    for env in (None, "0", "1", "2"):
        if env is None:
            monkeypatch.delenv("LAMENESS_YUV_INGEST", raising=False)
        else:
            monkeypatch.setenv("LAMENESS_YUV_INGEST", env)
        for h, w in ((72, 96), (71, 96), (72, 95), (720, 1280)):
            assert td._resolve_transfer(h, w) == jd._resolve_transfer(h, w)
            if h % 2 or w % 2:
                assert td._resolve_transfer(h, w) == "rgb"
        assert td._resolve_transfer(720, 1280) == \
            ("yuv420" if env == "1" else "rgb")
    fixed = tcur.BatchedYoloDetector(tiny_yolo[2], transfer="yuv420")
    assert fixed._resolve_transfer(72, 96) == "yuv420"
    assert fixed._resolve_transfer(71, 96) == "rgb"


def test_chunk_default(tiny_yolo, monkeypatch):
    monkeypatch.delenv("LAMENESS_CURATION_CHUNK", raising=False)
    assert tcur.BatchedYoloDetector(tiny_yolo[2]).chunk == 16
    monkeypatch.setenv("LAMENESS_CURATION_CHUNK", "48")
    assert tcur.BatchedYoloDetector(tiny_yolo[2]).chunk == 48


@pytest.mark.parametrize("seed", range(4))
def test_best_detection_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 8
    xy = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    wh = rng.uniform(-5, 60, (n, 2)).astype(np.float32)   # some inverted
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    for cow in (0, 2, 19):
        want = jcur._best_detection(boxes, scores, classes, valid, 72, 96,
                                    cow)
        got = tcur._best_detection(boxes, scores, classes, valid, 72, 96,
                                   cow)
        assert got == want


def test_dtype_follows_the_model(tiny_yolo):
    td = tcur.BatchedYoloDetector(tiny_yolo[2])
    assert td.dtype == torch.float32 and td.device.type == "cpu"


# ---------------------------------------------------------------------------
# quality stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(90, 160), (33, 64), (7, 5), (2, 2)])
@pytest.mark.parametrize("spread", [3, 40])
def test_blur_and_brightness_match_cv2(shape, spread):
    rng = np.random.default_rng(spread)
    base = rng.integers(0, 256 - spread)
    gray = (base + rng.integers(0, spread, shape)).astype(np.uint8)
    want = jcur.blur_score(gray)
    assert tcur.blur_score(gray) == pytest.approx(want, rel=1e-12, abs=0)
    assert tcur.blur_score(torch.from_numpy(gray)) == \
        tcur.blur_score(gray)
    assert tcur.brightness_score(gray) == jcur.brightness_score(gray)
    if spread == 3:
        assert want < 1.0                   # the cap does not hide it


def test_visual_scores_batch():
    import cv2
    rng = np.random.default_rng(0)
    rgb = (100 + rng.integers(0, 9, (5, 36, 64, 3))).astype(np.uint8)
    got = tcur.visual_scores(torch.from_numpy(rgb))
    for g, f in zip(got, rgb):
        gray = cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
        assert g == pytest.approx(
            (jcur.blur_score(gray) + jcur.brightness_score(gray)) / 2,
            rel=1e-12)


# ---------------------------------------------------------------------------
# the motion fallback
# ---------------------------------------------------------------------------
def synthetic_walk_frames(**kw):
    """The RGB frames tests/test_video.py's ``_synthetic_walk_video``
    writes (taken from its writer, no file)."""
    from pathlib import Path
    import tests.test_video as tv
    got = []
    orig = tv.write_video
    tv.write_video = lambda path, frames, fps, **k: got.extend(frames)
    try:
        tv._synthetic_walk_video(Path("unused.mp4"), **kw)
    finally:
        tv.write_video = orig
    return np.stack(got)


def textured_walk(n=80, w=160, h=90, reverse=False, seed=0, first=10,
                  last=70, cow=(40, 30)):
    """A still background of random 4-px cells with +-2 LSB of noise a
    frame; a block of random 4-px cells (the cow) walks across frames
    first..last.  RGB."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(30, 200, (h // 4 + 1, w // 4 + 1, 3)).repeat(
        4, 0).repeat(4, 1)[:h, :w]
    cw, ch = cow
    body = rng.integers(150, 256, (ch // 4 + 1, cw // 4 + 1, 3)).repeat(
        4, 0).repeat(4, 1)[:ch, :cw]
    out = []
    for i in range(n):
        f = bg + rng.integers(-2, 3, bg.shape)
        if first <= i <= last:
            frac = (i - first) / (last - first)
            x = int((1 - frac if reverse else frac) * (w - cw))
            y = (h - ch) // 2
            f[y:y + ch, x:x + cw] = body
        out.append(f.clip(0, 255).astype(np.uint8))
    return np.stack(out)


def _motion_inputs(kind):
    if kind == "synthetic_walk":
        return synthetic_walk_frames(n_frames=80, w=160, h=90, size=30)
    return textured_walk(n=60)


@pytest.mark.parametrize("kind", ["synthetic_walk", "textured"])
def test_mog2_matches_cv2(kind):
    import cv2
    frames = _motion_inputs(kind)
    bg = cv2.createBackgroundSubtractorMOG2(history=50, varThreshold=32)
    mog = tcur.MOG2(device="cpu")
    for i, f in enumerate(frames):
        bgr = np.ascontiguousarray(f[..., ::-1])
        want = bg.apply(bgr)
        got = mog.apply(torch.from_numpy(bgr)).numpy()
        assert (got == want).mean() >= 0.999, i
    assert set(np.unique(want)) <= {0, 127, 255}


@pytest.mark.parametrize("kind", ["synthetic_walk", "textured"])
def test_motion_detector_matches_jax(kind):
    frames = _motion_inputs(kind)
    bgr = np.ascontiguousarray(frames[..., ::-1])
    jd = jcur.motion_detector()
    want = [jd(f) for f in bgr]
    td = tcur.motion_detector(device="cpu")
    got = []
    for o in range(0, len(bgr), 16):          # chunks, one readback each
        got += td.detect_frames(torch.from_numpy(bgr[o:o + 16]))
    assert got == want
    hits = sum(d is not None for d in want)
    # the first frame's mask is all shadow (127): the whole frame
    assert want[0]["bbox"] == [0.0, 0.0, float(bgr.shape[2]),
                               float(bgr.shape[1])]
    if kind == "textured":
        assert hits > 40
    # the per-frame Detector call on a fresh detector gives the same
    per_frame = tcur.motion_detector(device="cpu")
    assert [per_frame(f) for f in bgr[:12]] == want[:12]


@pytest.mark.parametrize("seed", range(3))
def test_open_5x5_matches_cv2(seed):
    import cv2
    rng = np.random.default_rng(seed)
    masks = rng.choice(np.array([0, 127, 255], np.uint8), (4, 37, 50),
                       p=[0.5, 0.2, 0.3])
    masks[:, 5:20, 10:30] = 255
    got = tcur.open_5x5(torch.from_numpy(masks)).numpy()
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(g, cv2.morphologyEx(
            m, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8)))


def test_mog2_restarts_on_another_size():
    a = textured_walk(n=3, w=40, h=24)
    b = textured_walk(n=3, w=48, h=24, seed=1)
    mog = tcur.MOG2(device="cpu")
    for f in a:
        mog.apply(torch.from_numpy(f))
    fresh = tcur.MOG2(device="cpu")
    for f in b:
        np.testing.assert_array_equal(mog.apply(torch.from_numpy(f)),
                                      fresh.apply(torch.from_numpy(f)))
    assert mog.nframes == 3


# ---------------------------------------------------------------------------
# ClipCurator.curate_video against JAX's
# ---------------------------------------------------------------------------
class StreamedSquare:
    """tests/test_video.py's square detector behind ``detect_stream`` (the
    streamed track pass, on both sides)."""
    chunk = 8

    def __call__(self, frame_bgr):
        from tests.test_video import _square_detector
        return _square_detector(frame_bgr)

    def detect_stream(self, chunk_iter, timers=None):
        out = []
        for count, rgb in chunk_iter:
            out += [self(np.ascontiguousarray(f[..., ::-1]))
                    for f in rgb[:count]]
        return out


class Recorder:
    def __init__(self):
        self.history = []

    def publish_sync(self, subject, msg):
        self.history.append((subject, msg))


def _curation_detectors(kind):
    from tests.test_video import _square_detector
    if kind == "motion":
        return None, None
    if kind == "square":
        return _square_detector, _square_detector
    return StreamedSquare(), StreamedSquare()


def curate_both(tmp_path, monkeypatch, frames, fps, kind, cache=True):
    """The same .y4m upload through JAX's curator and the port's; returns
    (JAX report, port report, JAX curator, port curator)."""
    from lameness_tpu.core.config import DataDirs as JDirs
    from lameness_tpu_torch.core.config import DataDirs as TDirs
    from lameness_tpu_torch.video.decode import write_video
    from tests.test_torch_decode import swap_jax_io
    swap_jax_io(monkeypatch)
    if not cache:
        monkeypatch.setenv("LAMENESS_FRAME_CACHE_MB", "0")
    src = write_video(tmp_path / "upload", list(frames), fps, device="cpu")
    jdet, tdet = _curation_detectors(kind)
    jc = jcur.ClipCurator(JDirs(root=str(tmp_path / "jax")).ensure(),
                          detector=jdet, bus=Recorder())
    tc = tcur.ClipCurator(TDirs(root=str(tmp_path / "port")).ensure(),
                          detector=tdet, bus=Recorder(), device="cpu")
    for mod, cur in ((jcur, jc), (tcur, tc)):
        cur.written = {}
        monkeypatch.setattr(mod, "write_video",
                            _recording(mod.write_video, cur.written))
    return (jc.curate_video(src, "vid"), tc.curate_video(src, "vid"),
            jc, tc)


def _recording(write, store):
    """``write`` (a ``write_video``) keeping each file's frames by name:
    the canonical clips are mp4v, lossy, so the two sides' frames are
    compared before their encoder."""
    def wrapped(path, frames, *args, **kwargs):
        store[Path(path).name] = np.stack([np.asarray(f) for f in frames])
        return write(path, frames, *args, **kwargs)
    return wrapped


def assert_same_report(got, want):
    from lameness_tpu_torch.io import schemas as tschemas
    assert tschemas.validate("quality", got) == []
    assert list(got) == list(want)
    for key in want:
        if key in ("selected_window", "backup_window") and want[key]:
            g, w = dict(got[key]), dict(want[key])
            gm, wm = g.pop("metrics"), w.pop("metrics")
            assert g == w, key
            assert list(gm) == list(wm)
            for m in wm:
                if m in ("visual_quality_score", "overall_score"):
                    assert gm[m] == pytest.approx(wm[m], rel=1e-12), m
                else:
                    assert gm[m] == wm[m], m
        else:
            assert got[key] == want[key], key


def assert_same_canonical(jc, tc, name="vid_canonical"):
    """The same canonical frames, within 4 (the resize gap), as they went
    into each side's writer, and files that read back at their count and
    size."""
    from lameness_tpu_torch.video.decode import VideoReader
    paths = [c.canonical_dir / f"{name}.mp4" for c in (jc, tc)]
    assert all(p.exists() for p in paths)
    a, b = (c.written[f"{name}.mp4"] for c in (jc, tc))
    assert a.shape == b.shape and a.shape[1:3] == (720, 1280)
    assert (np.maximum(a, b) - np.minimum(a, b)).max() <= 4
    for p in paths:
        with VideoReader(p, device="cpu") as vr:
            got, idx = vr.read_sampled()
        assert got.shape == a.shape
        np.testing.assert_array_equal(idx, np.arange(len(a)))


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
@pytest.mark.parametrize("reverse", [False, True], ids=["ltr", "rtl"])
@pytest.mark.parametrize("kind", ["motion", "square", "streamed"])
def test_curate_video_matches_jax(tmp_path, monkeypatch, kind, reverse,
                                  cache):
    if kind == "motion":
        frames, fps = textured_walk(n=80, reverse=reverse), 10
    else:
        frames, fps = synthetic_walk_frames(
            n_frames=70, w=160, h=90, fps=10, reverse=reverse, size=30), 10
    want, got, jc, tc = curate_both(tmp_path, monkeypatch, frames, fps,
                                    kind, cache)
    assert_same_report(got, want)
    assert got["status"] == "success"
    assert got["selected_window"]["needs_flip"] is reverse
    assert got["passes"][0]["direction"] == \
        ("right_to_left" if reverse else "left_to_right")
    if cache:
        assert_same_canonical(jc, tc)
    # the memo the driver's preprocess reads, and the frame cache
    assert tc.last_detections == jc.last_detections
    assert (tc._frame_cache is None) == (jc._frame_cache is None) \
        == (not cache)
    if cache:
        for a, b in zip(tc._frame_cache["frames"],
                        jc._frame_cache["frames"]):
            np.testing.assert_array_equal(a, b)
    (js, jm), (ts, tm) = jc.bus.history[0], tc.bus.history[0]
    assert ts == js == "video.curated"
    assert tm["canonical_path"].endswith("vid_canonical.mp4")
    assert {k: v for k, v in tm.items() if not k.endswith("path")
            and k != "quality_report"} == \
        {k: v for k, v in jm.items() if not k.endswith("path")
         and k != "quality_report"}


def test_curate_passthrough_matches_jax(tmp_path, monkeypatch):
    """A 3 s clip the detector finds nothing in: the whole clip, unflipped,
    with the visual term only."""
    rng = np.random.default_rng(0)
    still = (80 + rng.integers(0, 6, (1, 90, 160, 3))).astype(np.uint8)
    frames = np.repeat(still, 30, axis=0)
    want, got, jc, tc = curate_both(tmp_path, monkeypatch, frames, 10,
                                    "square")
    assert_same_report(got, want)
    sel = got["selected_window"]
    assert got["status"] == "success" and got["walking_passes_detected"] == 0
    assert (sel["start_frame"], sel["end_frame"], sel["needs_flip"]) == \
        (0, 30, False)
    assert_same_canonical(jc, tc)


def test_curate_rejection_matches_jax(tmp_path, monkeypatch):
    """A long clip with no walking pass: rejected on both sides, no
    canonical clip, and the frame cache kept for the driver's preprocess
    (which crops even a rejected upload)."""
    rng = np.random.default_rng(1)
    still = (80 + rng.integers(0, 6, (1, 90, 160, 3))).astype(np.uint8)
    frames = np.repeat(still, 120, axis=0)      # 12 s: not canonical-like
    want, got, jc, tc = curate_both(tmp_path, monkeypatch, frames, 10,
                                    "square")
    assert_same_report(got, want)
    assert got["status"] == "rejected"
    assert jc._frame_cache is not None and tc._frame_cache is not None
    assert not (tc.canonical_dir / "vid_canonical.mp4").exists()


def test_streamed_detector_ending_early_raises(tmp_path):
    """A detect_stream that returns before the stream's end: an error, and
    the producer thread does not hang (JAX's join waits forever here)."""
    import threading
    from lameness_tpu_torch.core.config import DataDirs
    from lameness_tpu_torch.video.decode import write_video

    class Early(StreamedSquare):
        def detect_stream(self, chunk_iter, timers=None):
            count, _ = next(iter(chunk_iter))
            return [None] * count

    src = write_video(tmp_path / "up", list(textured_walk(n=70)), 10,
                      device="cpu")
    cur = tcur.ClipCurator(DataDirs(root=str(tmp_path / "d")).ensure(),
                           detector=Early(), device="cpu")
    err = []
    t = threading.Thread(target=lambda: err.append(
        pytest.raises(RuntimeError, cur.track_cow_through_video, src)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and err
    assert "before the end" in str(err[0].value)
