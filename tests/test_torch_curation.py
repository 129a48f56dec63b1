"""The port's curation detectors (``lameness_tpu_torch/video/curation.py``)
against the JAX package's (``lameness_tpu/video/curation.py``) on the CPU.

The tiny YOLO and the 37 seeded frames of tests/test_curation_batched.py
(not chunk-aligned), the JAX weights carried to the port by
``weights.from_jax_params``.  Gates are the JAX test's own: the same
``None`` pattern, bbox and centroid within 1e-4, confidence within 1e-5.
"""
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
