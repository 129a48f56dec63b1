"""The port's serving stream (``lameness_tpu_torch/serve``, ``io``,
``utils``, the host half of ``models/pose.py``) against the JAX package on
the CPU.

- The copied modules on the same inputs as their JAX originals: the config
  slice, every schema builder the writer calls and ``validate``, the
  message bus, the vector store (host and device top-k, ties, k > n) and
  the host locomotion features: equal.
- ``_mask_features`` (numpy/scipy, ``serve/contours.py``) against the JAX
  driver's cv2 version: area and centroid exact, perimeter, circularity and
  aspect within 1e-9 relative; the contour measures against cv2 on seeded
  masks.
- The writer alone: one output tree through both drivers' writers gives
  equal files (floats within 1e-9 relative).
- ``process_stream`` end to end: the tiny engines of
  tests/test_torch_engine.py (dropout 0, the same weights) over the same
  synthetic clips, the port reading them through JAX's ``VideoReader``:
  the files agree key by key within the engine tests' 1e-4, and the bus
  subjects come in the same order.
- The stream's failure paths (tests/test_batch_driver.py:117-183).
"""
import json
import threading
from pathlib import Path

import numpy as np
import pytest

from lameness_tpu.core import config as jconfig
from lameness_tpu.io import bus as jbus
from lameness_tpu.io import schemas as jschemas
from lameness_tpu.io import vecstore as jvec
from lameness_tpu.models import pose as jpose
from lameness_tpu.serve.driver import PipelineDriver as JDriver
from lameness_tpu_torch.core import config as tconfig
from lameness_tpu_torch.io import bus as tbus
from lameness_tpu_torch.io import schemas as tschemas
from lameness_tpu_torch.io import vecstore as tvec
from lameness_tpu_torch.models import pose as tpose
from lameness_tpu_torch.serve import contours
from lameness_tpu_torch.serve.driver import PipelineDriver
from lameness_tpu_torch.utils.timing import StageTimers

KINDS = ("yolo", "sam3", "dinov3", "tleap", "tcn", "transformer")


# ---------------------------------------------------------------------------
# copied modules
# ---------------------------------------------------------------------------
def test_config_slice_matches_jax(tmp_path):
    import dataclasses
    assert tconfig.Subjects().as_dict() == jconfig.Subjects().as_dict()
    assert dataclasses.asdict(tconfig.ReidConfig()) == \
        dataclasses.asdict(jconfig.ReidConfig())
    assert tconfig.DinoConfig().top_k_similar == \
        jconfig.DinoConfig().top_k_similar
    root = str(tmp_path / "d")
    td, jd = tconfig.DataDirs(root=root), jconfig.DataDirs(root=root)
    for name in ("videos", "processed", "canonical", "training", "results",
                 "quality_reports", "rater_reliability", "models"):
        assert getattr(td, name) == getattr(jd, name)
    assert td.results_for("sam3") == jd.results_for("sam3")
    td.ensure()
    assert td.models.is_dir() and td.results.is_dir()


def _builder_cases(rng):
    boxes = rng.uniform(0, 500, (6, 4)).astype(np.float32)
    emb = rng.standard_normal(8).astype(np.float32)
    feats = {"mask_area": 12.0, "area_ratio": 0.25, "circularity": 0.5,
             "aspect_ratio": 1.5}
    seqs = [{"frame": i, "time": i / 25, "bbox": [1.0, 2.0, 3.0, 4.0],
             "keypoints": [], "detection_confidence": 0.9} for i in range(3)]
    return [
        ("yolo_detection_entry", (3, boxes[0], np.float32(0.7), "cow", 19)),
        ("yolo_frame_entry", (3, 25, [{"a": 1}])),
        ("yolo_frame_entry", (3, 0, [])),
        ("yolo_features", (boxes, rng.uniform(0, 1, 6), 4, 125)),
        ("yolo_features", (np.zeros((0, 4)), np.zeros(0), 0, 125)),
        ("yolo_result", ([{"frame": 0}], {"x": 1.0}, 125, 25.0)),
        ("sam3_frame_features", (1.0, 0.1, 0.2, 0.3, 4.0, 5.0, 6.0, 7, 25)),
        ("sam3_segmentation_entry", (7, 25, True, feats)),
        ("sam3_segmentation_entry", (7, 25, False)),
        ("sam3_aggregated", ([feats, dict(feats, mask_area=3.0)],)),
        ("sam3_aggregated", ([],)),
        ("sam3_result", ([{"frame": 0}], feats, 125, 25)),
        ("dinov3_embedding_entry", (25, 25, emb)),
        ("dinov3_result", ("v", emb, 5, [{"video_id": "u"}], 0.5,
                           [{"frame": 0}])),
        ("tleap_result", ("v", 125, 25, seqs, {"lameness_score": 0.2},
                          "heuristic", jpose.KEYPOINT_NAMES,
                          [list(c) for c in jpose.COW_SKELETON],
                          {k: list(v) for k, v in
                           jpose.SKELETON_COLORS.items()})),
        ("tcn_result", ("v", 0.7, 0.1, 125, 44, 61)),
        ("transformer_result", ("v", 0.3, 0.05, 125, 44, 100,
                                rng.uniform(0, 1, 125), 64, 4, 4)),
    ]


def test_schema_builders_match_jax(tmp_path):
    for name, args in _builder_cases(np.random.default_rng(0)):
        want = getattr(jschemas, name)(*args)
        got = getattr(tschemas, name)(*args)
        assert json.dumps(got) == json.dumps(want), name
    result = jschemas.yolo_result([{"frame": 0}], {"x": 1.0}, 125, 25)
    for kind in ("yolo", "sam3", "dinov3", "tleap"):
        msg = getattr(jschemas, f"{kind}_message")
        built = {"yolo": result,
                 "sam3": jschemas.sam3_result([], {}, 125, 25),
                 "dinov3": jschemas.dinov3_result("v", np.ones(3), 1, [],
                                                  0.5, []),
                 "tleap": jschemas.tleap_result("v", 125, 25, [], {}, "h",
                                                [], [], {})}[kind]
        assert json.dumps(getattr(tschemas, f"{kind}_message")(
            "v", "p", built)) == json.dumps(msg("v", "p", built)), kind
    a = tschemas.write_result(tmp_path / "t" / "a.json", result)
    b = jschemas.write_result(tmp_path / "j" / "a.json", result)
    assert a.read_bytes() == b.read_bytes()


def test_validate_matches_jax():
    assert tschemas.REQUIRED_KEYS == jschemas.REQUIRED_KEYS
    rng = np.random.default_rng(1)
    for kind, keys in jschemas.REQUIRED_KEYS.items():
        obj = {k: 0 for k in keys if rng.random() < 0.7}
        assert tschemas.validate(kind, obj) == jschemas.validate(kind, obj)
        assert tschemas.validate(kind, {k: 0 for k in keys}) == []


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_bus_matches_jax(tmp_path, async_dispatch):
    """Subjects, payloads (JSON round-tripped), the journal's lines (but
    their times), handler errors recorded and swallowed."""
    def run(mod, sub):
        bus = mod.MessageBus(journal_path=tmp_path / sub / "j.jsonl",
                             async_dispatch=async_dispatch)
        seen = []
        bus.subscribe_sync("pipeline.tcn", lambda m: seen.append(m))
        bus.subscribe_sync("pipeline.tcn", lambda m: 1 / 0)
        for i, subj in enumerate(("pipeline.yolo", "pipeline.tcn",
                                  "pipeline.yolo", "pipeline.sam3")):
            bus.publish_sync(subj, {"i": i, "v": np.float32(0.5).item(),
                                    "t": (1, 2)})
        bus.flush()
        bus.shutdown()
        lines = [json.loads(ln) for ln in
                 (tmp_path / sub / "j.jsonl").read_text().splitlines()]
        return (bus.subjects_seen(), bus.messages_on("pipeline.yolo"), seen,
                [e["subject"] for e in bus.errors],
                [(ln["subject"], ln["payload"]) for ln in lines])
    assert run(tbus, "t") == run(jbus, "j")


@pytest.mark.parametrize("use_device", [False, True])
def test_vecstore_search_matches_jax(tmp_path, use_device):
    """Cosine top-k on the host and on the device (the port's device is
    the CPU here), with tied scores (duplicate vectors) and k > n."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((11, 16)).astype(np.float32)
    vecs[7] = vecs[2]                       # exact ties
    vecs[9] = 2 * vecs[2]                   # the same direction
    stores = (tvec.VectorStore(tmp_path / "t.json", device="cpu"),
              jvec.VectorStore(tmp_path / "j.json"))
    for s in stores:
        s.create_collection("c", 16)
        for i, v in enumerate(vecs):
            s.upsert("c", f"p{i}", v, payload={"i": i})
    for q in (vecs[2], rng.standard_normal(16), vecs[0]):
        for k in (1, 3, 5, 11, 20):
            got, want = (s.search("c", q, top_k=k, use_device=use_device)
                         for s in stores)
            assert [h.id for h in got] == [h.id for h in want], (k, q[:2])
            np.testing.assert_allclose([h.score for h in got],
                                       [h.score for h in want], atol=1e-6)
            assert [h.payload for h in got] == [h.payload for h in want]
    # persistence round trip
    again = tvec.VectorStore(tmp_path / "t.json", device="cpu")
    assert again.count("c") == 11
    assert again.retrieve("c", "p3").payload == {"i": 3}
    with pytest.raises(NotImplementedError):
        tvec.make_store(url="http://localhost:6333")


def test_locomotion_features_match_jax():
    rng = np.random.default_rng(4)
    for trial in range(6):
        seqs = []
        for i in range(int(rng.integers(0, 30))):
            box = [10 + 3 * i + rng.uniform(0, 2), 20 + rng.uniform(0, 5),
                   200 + 3 * i, 140 + rng.uniform(0, 5)]
            kps = jpose.heuristic_keypoints(box)
            for kp in kps:
                kp["x"] += float(rng.normal(0, 2))
                kp["y"] += float(rng.normal(0, 2))
                kp["confidence"] = float(rng.uniform(0.1, 1.0))
            if trial == 5 and i % 3 == 0:
                kps = kps[:10]              # short keypoint lists are skipped
            seqs.append({"frame": i, "keypoints": kps})
        assert tpose.compute_locomotion_features(seqs) == \
            jpose.compute_locomotion_features(seqs)
    assert tpose.heuristic_keypoints([1.7, 2.2, 90.9, 40.1]) == \
        jpose.heuristic_keypoints([1.7, 2.2, 90.9, 40.1])


def test_stage_timers():
    t = StageTimers(window=3)
    for _ in range(5):
        with t.time("decode"):
            pass
    t.record("write_results", 0.25)
    s = t.summary()
    assert s["decode"]["count"] == 3 and s["write_results"]["p50_s"] == 0.25
    t.reset()
    assert t.summary() == {}


# ---------------------------------------------------------------------------
# mask features
# ---------------------------------------------------------------------------
def _mask(kind, rng):
    m = np.zeros((256, 256), np.uint8)
    if kind == "holes":
        m[40:200, 30:220] = 1
        m[80:120, 60:100] = 0
        m[150:170, 150:200] = 0
        m[90:100, 70:80] = 1                # an island inside a hole
    elif kind == "components":
        m[10:60, 10:40] = 1
        m[100:180, 120:250] = 1
        m[200:230, 20:90] = 1
        m[70, 70] = 1
    elif kind == "one_pixel":
        m[100, 37] = 1
    elif kind == "one_line":
        m[50, 20:140] = 1                   # a one-pixel line
        m[60:61, 200:202] = 1               # a two-pixel segment
        m[100:180, 5] = 1                   # a vertical line
    elif kind == "border":
        m[0:90, 0:256] = 1                  # touches three sides
        m[200:256, 230:256] = 1             # a corner
    elif kind == "full":
        m[:] = 1
    elif kind == "blob":
        yy, xx = np.mgrid[:256, :256]
        m[(yy - 120) ** 2 / 70 ** 2 + (xx - 130) ** 2 / 90 ** 2 < 1] = 1
        m[rng.random((256, 256)) < 0.01] ^= 1
    elif kind == "noise":
        m[:] = rng.random((256, 256)) < 0.4
    return m


MASKS = ("holes", "components", "one_pixel", "one_line", "border", "empty",
         "full", "blob", "noise")
NATIVE = ((256, 256), (720, 1280), (90, 160), (480, 270))


@pytest.mark.parametrize("native", NATIVE, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", MASKS)
def test_mask_features_match_cv2(kind, native):
    mask = _mask(kind, np.random.default_rng(5))
    info = {"height": native[0], "width": native[1], "fps": 25,
            "total_frames": 125}
    want = JDriver._mask_features(None, mask, info)
    got = PipelineDriver._mask_features(None, mask, info)
    assert set(got) == set(want)
    for key in ("mask_area", "area_ratio", "centroid_x", "centroid_y"):
        assert got[key] == want[key], key
    for key in ("perimeter", "circularity", "aspect_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("seed", range(3))
def test_contours_match_cv2(seed):
    """The largest outer contour's area (exact), closed arc length (1e-12
    relative) and bounding rectangle against cv2 on seeded masks: sparse
    and dense noise (ties among one-pixel and one-line contours, border
    contact), and block masks."""
    import cv2
    rng = np.random.default_rng(seed)
    for t in range(300):
        h, w = rng.integers(1, 40, 2)
        m = rng.random((h, w)) < rng.uniform(0.02, 0.95)
        if t % 3 == 0:
            m = np.kron(m[:(h + 2) // 3, :(w + 2) // 3],
                        np.ones((3, 3), bool))[:h, :w]
        cs, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                 cv2.CHAIN_APPROX_SIMPLE)
        got = contours.largest_external_contour(m)
        if not cs:
            assert got is None
            continue
        c = max(cs, key=cv2.contourArea)
        assert got[0] == cv2.contourArea(c), t
        np.testing.assert_allclose(got[1], cv2.arcLength(c, True),
                                   rtol=1e-12)
        assert got[2] == tuple(cv2.boundingRect(c)), t
        m00, m10, m01 = contours.first_moments(m)
        mm = cv2.moments(m.astype(np.uint8))
        assert (m00, m10, m01) == (mm["m00"], mm["m10"], mm["m01"])


def test_resize_nearest_matches_cv2():
    import cv2
    rng = np.random.default_rng(6)
    for _ in range(60):
        sh, sw = rng.integers(1, 300, 2)
        dh, dw = rng.integers(1, 1400, 2)
        src = rng.integers(0, 256, (sh, sw), dtype=np.uint8)
        np.testing.assert_array_equal(
            contours.resize_nearest(src, int(dw), int(dh)),
            cv2.resize(src, (int(dw), int(dh)),
                       interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------------------
# the writer and the stream
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    from tests.test_torch_engine import _jax_engine, _port_engine
    jeng = _jax_engine()
    return jeng, _port_engine(jeng.params)


def _drivers(engines, root, reader=None):
    from lameness_tpu.video.curation import ClipCurator
    from tests.test_video import _square_detector
    jeng, teng = engines
    jcfg = jconfig.Config.load(data_root=str(root / "jax"))
    tcfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(root / "port")))
    jdrv = JDriver(config=jcfg, engine=jeng, curator=ClipCurator(
        jcfg.dirs, detector=_square_detector))
    return jdrv, PipelineDriver(config=tcfg, engine=teng, reader=reader)


def _flat_json(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat_json(v, f"{prefix}.{k}")
    elif isinstance(obj, list):
        yield prefix + "#len", len(obj)
        for i, v in enumerate(obj):
            yield from _flat_json(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _same_files(jdrv, tdrv, video_ids, rtol, atol):
    for vid in video_ids:
        for kind in KINDS:
            want = json.loads((jdrv.dirs.results_for(kind)
                               / f"{vid}_{kind}.json").read_text())
            got = json.loads((tdrv.dirs.results_for(kind)
                              / f"{vid}_{kind}.json").read_text())
            assert tschemas.validate(kind, got) == []
            w, g = dict(_flat_json(want)), dict(_flat_json(got))
            assert list(g) == list(w), (vid, kind)
            for key, wv in w.items():
                gv = g[key]
                if isinstance(wv, float) or isinstance(gv, float):
                    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol,
                                               err_msg=f"{vid} {kind}{key}")
                else:
                    assert gv == wv, (vid, kind, key)


def test_writer_alone_matches_jax(engines, tmp_path):
    """One output tree (the port engine's, on seeded frames) through both
    drivers' writers: equal files, floats within 1e-9 relative."""
    import torch
    jdrv, tdrv = _drivers(engines, tmp_path)
    frames = np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                               dtype=np.uint8)
    out = engines[1].process_clip_batch(
        frames, generator=torch.Generator().manual_seed(0))
    assert out["primary_valid"].any()
    for drv in (jdrv, tdrv):
        for bi, info in enumerate(({"width": 160, "height": 90, "fps": 5,
                                    "total_frames": 15},
                                   {"width": 320, "height": 180, "fps": 0,
                                    "total_frames": 12})):
            drv._write_stage_results(f"w{bi}", out, bi,
                                     (info["width"] / 160,
                                      info["height"] / 90), info)
    _same_files(jdrv, tdrv, ["w0", "w1"], rtol=1e-9, atol=0)
    assert [m["subject"] for m in tdrv.bus.history] == \
        [m["subject"] for m in jdrv.bus.history]


def _clips(tmp_path, n=3):
    from tests.test_video import _synthetic_walk_video
    return [(f"s{i}", _synthetic_walk_video(
        tmp_path / f"s{i}.mp4", n_frames=40, w=160, h=90, fps=5,
        bob=2.0 * i)) for i in range(n)]


@pytest.mark.parametrize("pad_to", [None, 2])
def test_process_stream_matches_jax(engines, tmp_path, pad_to):
    """Three clips at batch_size=2 (a trailing partial batch, or padded to
    2): the same result files within the engine tests' 1e-4, the same bus
    subjects in the same order."""
    from lameness_tpu.video.decode import VideoReader
    jdrv, tdrv = _drivers(engines, tmp_path, reader=VideoReader)
    jobs = _clips(tmp_path)
    want = jdrv.process_stream(jobs, batch_size=2, pad_to=pad_to,
                               decode_workers=2)
    got = tdrv.process_stream(jobs, batch_size=2, pad_to=pad_to,
                              decode_workers=2)
    assert len(got) == len(want) == 3
    _same_files(jdrv, tdrv, [v for v, _ in jobs], rtol=0, atol=1e-4)
    assert [m["subject"] for m in tdrv.bus.history] == \
        [m["subject"] for m in jdrv.bus.history]
    detections = json.loads((tdrv.dirs.results_for("yolo")
                             / "s0_yolo.json").read_text())["detections"]
    assert detections, "no detection: the comparison is idle"


def test_run_feature_stages_batch_and_single(engines, tmp_path):
    from lameness_tpu.video.decode import VideoReader
    _, tdrv = _drivers(engines, tmp_path, reader=VideoReader)
    jobs = _clips(tmp_path, 2)
    assert len(tdrv.run_feature_stages_batch(jobs)) == 2
    batch = (tdrv.dirs.results_for("tcn") / "s0_tcn.json").read_text()
    tdrv.run_feature_stages("s0", jobs[0][1])
    single = json.loads((tdrv.dirs.results_for("tcn")
                         / "s0_tcn.json").read_text())
    assert single["severity_score"] == pytest.approx(
        json.loads(batch)["severity_score"], abs=2e-4)


def test_process_stream_write_failure_propagates(engines, tmp_path):
    from lameness_tpu.video.decode import VideoReader
    _, tdrv = _drivers(engines, tmp_path, reader=VideoReader)
    jobs = _clips(tmp_path, 1)

    def boom(*a, **k):
        raise RuntimeError("disk full")
    tdrv._write_stage_results_inner = boom
    err = []

    def run():
        try:
            tdrv.process_stream(jobs)
        except RuntimeError as e:
            err.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "process_stream wedged on a write failure"
    assert err and "disk full" in str(err[0])


def test_process_stream_survives_decode_failure(engines, tmp_path):
    """A reader that raises and one that gives no frames: each clip is
    reported to on_decode_failure and gets no result file; the good clip
    completes."""
    from lameness_tpu.video.decode import VideoReader

    class Empty:
        info = {"width": 160, "height": 90, "fps": 5, "total_frames": 0}

        def read_selected(self, indices):
            return {}

    def reader(path):
        if path.name == "corrupt.mp4":
            raise ValueError("not a video")
        if path.name == "empty.mp4":
            return Empty()
        return VideoReader(path)
    _, tdrv = _drivers(engines, tmp_path, reader=reader)
    good = _clips(tmp_path, 1)
    jobs = [("badvid", tmp_path / "corrupt.mp4"), good[0],
            ("emptyvid", tmp_path / "empty.mp4")]
    results, failures = [], []
    t = threading.Thread(target=lambda: results.extend(tdrv.process_stream(
        jobs, on_decode_failure=lambda v, e: failures.append(v))))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "process_stream wedged on a decode failure"
    assert len(results) == 1
    assert (tdrv.dirs.results_for("tcn") / "s0_tcn.json").exists()
    assert not (tdrv.dirs.results_for("tcn") / "badvid_tcn.json").exists()
    assert sorted(failures) == ["badvid", "emptyvid"]


def test_driver_needs_a_reader(engines, tmp_path):
    """Without ``reader=`` the driver decodes with the port's VideoReader on
    the engine's device; a file it cannot open raises."""
    from lameness_tpu_torch.video.decode import VideoReader, write_video
    _, tdrv = _drivers(engines, tmp_path)
    with pytest.raises(IOError, match="failed to open video"):
        tdrv._load_engine_frames(Path("x.mp4"))
    clip = write_video(tmp_path / "c", np.zeros((2, 90, 160, 3), np.uint8),
                       5, device="cpu")
    with tdrv.reader(clip) as vr:
        assert isinstance(vr, VideoReader) and vr.device.type == "cpu"
        assert vr.info["total_frames"] == 2


def test_detector_follows_loaded_yolo(engines, tmp_path):
    """No YOLO weights loaded: curation's motion fallback; once they are,
    the engine's YOLO as the batched detector (the curator built once
    more, then kept)."""
    from lameness_tpu_torch.video.curation import MotionDetector
    _, tdrv = _drivers(engines, tmp_path)
    eng = tdrv.engine
    saved = dict(eng.loaded_weights)
    try:
        eng.loaded_weights["yolo"] = False
        assert isinstance(tdrv.detector, MotionDetector)
        assert tdrv.detector.device.type == "cpu"
        eng.loaded_weights["yolo"] = True
        det = tdrv.detector
        assert det.model is eng.yolo and det.size == eng.spec.yolo_size
        assert tdrv.detector is det and tdrv.curator.detector is det
    finally:
        eng.loaded_weights.update(saved)
