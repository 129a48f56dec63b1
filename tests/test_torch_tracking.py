"""The port's tracking (``lameness_tpu_torch/track``) against the JAX package
on the CPU.

- Kalman (batched and single), assignment (the port's scipy solver against
  the JAX package's native LAPJV) and ByteTrack on the scenarios of
  tests/test_tracking.py plus a seeded 3-cow walk of 200 frames: the same
  tracks frame by frame, and the tracking file of both drivers'
  ``run_tracking`` equal (Re-ID included).
- Re-ID over the port's vector store against JAX's over its own.
- The device tracker on the scenarios of tests/test_device_tracker.py, on
  the CPU: ids and states equal to JAX's, boxes within 1e-4.
"""
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lameness_tpu.io.vecstore import VectorStore as JStore
from lameness_tpu.track import assignment as jassign
from lameness_tpu.track import bytetrack as jbt
from lameness_tpu.track import device_tracker as jdev
from lameness_tpu.track import kalman as jkal
from lameness_tpu.track import reid as jreid
from lameness_tpu_torch.io.vecstore import VectorStore as TStore
from lameness_tpu_torch.track import assignment as tassign
from lameness_tpu_torch.track import bytetrack as tbt
from lameness_tpu_torch.track import device_tracker as tdev
from lameness_tpu_torch.track import kalman as tkal
from lameness_tpu_torch.track import reid as treid

BOX_ATOL = 1e-4


# ---------------------------------------------------------------- kalman ---
def test_kalman_matches_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 100, (5, 2))
    boxes = np.hstack([boxes, boxes + rng.uniform(20, 60, (5, 2))])
    a, b = tkal.KalmanState.create(boxes), jkal.KalmanState.create(boxes)
    for step in range(6):
        np.testing.assert_array_equal(a.predict(), b.predict())
        idx = np.arange(step % 5 + 1)
        obs = boxes[idx] + 3.0 * (step + 1)
        a.update(idx, obs)
        b.update(idx, obs)
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.cov, b.cov)
    s, j = tkal.SingleKalman(boxes[0]), jkal.SingleKalman(boxes[0])
    for i in range(5):
        np.testing.assert_array_equal(s.predict(), j.predict())
        s.update(boxes[0] + i)
        j.update(boxes[0] + i)
    np.testing.assert_array_equal(s.get_state(), j.get_state())
    np.testing.assert_array_equal(tkal.z_to_bbox(tkal.bbox_to_z(boxes)),
                                  jkal.z_to_bbox(jkal.bbox_to_z(boxes)))


# ------------------------------------------------------------ assignment ---
@pytest.mark.parametrize("shape", [(5, 5), (3, 7), (8, 2), (0, 3)])
def test_assignment_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(10):
        cost = rng.uniform(0, 2, shape)
        got, want = tassign.solve(cost), jassign.solve(cost)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    c = np.array([[0.1, 5.0], [5.0, 0.2], [5.0, 5.0]])
    for g, w in zip(tassign.solve(c, 1.0), jassign.solve(c, 1.0)):
        np.testing.assert_array_equal(g, w)
    if shape[0] == shape[1]:
        cost = rng.uniform(0, 2, shape)
        assert tassign.lapjv_square(cost)[2] == pytest.approx(
            jassign.lapjv_square(cost)[2], abs=1e-12)


# ------------------------------------------------------------- bytetrack ---
def _tracks(tracks):
    return [(t.track_id, t.state.name, t.hits, t.age, t.time_since_update,
             np.asarray(t.bbox).tolist()) for t in tracks]


def _lifecycle():
    det = lambda x: [(np.array([x, 0, x + 50, 50.0]), 0.9)]     # noqa
    return [det(5.0 * i) for i in range(3)] + [[] for _ in range(32)]


def _two_objects():
    return [[(np.array([5.0 * i, 0, 5.0 * i + 60, 60]), 0.9),
             (np.array([300 - 5.0 * i, 100, 380 - 5.0 * i, 180]), 0.85)]
            for i in range(10)]


def _low_conf():
    box = np.array([0.0, 0, 60, 60])
    dx = np.array([5.0, 0, 5.0, 0])
    return ([[(box + dx * i, 0.9)] for i in range(3)]
            + [[(box + dx * 3, 0.3)], [(box + dx * 4, 0.05)]])


def _three_cows(t=200, seed=0):
    """Three cows walking in separate lanes at 2-6 px a frame, with jitter,
    10% missed detections and some low-confidence ones."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 300, 3)
    v = rng.uniform(2, 6, 3) * rng.choice([-1, 1], 3)
    frames = []
    for i in range(t):
        dets = []
        for c in range(3):
            if rng.random() < 0.1:
                continue
            x1 = x[c] + v[c] * i + rng.normal(0, 1.0)
            y1 = 150.0 * c + rng.normal(0, 1.0)
            conf = 0.9 if rng.random() > 0.15 else 0.4
            dets.append((np.array([x1, y1, x1 + 200, y1 + 120]), conf))
        frames.append(dets)
    return frames


SCENARIOS = {"lifecycle": _lifecycle, "two_objects": _two_objects,
             "low_conf": _low_conf, "three_cows": _three_cows}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_bytetrack_matches_jax(name):
    tt, jt = tbt.ByteTracker(), jbt.ByteTracker()
    for i, dets in enumerate(SCENARIOS[name]()):
        got = tt.update([tbt.Detection(b, c) for b, c in dets], frame_idx=i)
        want = jt.update([jbt.Detection(b, c) for b, c in dets], frame_idx=i)
        assert _tracks(got) == _tracks(want), i
        assert _tracks(tt.tracks) == _tracks(jt.tracks), i
    assert tt.get_statistics() == jt.get_statistics()
    assert [t.to_dict() for t in tt.tracks] == [t.to_dict()
                                                for t in jt.tracks]


def test_iou_and_associate_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 200, (6, 2))
    a = np.hstack([a, a + 40])
    b = a[::-1] + rng.normal(0, 5, a.shape)
    np.testing.assert_array_equal(tbt.iou_matrix(a, b), jbt.iou_matrix(a, b))
    fa, fb = rng.standard_normal((6, 8)), rng.standard_normal((6, 8))
    np.testing.assert_array_equal(tbt.cosine_distance(fa, fb),
                                  jbt.cosine_distance(fa, fb))
    for feats in ((None, None), (fa, fb)):
        for g, w in zip(tbt.associate(a, b, 0.3, *feats),
                        jbt.associate(a, b, 0.3, *feats)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ reid ---
@pytest.fixture
def uuids(monkeypatch):
    """uuid4 as a counter (both packages' Re-ID name identities by it);
    call the fixture's value to start it again at 0."""
    counter = [itertools.count()]
    monkeypatch.setattr(treid.uuid, "uuid4",
                        lambda: f"id-{next(counter[0])}")

    def reset():
        counter[0] = itertools.count()
    return reset


def test_reid_matches_jax(tmp_path, uuids):
    """The scenarios of tests/test_tracking.py's Re-ID tests, both matchers
    fed the same embeddings."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal(16)
    other = rng.standard_normal(16) * 0.1
    other -= other @ emb / (emb @ emb) * emb
    seq = [emb, emb + rng.standard_normal(16) * 0.01, other, np.ones(16),
           np.r_[5.0, np.ones(15)], other + 0.01]
    t = treid.CowReIDMatcher(TStore(tmp_path / "t.json"), embedding_dim=16)
    got = [t.match_or_create(e, f"v{i}", i) for i, e in enumerate(seq)]
    uuids()
    j = jreid.CowReIDMatcher(JStore(tmp_path / "j.json"), embedding_dim=16)
    want = [j.match_or_create(e, f"v{i}", i) for i, e in enumerate(seq)]
    assert [vars(m) for m in got] == [vars(m) for m in want]
    assert {m.cow_id for m in got} == {"COW-0001", "COW-0002", "COW-0003"}
    for name in ("cow_identities",):
        assert t.store.count(name) == j.store.count(name)
        for pid in (f"id-{k}" for k in range(t.store.count(name))):
            pa, pb = t.store.retrieve(name, pid), j.store.retrieve(name, pid)
            np.testing.assert_array_equal(pa.vector, pb.vector)
            assert pa.payload == pb.payload


# ------------------------------------------------------------ the drivers ---
def test_run_tracking_file_matches_jax(tmp_path, uuids):
    """The 3-cow walk as a yolo file (and a dinov3 file with per-frame
    embeddings): both drivers' ``run_tracking`` (host backend) write equal
    tracking files, Re-ID included."""
    from lameness_tpu.core.config import Config as JConfig
    from lameness_tpu.core.config import DataDirs as JDataDirs
    from lameness_tpu.io import schemas as js
    from lameness_tpu.serve.driver import PipelineDriver as JDriver
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.driver import PipelineDriver
    rng = np.random.default_rng(1)
    frames = _three_cows(seed=1)
    yolo = js.yolo_result(
        [js.yolo_frame_entry(i, 25, [js.yolo_detection_entry(
            i, b, c, "cow", 19) for b, c in dets])
         for i, dets in enumerate(frames)], {}, len(frames), 25)
    dino = js.dinov3_result(
        "walk", rng.standard_normal(768), 8, [], 0.5,
        [js.dinov3_embedding_entry(f, 25, rng.standard_normal(768))
         for f in range(0, 200, 25)])
    files = {}
    for tag in ("jax", "port"):
        uuids()
        root = tmp_path / tag
        for kind, obj in (("yolo", yolo), ("dinov3", dino)):
            js.write_result(root / "results" / kind / f"walk_{kind}.json",
                            obj)
        if tag == "jax":
            drv = JDriver(config=JConfig(dirs=JDataDirs(root=str(root))))
        else:
            drv = PipelineDriver(config=Config(dirs=DataDirs(
                root=str(root))), device="cpu")
        res = drv.run_tracking("walk")
        assert res["total_tracks"] >= 3
        files[tag] = json.loads((root / "results" / "tracking"
                                 / "walk_tracking.json").read_text())
        drv.bus.shutdown()
    assert files["port"] == files["jax"]
    assert len(files["port"]["reid_results"]) == files["port"]["total_tracks"]


def test_run_tracking_device_no_frames_matches_jax(tmp_path):
    """A yolo file whose ``detections`` list is empty: both drivers'
    ``run_tracking(backend="device")`` write equal tracking files with no
    tracks."""
    from lameness_tpu.core.config import Config as JConfig
    from lameness_tpu.core.config import DataDirs as JDataDirs
    from lameness_tpu.io import schemas as js
    from lameness_tpu.serve.driver import PipelineDriver as JDriver
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.driver import PipelineDriver
    files = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        js.write_result(root / "results" / "yolo" / "empty_yolo.json",
                        js.yolo_result([], {}, 0, 25))
        if tag == "jax":
            drv = JDriver(config=JConfig(dirs=JDataDirs(root=str(root))))
        else:
            drv = PipelineDriver(config=Config(dirs=DataDirs(
                root=str(root))), device="cpu")
        res = drv.run_tracking("empty", backend="device")
        assert res["total_tracks"] == 0
        files[tag] = json.loads((root / "results" / "tracking"
                                 / "empty_tracking.json").read_text())
        drv.bus.shutdown()
    assert files["port"] == files["jax"]


# -------------------------------------------------------- device tracker ---
def _two_walkers(t=12, k=4):
    boxes = np.zeros((t, k, 4), np.float32)
    scores = np.zeros((t, k), np.float32)
    valid = np.zeros((t, k), bool)
    for i in range(t):
        boxes[i, 0] = [5.0 * i, 0, 5.0 * i + 60, 60]
        boxes[i, 1] = [300 - 5.0 * i, 200, 380 - 5.0 * i, 280]
        scores[i, :2] = [0.9, 0.85]
        valid[i, :2] = True
    return boxes, scores, valid


def _deletion(t=40, k=2):
    boxes = np.zeros((t, k, 4), np.float32)
    scores = np.zeros((t, k), np.float32)
    valid = np.zeros((t, k), bool)
    for i in range(4):
        boxes[i, 0] = [0, 0, 60, 60]
        scores[i, 0] = 0.9
        valid[i, 0] = True
    return boxes, scores, valid


def _crowded(t=30, k=8, n_obj=5, seed=7):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((t, k, 4), np.float32)
    scores = np.zeros((t, k), np.float32)
    valid = np.zeros((t, k), bool)
    xs = rng.uniform(0, 540, size=n_obj)
    vx = rng.uniform(4, 9, size=n_obj) * rng.choice([-1, 1], size=n_obj)
    for i in range(t):
        for j in range(n_obj):
            if rng.random() < 0.12:
                continue
            x1 = xs[j] + vx[j] * i + rng.normal(0, 1.5)
            y1 = 70.0 * j + rng.normal(0, 1.5)
            boxes[i, j] = [x1, y1, x1 + 70, y1 + 55]
            scores[i, j] = 0.85 if rng.random() > 0.2 else 0.35
            valid[i, j] = True
    return boxes, scores, valid


def _crossing(t=20, k=4):
    boxes = np.zeros((t, k, 4), np.float32)
    scores = np.zeros((t, k), np.float32)
    valid = np.zeros((t, k), bool)
    for i in range(t):
        boxes[i, 0] = [10.0 + 15 * i, 100, 80.0 + 15 * i, 170]
        boxes[i, 1] = [300.0 - 15 * i, 104, 370.0 - 15 * i, 174]
        scores[i, :2] = [0.9, 0.88]
        valid[i, :2] = True
    return boxes, scores, valid


DEVICE_SCENARIOS = {"two_walkers": (_two_walkers, 8),
                    "deletion": (_deletion, 4), "crowded": (_crowded, 16),
                    "crossing": (_crossing, 8),
                    "no_frames": (lambda: _two_walkers(t=0), 8)}


def assert_tracker_outputs(got, want):
    for key in ("track_id", "state", "confirmed"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["boxes"]),
                               np.asarray(want["boxes"]), atol=BOX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(got["score"]),
                               np.asarray(want["score"]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(DEVICE_SCENARIOS))
def test_device_tracker_matches_jax(name):
    make, slots = DEVICE_SCENARIOS[name]
    boxes, scores, valid = make()
    jfinal, jouts = jdev.track_clip(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), max_tracks=slots)
    final, outs = tdev.track_clip(boxes, scores, valid, max_tracks=slots,
                                  device="cpu")
    assert_tracker_outputs({k: v.numpy() for k, v in outs.items()}, jouts)
    assert int(final["next_id"]) == int(jfinal["next_id"])
    np.testing.assert_array_equal(final["state"].numpy(),
                                  np.asarray(jfinal["state"]))


def test_device_tracker_batch_matches_jax():
    boxes, scores, valid = _crowded(t=12, seed=3)
    two = _crowded(t=12, seed=4)
    bb, ss, vv = (np.stack([a, b]) for a, b in zip((boxes, scores, valid),
                                                    two))
    _, jouts = jdev.track_clip_batch(jnp.asarray(bb), jnp.asarray(ss),
                                     jnp.asarray(vv), max_tracks=16)
    _, outs = tdev.track_clip_batch(bb, ss, vv, max_tracks=16, device="cpu")
    assert outs["state"].shape == (2, 12, 16)
    assert_tracker_outputs({k: v.numpy() for k, v in outs.items()}, jouts)


def test_track_detection_frames_matches_jax():
    boxes, scores, valid = _crowded(t=20, seed=5)
    entries = [{"frame": i * 12,
                "detections": [{"bbox": boxes[i, j].tolist(),
                                "confidence": float(scores[i, j])}
                               for j in range(boxes.shape[1]) if valid[i, j]]}
               for i in range(len(boxes))]
    got = tdev.track_detection_frames(entries, device="cpu")
    want = jdev.track_detection_frames(entries)
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert {k: v for k, v in g.items() if k != "bbox"} == \
            {k: v for k, v in w.items() if k != "bbox"}
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_ATOL,
                                   rtol=0)


def test_device_tracker_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    boxes, scores, valid = _two_walkers()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.track_clip(boxes, scores, valid)
