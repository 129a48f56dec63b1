"""The port's annotation renderer (``serve/annotation.py`` over
``serve/raster.py``) against the JAX package's, which draws with OpenCV.

- ``reindex_keypoints`` and ``detect_walking_direction``: equal.
- The rasteriser's primitives against cv2 on seeded random arguments
  (endpoints and centres also off the image): anti-aliased lines at
  thickness 1 and 2, filled and outlined circles, rectangles at thickness
  2 and filled, and ``addWeighted``: bit for bit.  Text (the font table):
  within 1 of cv2 on every pixel.
- ``draw_skeleton``, ``draw_detections`` and ``draw_info_overlay`` against
  JAX's on the same frame (BGR there, RGB here), and a whole render of a
  ``.y4m`` clip with detections, poses and a fusion result.  JAX's frames
  are taken before encoding (its ``write_video`` is replaced in the test,
  and it reads the ``.y4m`` through tests/test_torch_decode.py's cvtColor
  reader), the port's likewise.  Stated tolerance, on each frame: the
  pixels either side changed from the source overlap with IoU >= 0.95 and
  the mean |port - JAX| over their union is <= 6 per channel; tightened
  here, as the rasteriser allows, to every pixel within 1 and every pixel
  outside the text bit for bit.
"""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from lameness_tpu.core import config as jconfig
from lameness_tpu.serve import annotation as jann
from lameness_tpu_torch.core import config as tconfig
from lameness_tpu_torch.serve import annotation as tann
from lameness_tpu_torch.serve import raster
from lameness_tpu_torch.video.decode import VideoReader, write_video
from test_torch_decode import JaxY4MReader

H, W = 90, 160


def _keypoints(rng, n=20, w=W, h=H, names=False):
    out = []
    for i in range(n):
        kp = {"x": float(rng.uniform(-10, w + 10)),
              "y": float(rng.uniform(-10, h + 10)),
              "confidence": float(rng.uniform(0, 1))}
        if names and i % 3 == 0:
            kp["name"] = rng.choice(jann.KEYPOINT_NAMES + list(jann._SYNONYMS)
                                    + ["Left Front Paw", "unknown"])
        else:
            kp["id"] = int(rng.integers(-2, 22))
        out.append(kp)
    return out


def _bgr_to_port(frame):
    return torch.from_numpy(np.ascontiguousarray(frame[..., ::-1]))


def _as_bgr(t):
    return t.numpy()[..., ::-1]


def check_frames(got, want, src, text_mask=None):
    """The stated tolerance (IoU of the changed pixels >= 0.95, mean
    difference over their union <= 6), and the tighter one: within 1
    everywhere, bit for bit outside ``text_mask``."""
    got, want, src = (np.asarray(a, np.int64) for a in (got, want, src))
    cg = (got != src).any(-1)
    cw = (want != src).any(-1)
    union = cg | cw
    if union.any():
        assert (cg & cw).sum() / union.sum() >= 0.95
        assert np.abs(got - want)[union].mean() <= 6
    assert np.abs(got - want).max() <= 1
    if text_mask is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[~text_mask], want[~text_mask])


def test_reindex_and_direction_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        raw = _keypoints(rng, n=int(rng.integers(0, 30)), names=True)
        kj = jann.reindex_keypoints(raw)
        assert tann.reindex_keypoints(raw) == kj
        assert tann.detect_walking_direction(kj) == \
            jann.detect_walking_direction(kj)
    kps = [{"x": 0.0, "y": 0.0, "confidence": 0.0} for _ in range(20)]
    assert tann.detect_walking_direction(kps) == "unknown"


@pytest.mark.parametrize("kind", ["line1", "line2", "disc", "ring", "rect2",
                                  "box"])
def test_primitives_match_cv2(kind):
    rng = np.random.default_rng(["line1", "line2", "disc", "ring", "rect2",
                                 "box"].index(kind))
    h, w = 60, 80
    for _ in range(150):
        bg = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        p1 = (int(rng.integers(-12, w + 12)), int(rng.integers(-12, h + 12)))
        p2 = (int(rng.integers(-12, w + 12)), int(rng.integers(-12, h + 12)))
        ref = bg.copy()
        if kind in ("line1", "line2"):
            t = 1 if kind == "line1" else 2
            cv2.line(ref, p1, p2, color, t, cv2.LINE_AA)
            ops = raster.thick_line_aa(w, h, p1, p2, t)
        elif kind in ("disc", "ring"):
            r = int(rng.integers(1, 12))
            cv2.circle(ref, p1, r, color, -1 if kind == "disc" else 1,
                       cv2.LINE_AA)
            ops = raster.circle_aa(w, h, p1, r, kind == "disc")
        else:
            t = 2 if kind == "rect2" else -1
            cv2.rectangle(ref, p1, p2, color, t)
            ops = raster.rectangle(w, h, p1, p2, t)
        got = torch.from_numpy(bg[None].copy())
        raster.apply(got, [(0, ops, color)])
        np.testing.assert_array_equal(got[0].numpy(), ref)


def test_add_weighted_matches_cv2_every_pair():
    v = np.arange(256, dtype=np.uint8)
    a, b = np.meshgrid(v, v, indexing="ij")
    want = cv2.addWeighted(a, 0.55, b, 0.45, 0)
    got = raster.add_weighted(torch.from_numpy(a), 0.55,
                              torch.from_numpy(b), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)


def test_text_within_one_of_cv2():
    rng = np.random.default_rng(3)
    strings = ["".join(chr(c) for c in range(32, 127)),
               "video: 3f2a9c1e-77b0", "frame: 124",
               "direction: right_to_left", "lameness: 63.2%", "cow 0.87"]
    for s in strings:
        for color in ((255, 255, 255), (0, 200, 0), (17, 99, 230)):
            bg = rng.integers(0, 256, (40, 900, 3), dtype=np.uint8)
            org = (int(rng.integers(-5, 20)), int(rng.integers(5, 40)))
            ref = bg.copy()
            cv2.putText(ref, s, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                        cv2.LINE_AA)
            got = torch.from_numpy(bg[None].copy())
            raster.apply(got, [(0, raster.text(900, 40, s, org), color)])
            d = np.abs(got[0].numpy().astype(int) - ref.astype(int))
            assert d.max() <= 1, (s, color)


def test_draw_functions_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        src = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        kps = _keypoints(rng)
        want = jann.draw_skeleton(src.copy(), kps)
        got = tann.draw_skeleton(_bgr_to_port(src), kps)
        check_frames(_as_bgr(got), want, src)

        dets = [{"bbox": [float(v) for v in sorted(rng.uniform(-10, W, 2))]
                 + [float(v) for v in sorted(rng.uniform(-10, H, 2))],
                 "confidence": float(rng.uniform()), "class": "cow"}
                for _ in range(int(rng.integers(0, 3)))]
        dets = [{**d, "bbox": [d["bbox"][0], d["bbox"][2], d["bbox"][1],
                               d["bbox"][3]]} for d in dets] + [{"bbox": []}]
        want = jann.draw_detections(src.copy(), dets)
        got = tann.draw_detections(_bgr_to_port(src), dets)
        text = np.zeros((H, W), bool)
        for d in dets[:-1]:
            x, y = int(d["bbox"][0]), max(12, int(d["bbox"][1]) - 5)
            text[max(y - 12, 0):y + 6, max(x - 2, 0):] = True
        check_frames(_as_bgr(got), want, src, text)

        lines = ["video: 3f2a9c1e-77b", f"frame: {int(rng.integers(200))}",
                 "direction: left_to_right", "lameness: 41.7%"]
        want = jann.draw_info_overlay(src.copy(), lines)
        got = tann.draw_info_overlay(_bgr_to_port(src), lines)
        # text bit for bit aside, every pixel (the dark box's blend too)
        text = np.zeros(H * W, bool)
        for ops, _ in tann.overlay_text_draws(W, H, lines):
            text[ops[0]] = True
        check_frames(_as_bgr(got), want, src, text.reshape(H, W))


RH, RW = 180, 320           # the render's frames: room beside the overlay


def _write_inputs(root_j, root_t, rng, n=40):
    frames = rng.integers(0, 256, (n, RH, RW, 3), dtype=np.uint8)
    path = write_video(root_t / "clip", frames, 10, device="cpu")
    dets, poses = [], []
    for f in range(0, n, 5):
        x1, y1 = rng.uniform(0, 200), rng.uniform(0, 110)
        dets.append({"frame": f, "time": f / 10, "detections": [
            {"frame": f, "bbox": [x1, y1, x1 + 110, y1 + 60],
             "confidence": float(rng.uniform(0.5, 1)), "class": "cow",
             "class_id": 19}]})
    for f in range(0, n, 10):
        poses.append({"frame": f, "bbox": [0, 0, RW, RH],
                      "keypoints": _keypoints(rng, w=RW, h=RH, names=True)})
    files = {"yolo": {"detections": dets},
             "tleap": {"pose_sequences": poses},
             "fusion": {"fusion_result": {"final_probability": 0.4172}}}
    for root in (root_j, root_t):
        for kind, data in files.items():
            d = root / "results" / kind
            d.mkdir(parents=True, exist_ok=True)
            (d / f"rv_{kind}.json").write_text(json.dumps(data))
    return path, dets


def _text_mask(i, dets):
    """Where text stands on frame ``i``: the overlay box, and a band round
    the label of the detection nearest the frame (within 15 frames)."""
    m = np.zeros((RH, RW), bool)
    m[5:5 + 8 * 2 + 20 * 4 + 1, 5:5 + 24 * 9 + 17] = True
    near = min(dets, key=lambda d: abs(d["frame"] - i))
    if abs(near["frame"] - i) <= 15:
        b = near["detections"][0]["bbox"]
        x, y = int(b[0]), max(12, int(b[1]) - 5)
        m[max(y - 13, 0):y + 6, max(x - 2, 0):x + 80] = True
    return m


def test_render_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    root_j, root_t = tmp_path / "jax", tmp_path / "port"
    path, dets = _write_inputs(root_j, root_t, rng)
    jcfg = jconfig.Config.load(data_root=str(root_j))
    tcfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(root_t)))
    caught = {}
    monkeypatch.setattr(jann, "VideoReader", JaxY4MReader)
    monkeypatch.setattr(jann, "write_video",
                        lambda p, frames, fps: caught.update(jax=frames))
    jr = jann.AnnotationRenderer(jcfg.dirs)
    assert jr.render("rv", video_path=path) is not None
    real_write = tann.write_video

    def keep(p, frames, fps):
        caught["port"] = frames.clone()
        return real_write(p, frames, fps)
    monkeypatch.setattr(tann, "write_video", keep)
    tr = tann.AnnotationRenderer(tcfg.dirs, device="cpu")
    out = tr.render("rv", video_path=path)
    assert out == root_t / "annotated" / "rv_annotated.mp4"
    assert tr.status["rv"] == {"status": "completed", "output": str(out),
                               "frames": 40}
    with VideoReader(out, device="cpu") as vr:
        assert vr.info["total_frames"] == 40
    with VideoReader(path, device="cpu") as vr:
        src = vr.read_sampled()[0]              # the source frames, RGB
    want = np.stack(caught["jax"])
    got = caught["port"].numpy()
    assert got.shape == want.shape == (40, RH, RW, 3)
    for i in range(40):
        check_frames(got[i], want[i], src[i], _text_mask(i, dets))


def test_render_missing_video(tmp_path):
    tcfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(tmp_path)))
    r = tann.AnnotationRenderer(tcfg.dirs, device="cpu")
    assert r.render("ghost") is None
    assert r.status["ghost"] == {"status": "failed",
                                 "error": "video not found"}
