"""Clip curation: raw upload -> canonical 5 s, 25 fps, 1280x720,
left->right (port of ``lameness_tpu/video/curation.py``).

Walking-pass segmentation, the six-metric window score, the window slide,
the right->left flip and the quality report are the JAX module's,
line for line (clip-curation:61-704).  One decode pass caches each frame's
detection and visual-quality score, and the window scores are arithmetic
over that cache.

What runs where:
- the track pass reads each chunk of raw I420 frames from the decoder
  (``video/decode.py``) and sends it to the curator's device, which
  converts it to RGB (``yuv.i420_to_rgb``, cv2's conversion bit for bit),
  to gray (``yuv.rgb_to_gray``) and computes each frame's Laplacian and
  brightness sums; the host reads back one row of integer sums a frame
  (and the RGB frames once a chunk, for the frame cache) and finishes
  ``blur_score`` and ``brightness_score`` in float64 as numpy does;
- the motion fallback (``MotionDetector``) is cv2's MOG2 (history 50,
  varThreshold 32, cv2's defaults for the rest) as tensor ops on the
  device, one frame after another, then a 5x5 opening as min and max
  pools; a chunk's masks are read back once, and the host finds each
  frame's largest outer contour (``serve/contours.py``);
- ``BatchedYoloDetector`` letterboxes and runs YOLO over a chunk of frames
  in one forward (ceil(F/chunk) dispatches for F frames, the ragged tail
  chunk zero-padded), and picks each frame's detection with
  ``_best_detection`` (clip-curation:103-131: a cow, or any detection over
  10% of the frame, the largest).  Boxes are not clipped to the frame, as
  in the JAX package.  ``detect_stream`` issues chunk k+1's copy to the
  device before it reads chunk k back, on the side streams of
  ``core/streams.py``;
- the canonical clip is resized to 1280x720 on the host by
  ``video/image.py``'s bilinear ``rows_at`` (cv2's INTER_LINEAR within 1), flipped when the
  cow walks right to left, and written as ``<id>_canonical.y4m``.

Frames handed to a detector are BGR by the reference's convention
(OpenCV's); the flip from RGB is a view.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.streams import Overlap, host_to_device
from ..io import schemas
from ..models.yolo import detect as yolo_detect
from ..ops.preprocess import letterbox, unletterbox_boxes
from ..serve.contours import largest_external_contour
from ..utils.timing import StageTimers
from .decode import VideoReader, write_video
from .image import rows_at
from .yuv import i420_to_rgb, i420_to_rgb_device, rgb_to_gray, rgb_to_i420

TARGET_FPS = 25
TARGET_RESOLUTION = (1280, 720)
CANONICAL_DURATION = 5.0
MIN_PASS_FRAMES = 30
PROGRESS_BAND = (0.25, 0.85)
# frames a chunk of the track pass (a detector's own chunk if it has one)
TRACK_CHUNK = 16
# host threads for the motion detector's contours (numpy and scipy release
# the GIL)
CONTOUR_WORKERS = min(4, os.cpu_count() or 1)

Detector = Callable[[np.ndarray], Optional[Dict[str, Any]]]


@dataclass
class WalkingPass:
    start_frame: int
    end_frame: int
    direction: str
    centroids: List[Tuple[float, float]]
    bboxes: List[List[float]]
    confidences: List[float]
    normalized_progress: List[float] = field(default_factory=list)
    frame_indices: List[int] = field(default_factory=list)


@dataclass
class QualityMetrics:
    framing_score: float
    steadiness_score: float
    straightness_score: float
    visual_quality_score: float
    occlusion_score: float
    overall_score: float


@dataclass
class ClipCandidate:
    start_frame: int
    end_frame: int
    start_time: float
    end_time: float
    metrics: QualityMetrics
    needs_flip: bool


# ---------------------------------------------------------------------------
# the motion fallback: cv2's MOG2 on the device
# ---------------------------------------------------------------------------
def _f32(x: float) -> float:
    """``x`` rounded to float32 (every constant below is one: a tensor op
    with it then rounds as cv2's float arithmetic does)."""
    return float(np.float32(x))


class MOG2:
    """``cv2.createBackgroundSubtractorMOG2(history, varThreshold)`` with
    cv2's other defaults (5 mixtures, background ratio 0.9, varThresholdGen
    9, varInit 15, varMin 4, varMax 75, complexity reduction 0.05, shadows
    127 at threshold 0.5), as cv2's CPU ``MOG2Invoker`` computes it, over
    every pixel at once: each float32 operation in cv2's order, the
    per-pixel mode loop unrolled over the 5 mixtures with masks.  A fitted
    mode's climb up the weight order, and a new mode's, are rotations of
    the mode axis.  The learning rate is 1/min(2 nframes, history); a frame
    of another size starts the model again.  ``apply(frame)``: (H, W, 3)
    uint8 BGR on the model's device -> (H, W) uint8 mask (0, 127 or 255)."""

    K = 5
    TB = _f32(0.9)                   # background ratio
    TG = 9.0                         # varThresholdGen
    VAR_INIT, VAR_MIN, VAR_MAX = 15.0, 4.0, 75.0
    CT = float(np.float32(0.05))     # complexity reduction (a float member)
    TAU = 0.5
    SHADOW = 127

    def __init__(self, history: int = 50, var_threshold: float = 32.0,
                 device=None):
        self.history = history
        self.tb = _f32(var_threshold)
        self.device = resolve_device(device)
        self.shape = None
        self.nframes = 0

    def _init(self, shape):
        k, p = self.K, shape[0] * shape[1]
        z = dict(dtype=torch.float32, device=self.device)
        self.w = torch.zeros((k, p), **z)
        self.var = torch.zeros((k, p), **z)
        self.mean = torch.zeros((k, 3, p), **z)
        self.n = torch.zeros(p, dtype=torch.int64, device=self.device)
        self.shape, self.nframes = shape, 0

    def _rotate(self, lo, hi, on):
        """Move the mode at position ``hi`` up to ``lo`` where ``on``, the
        modes at lo..hi-1 one down (lo, hi: (P,) positions)."""
        j = torch.arange(self.K, device=self.device)[:, None]
        band = on & (j >= lo) & (j <= hi)
        src = torch.where(band, torch.where(j == lo, hi, j - 1), j)
        self.w = torch.gather(self.w, 0, src)
        self.var = torch.gather(self.var, 0, src)
        self.mean = torch.gather(self.mean, 0,
                                 src[:, None, :].expand(self.mean.shape))

    def _climb(self, weight, pos, on, before):
        """How many places the mode at ``pos`` climbs: the run of modes
        just above it, nearest first, whose weight ``before`` (K, P) it
        does not fall below."""
        steps = torch.zeros_like(pos)
        going = on.clone()
        for t in range(1, self.K):
            j = pos - t
            above = torch.gather(before, 0, j.clamp(min=0)[None])[0]
            going &= (j >= 0) & ~(weight < above)
            steps += going
        return steps

    def apply(self, frame: torch.Tensor) -> torch.Tensor:
        h, w = frame.shape[:2]
        if self.shape != (h, w) or self.nframes == 0:
            self._init((h, w))
        self.nframes += 1
        lr = 1.0 / min(2 * self.nframes, self.history)
        a = _f32(lr)
        a1 = _f32(np.float32(1.0) - np.float32(a))
        prune = _f32(-lr * self.CT)
        x = frame.reshape(h * w, 3).t().float()            # (3, P) B, G, R
        k_modes, p = self.K, h * w
        n = self.n.clone()
        fits = torch.zeros(p, dtype=torch.bool, device=self.device)
        bg = torch.zeros_like(fits)
        total = torch.zeros(p, dtype=torch.float32, device=self.device)
        fit_pos = torch.zeros_like(n)
        fit_w = torch.zeros_like(total)
        new_w = self.w.clone()
        for m in range(k_modes):
            act = n > m                                    # nmodes shrinks
            weight = self.w[m] * a1 + prune
            chk = act & ~fits
            var = self.var[m]
            d = self.mean[m] - x
            sq = d * d
            dist2 = sq[0] + sq[1] + sq[2]
            bg |= chk & (total < self.TB) & (dist2 < var * self.tb)
            fit = chk & (dist2 < var * self.TG)
            wf = weight + a
            k = torch.full_like(wf, a) / wf
            self.mean[m] = torch.where(fit, self.mean[m] - k * d,
                                       self.mean[m])
            vn = (var + k * (dist2 - var)).clamp(self.VAR_MIN, self.VAR_MAX)
            self.var[m] = torch.where(fit, vn, var)
            weight = torch.where(fit, wf, weight)
            fits |= fit
            fit_pos = torch.where(fit, m, fit_pos)
            fit_w = torch.where(fit, wf, fit_w)
            pruned = act & (weight < -prune)
            weight = torch.where(pruned, 0.0, weight)
            n -= pruned.long()
            new_w[m] = torch.where(act, weight, self.w[m])
            total = torch.where(act, total + weight, total)
        self.w = new_w
        self._rotate(fit_pos - self._climb(fit_w, fit_pos, fits, new_w),
                     fit_pos, fits)
        # renormalise the modes in use
        inv = torch.where(total.abs() > np.finfo(np.float32).eps,
                          torch.ones_like(total) / total, 0.0)
        j = torch.arange(k_modes, device=self.device)[:, None]
        self.w = torch.where(j < n, self.w * inv, self.w)
        # no fit: a new mode (the weakest replaced when all are in use)
        new = ~fits
        mode = torch.where(n == k_modes, k_modes - 1, n)
        n = torch.where(new & (n < k_modes), n + 1, n)
        scale = new & (n > 1) & (j < n - 1)
        self.w = torch.where(scale, self.w * a1, self.w)
        at = new & (j == mode)
        self.w = torch.where(at, torch.where(n == 1, 1.0, a), self.w)
        self.var = torch.where(at, self.VAR_INIT, self.var)
        self.mean = torch.where(at[:, None], x[None], self.mean)
        self._rotate(mode - self._climb(
            torch.full_like(total, a), mode, new & (n > 1), self.w),
            mode, new)
        self.n = n
        shadow = self._shadow(x)
        out = torch.where(bg, 0, torch.where(shadow, self.SHADOW, 255))
        return out.to(torch.uint8).reshape(h, w)

    def _shadow(self, x: torch.Tensor) -> torch.Tensor:
        """cv2's ``detectShadowGMM`` over the modes in order."""
        p = x.shape[1]
        done = torch.zeros(p, dtype=torch.bool, device=self.device)
        shadow = torch.zeros_like(done)
        t_weight = torch.zeros(p, dtype=torch.float32, device=self.device)
        for m in range(self.K):
            act = (self.n > m) & ~done
            mu = self.mean[m]
            xm, mm = x * mu, mu * mu
            num = xm[0] + xm[1] + xm[2]
            den = mm[0] + mm[1] + mm[2]
            zero = act & (den == 0)
            near = (num <= den) & (num >= den * self.TAU)
            a = num / den
            dd = a * mu - x
            dd = dd * dd
            dist2a = dd[0] + dd[1] + dd[2]
            hit = act & ~zero & near & (
                dist2a < self.var[m] * self.tb * a * a)
            shadow |= hit
            go = act & ~zero & ~hit
            t_weight = torch.where(go, t_weight + self.w[m], t_weight)
            done |= zero | hit | (go & (t_weight > self.TB))
        return shadow


def open_5x5(masks: torch.Tensor) -> torch.Tensor:
    """``cv2.morphologyEx(m, MORPH_OPEN, np.ones((5, 5)))`` of (N, H, W)
    uint8 masks: a 5x5 min pool then a 5x5 max pool, the pixels outside
    the frame ignored (cv2's default border)."""
    x = masks[:, None].float()
    pool = torch.nn.functional.max_pool2d
    x = -pool(-x, 5, stride=1, padding=2)
    return pool(x, 5, stride=1, padding=2)[:, 0].to(torch.uint8)


def mask_detection(mask: np.ndarray) -> Optional[Dict[str, Any]]:
    """The motion detector's pick from an opened mask: the largest outer
    contour of its non-zero pixels (shadows count), if its area is at
    least 2% of the frame."""
    found = largest_external_contour(mask)
    if found is None:
        return None
    area, _, (x, y, bw, bh) = found
    h, w = mask.shape[:2]
    if area < 0.02 * h * w:
        return None
    return {"bbox": [float(x), float(y), float(x + bw), float(y + bh)],
            "confidence": min(1.0, area / (0.1 * h * w)),
            "centroid": (x + bw / 2, y + bh / 2),
            "area": float(bw * bh)}


class MotionDetector:
    """Weight-free fallback: MOG2 background subtraction, a 5x5 opening,
    the largest blob.  Stateful: frames must come in order.
    ``detect_frames`` takes a chunk of BGR frames on the device and reads
    its masks back once; calling it with one host BGR frame is the
    per-frame Detector protocol."""

    def __init__(self, device=None, history: int = 50,
                 var_threshold: float = 32.0):
        self.mog2 = MOG2(history, var_threshold, device=device)
        self.device = self.mog2.device

    def masks(self, frames_bgr: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 BGR on the device -> (N, H, W) opened masks."""
        raw = torch.stack([self.mog2.apply(f) for f in frames_bgr])
        return open_5x5(raw)

    def detect_frames(self, frames_bgr: torch.Tensor
                      ) -> List[Optional[Dict[str, Any]]]:
        """The chunk's detections: its masks read back once, each frame's
        contour on one of ``CONTOUR_WORKERS`` host threads."""
        masks = self.masks(frames_bgr).cpu().numpy()
        with ThreadPoolExecutor(max_workers=CONTOUR_WORKERS) as pool:
            return list(pool.map(mask_detection, masks))

    def __call__(self, frame_bgr: np.ndarray) -> Optional[Dict[str, Any]]:
        dev = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(
            self.device)
        return self.detect_frames(dev[None])[0]


def motion_detector(device=None) -> MotionDetector:
    """The weight-free fallback detector (the reference's degradation,
    clip-curation:103-131)."""
    return MotionDetector(device=device)


# ---------------------------------------------------------------------------
# the YOLO detectors
# ---------------------------------------------------------------------------
def _best_detection(boxes, scores, classes, valid, h: int, w: int,
                    cow_class_id: int) -> Optional[Dict[str, Any]]:
    """clip-curation:103-131 selection: accept cow class or any detection
    > 10% of frame, keep largest (shared by the per-frame and batched
    curation detectors so their outputs are identical by construction)."""
    best = None
    best_area = 0.0
    for b, s, c, v in zip(boxes, scores, classes, valid):
        if not v:
            continue
        area = max(0.0, (b[2] - b[0]) * (b[3] - b[1]))
        if (c == cow_class_id or area > 0.1 * h * w) and area > best_area:
            best_area = area
            best = {"bbox": [float(x) for x in b],
                    "confidence": float(s),
                    "centroid": ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2),
                    "area": float(area)}
    return best


class BatchedYoloDetector:
    """Chunked YOLO curation detector on the model's device.

    ``model`` is the port's ``YoloV8`` with its weights (the engine's
    ``yolo``); it runs in ``dtype`` (default: its convolutions' dtype, the
    engine's YOLO dtype).  ``chunk`` defaults to ``LAMENESS_CURATION_CHUNK``
    or 16; ``transfer`` ('rgb' or 'yuv420') to ``_resolve_transfer``.
    ``dispatches`` counts the chunk forwards."""

    def __init__(self, model, conf: float = 0.3, cow_class_id: int = 19,
                 size: int = 640, chunk: Optional[int] = None,
                 transfer: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        if chunk is None:
            env = os.environ.get("LAMENESS_CURATION_CHUNK")
            chunk = int(env) if env else 16
        self.model = model
        self.conf = conf
        self.size = size
        self.chunk = int(chunk)
        self.cow_class_id = cow_class_id
        self.transfer = transfer         # None -> _resolve_transfer
        self.dtype = dtype or model.stem.conv.weight.dtype
        self.device = model.stem.conv.weight.device
        self.dispatches = 0              # observable dispatch counter

    @torch.no_grad()
    def _batched(self, frames_rgb: torch.Tensor):
        """(N, H, W, 3) uint8 RGB on the device -> f32 boxes in frame
        pixels (N, 8, 4), scores, classes and valid flags (N, 8)."""
        canvas, ratio, pad = letterbox(frames_rgb, self.size)
        out = self.model(canvas.to(self.dtype))
        det = yolo_detect(out["levels"], conf_threshold=self.conf,
                          max_det=8)
        boxes = unletterbox_boxes(det["boxes"].float(), ratio, pad)
        return boxes, det["scores"].float(), det["classes"], det["valid"]

    def _resolve_transfer(self, h: int, w: int) -> str:
        """'rgb', or 'yuv420' with ``LAMENESS_YUV_INGEST=1`` (the engine's
        ingest switch, read at each call) or ``transfer='yuv420'``; odd
        geometries, which I420 cannot represent, always 'rgb'."""
        if h % 2 or w % 2:
            return "rgb"
        if self.transfer:
            return self.transfer
        return "yuv420" if os.environ.get("LAMENESS_YUV_INGEST") == "1" \
            else "rgb"

    def detect_stream(self, chunk_iter, timers=None
                      ) -> List[Optional[Dict[str, Any]]]:
        """Pipelined loop over an iterator of (count, rgb_chunk).

        rgb_chunk: (bs, H, W, 3) uint8 RGB with ``count`` valid leading
        rows (tail chunks zero-padded to a fixed bs).  Chunk k+1's copy to
        the device is issued before chunk k's outputs are read back, so the
        copy and the host's preparation of the next chunk overlap the
        device's work on this one."""
        results: List[Optional[Dict[str, Any]]] = []
        lanes = Overlap(self.device)
        pending = None
        prep = fn = None

        def consume(item):
            count, h, w, wait = item
            boxes, scores, classes, valid = wait()
            for i in range(count):
                results.append(_best_detection(
                    boxes[i], scores[i], classes[i], valid[i], h, w,
                    self.cow_class_id))

        for count, chunk in chunk_iter:
            h, w = chunk.shape[1:3]
            if fn is None:
                if self._resolve_transfer(h, w) == "yuv420":
                    prep, fn = rgb_to_i420, (
                        lambda d: self._batched(i420_to_rgb_device(d)))
                else:
                    prep, fn = (lambda c: c), self._batched
            with (timers.time("curation.detect") if timers
                  else contextlib.nullcontext()):
                dev = lanes.put(lambda: host_to_device(prep(chunk),
                                                       self.device))
                wait = lanes.fetch(fn(dev))
                self.dispatches += 1
                if pending is not None:
                    consume(pending)
                pending = (count, h, w, wait)
        if pending is not None:
            consume(pending)
        return results

    def detect_batch(self, frames: np.ndarray, *, bgr: bool = True
                     ) -> List[Optional[Dict[str, Any]]]:
        """(N, H, W, 3) uint8 -> N best-detection dicts (or None).
        ``bgr=False`` takes RGB directly.  A single frame runs a batch of
        one instead of a zero-padded chunk."""
        n, h, w = frames.shape[:3]
        rgb = frames[..., ::-1] if bgr else frames
        bs = 1 if n == 1 else self.chunk

        def chunks():
            for o in range(0, n, bs):
                c = rgb[o:o + bs]
                if len(c) < bs:
                    c = np.concatenate(
                        [c, np.zeros((bs - len(c), h, w, 3), np.uint8)],
                        axis=0)
                yield min(bs, n - o), c

        return self.detect_stream(chunks())

    def __call__(self, frame_bgr: np.ndarray) -> Optional[Dict[str, Any]]:
        return self.detect_batch(frame_bgr[None])[0]


def yolo_detector(model, conf: float = 0.3, cow_class_id: int = 19,
                  size: int = 640) -> Detector:
    """YOLO as a per-frame curation detector (BGR frame -> best detection
    or None, clip-curation:103-131): one forward per frame.  Prefer
    ``BatchedYoloDetector`` for many frames."""
    return BatchedYoloDetector(model, conf=conf, cow_class_id=cow_class_id,
                               size=size, chunk=1)


# ---------------------------------------------------------------------------
# per-frame quality stats (single streaming pass)
# ---------------------------------------------------------------------------
def gray_sums(gray: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 gray -> (N, 3) int64 on its device: the sum and the
    sum of squares of cv2's ``Laplacian(gray, CV_64F)`` (ksize 1: the
    4-neighbour kernel, BORDER_REFLECT_101), and the sum of the gray
    values.  Every value is an integer, so the sums are exact."""
    g = gray.to(torch.int32)
    h, w = g.shape[-2:]
    dev = g.device
    rows = torch.tensor([1] + list(range(h)) + [h - 2], device=dev)
    cols = torch.tensor([1] + list(range(w)) + [w - 2], device=dev)
    pad = g[:, rows][:, :, cols]
    lap = (pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
           + pad[:, 1:-1, 2:] - 4 * g)
    return torch.stack([lap.sum((1, 2), dtype=torch.int64),
                        (lap * lap).sum((1, 2), dtype=torch.int64),
                        g.sum((1, 2), dtype=torch.int64)], dim=1)


def _scores(sums, n: int) -> Tuple[float, float]:
    """(blur, brightness) of one frame's ``gray_sums`` row over ``n``
    pixels: the variance and the mean as exact fractions, each rounded once
    (numpy's float64 ``var`` and ``mean`` within 1e-12 relative, the mean
    exactly)."""
    s1, s2, sg = (int(v) for v in sums)
    var = (n * s2 - s1 * s1) / (n * n)
    blur = min(1.0, var / 500.0)
    bright = max(0.0, 1.0 - abs(sg / n - 128) / 128)
    return blur, bright


def _as_gray(gray) -> torch.Tensor:
    g = gray if isinstance(gray, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(gray))
    return g[None]


def blur_score(gray) -> float:
    """Laplacian variance / 500, capped at 1 (clip-curation:351-356)."""
    g = _as_gray(gray)
    return _scores(gray_sums(g)[0].tolist(), g[0].numel())[0]


def brightness_score(gray) -> float:
    """1 - |mean-128|/128 (clip-curation:358-365)."""
    g = _as_gray(gray)
    return _scores(gray_sums(g)[0].tolist(), g[0].numel())[1]


def visual_scores(rgb: torch.Tensor) -> List[float]:
    """(N, H, W, 3) uint8 RGB on the device -> each frame's
    (blur_score + brightness_score) / 2 of its gray, one readback."""
    sums = gray_sums(rgb_to_gray(rgb)).tolist()
    n = rgb.shape[1] * rgb.shape[2]
    return [sum(_scores(s, n)) / 2 for s in sums]


class ClipCurator:
    """Curation of one raw upload at a time.  ``detector``: the motion
    fallback (``MotionDetector``) when None, or any Detector; one with
    ``detect_stream`` (``BatchedYoloDetector``) is fed chunks from a
    producer thread.  ``device``: where frames are converted and scored
    (the card unless "cpu")."""

    def __init__(self, dirs, detector: Optional[Detector] = None,
                 bus=None, subjects=None, timers=None, device=None):
        self.dirs = dirs
        self.device = resolve_device(device)
        self.detector = detector or motion_detector(self.device)
        self.bus = bus
        self.subjects = subjects
        self.timers = timers or StageTimers()
        self.canonical_dir = dirs.canonical
        self.reports_dir = dirs.quality_reports
        self._frame_cache: Optional[Dict[str, Any]] = None
        self.canonical_dir.mkdir(parents=True, exist_ok=True)
        self.reports_dir.mkdir(parents=True, exist_ok=True)

    # -- stage 1: one decode pass -------------------------------------------
    def _cache_frame(self, cache: Dict[str, Any], frame: np.ndarray):
        """Retain a decoded frame for downstream reuse (canonical/backup
        extraction and the driver's preprocess crop read the same raw
        upload).  The cache is byte-capped (LAMENESS_FRAME_CACHE_MB,
        default 2048); past the cap it is dropped whole and every consumer
        falls back to its own decode, so outputs never depend on cache
        state."""
        if cache["frames"] is None:
            return
        cache["bytes"] += frame.nbytes
        if cache["bytes"] > cache["cap"]:
            cache["frames"] = None
        else:
            cache["frames"].append(frame)

    @staticmethod
    def _cache_cap_bytes() -> int:
        return int(float(os.environ.get(
            "LAMENESS_FRAME_CACHE_MB", "2048")) * 1e6)

    def take_frame_cache(self, video_path: Path
                         ) -> Optional[Dict[str, Any]]:
        """Pop the one-video decoded-frame cache if it matches
        ``video_path`` (the driver's preprocess calls this; popping frees
        the memory once the last consumer is done)."""
        fc = self._frame_cache
        self._frame_cache = None
        if fc and fc["frames"] is not None \
                and fc["path"] == Path(video_path).resolve():
            return fc
        return None

    def track_cow_through_video(self, video_path: Path):
        """Detection + visual-quality stats for every frame in one pass.

        A detector exposing ``detect_stream`` (BatchedYoloDetector) runs
        once per chunk of frames, fed by a producer thread that decodes
        and scores; a stateful detector (MOG2 needs frame order) runs on
        each chunk in the calling thread."""
        batch_fn = getattr(self.detector, "detect_stream", None)
        cache = {"path": Path(video_path).resolve(), "frames": [],
                 "bytes": 0, "cap": self._cache_cap_bytes(), "info": None}
        self._frame_cache = None
        if batch_fn is None:
            detections, info, visual = self._track_serial(video_path, cache)
        else:
            detections, info, visual = self._track_streamed(
                video_path, cache, batch_fn)
        if cache["frames"] is not None:
            cache["info"] = info
            self._frame_cache = cache
        return detections, info, visual

    def _chunks(self, vr: VideoReader, cache, size: int, host: bool):
        """Each chunk of the upload: (first index, RGB on the device, RGB
        on the host or None, visual scores).  The host copy is read back
        once a chunk, when the cache or ``host`` wants it."""
        for start, i420 in vr.i420_chunks(size):
            rgb = i420_to_rgb(host_to_device(i420, self.device))
            visual = visual_scores(rgb)
            frames = None
            if host or cache["frames"] is not None:
                frames = rgb.cpu().numpy()
                for f in frames:
                    self._cache_frame(cache, f)
            yield start, rgb, frames, visual

    def _track_serial(self, video_path: Path, cache):
        on_device = hasattr(self.detector, "detect_frames")
        size = getattr(self.detector, "chunk", TRACK_CHUNK)
        detections: List[Dict[str, Any]] = []
        visual: List[float] = []
        with VideoReader(video_path, device=self.device) as vr:
            info = vr.info
            fps = info["fps"]
            for start, rgb, frames, vis in self._chunks(
                    vr, cache, size, host=not on_device):
                visual.extend(vis)
                with self.timers.time("curation.detect"):
                    # stateful per-frame detectors (MOG2) take BGR
                    if on_device:
                        dets = self.detector.detect_frames(rgb.flip(-1))
                    else:
                        dets = [self.detector(np.ascontiguousarray(
                            f[..., ::-1])) for f in frames]
                for i, det in enumerate(dets):
                    idx = start + i
                    detections.append({
                        "frame": idx,
                        "time": idx / fps if fps > 0 else 0,
                        "detection": det,
                    })
        return detections, info, np.asarray(visual)

    def _track_streamed(self, video_path: Path, cache, batch_fn):
        """Producer thread: decode, the quality stats on the device and the
        frame cache, pushing fixed-size chunks.  Calling thread: the
        detector's pipelined loop."""
        chunk = getattr(self.detector, "chunk", TRACK_CHUNK)
        q: "queue.Queue" = queue.Queue(maxsize=4)
        state: Dict[str, Any] = {"info": None, "visual": [], "indices": [],
                                 "err": None, "abort": False, "ended": False}

        def safe_put(item) -> bool:
            # never block forever: once the device loop is done, the abort
            # flag lets the producer exit so join() cannot hang
            while not state["abort"]:
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with VideoReader(video_path, device=self.device) as vr:
                    state["info"] = vr.info
                    for start, _, frames, vis in self._chunks(
                            vr, cache, chunk, host=True):
                        state["visual"].extend(vis)
                        state["indices"].extend(
                            range(start, start + len(frames)))
                        c = frames
                        if len(c) < chunk:
                            c = np.concatenate(
                                [c, np.zeros((chunk - len(c),)
                                             + c.shape[1:], np.uint8)])
                        if not safe_put((len(frames), c)):
                            return
            except Exception as e:      # re-raised on the calling thread
                state["err"] = e
            finally:
                safe_put(None)          # the sentinel must reach the loop

        def chunk_iter():
            while True:
                item = q.get()
                if item is None:
                    state["ended"] = True
                    return
                yield item

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            dets = batch_fn(chunk_iter(), timers=self.timers)
        finally:
            # also when detect_stream returned before the sentinel: the
            # producer must not wait on a queue nobody drains
            state["abort"] = True
            t.join()
        if state["err"] is not None:
            raise state["err"]
        if not state["ended"]:
            raise RuntimeError("detect_stream returned before the end of "
                               "the stream")
        info = state["info"]
        fps = info["fps"] if info else 0
        detections = [{"frame": idx,
                       "time": idx / fps if fps > 0 else 0,
                       "detection": det}
                      for idx, det in zip(state["indices"], dets)]
        return detections, info, np.asarray(state["visual"])

    # -- stage 2: walking passes (clip-curation:175-289) ---------------------
    def identify_walking_passes(self, detections: List[Dict],
                                video_info: Dict) -> List[WalkingPass]:
        passes: List[WalkingPass] = []
        width = video_info["width"]
        start = None
        direction = None
        cents: List[Tuple[float, float]] = []
        boxes: List[List[float]] = []
        confs: List[float] = []

        def flush(end_frame: int):
            if start is not None and len(cents) >= MIN_PASS_FRAMES:
                passes.append(self._make_pass(start, end_frame,
                                              direction or "left_to_right",
                                              cents, boxes, confs))

        for det in detections:
            if det["detection"] is None:
                flush(det["frame"] - 1)
                start, cents, boxes, confs = None, [], [], []
                continue
            centroid = det["detection"]["centroid"]
            if start is None:
                start = det["frame"]
                direction = None
                cents = [centroid]
                boxes = [det["detection"]["bbox"]]
                confs = [det["detection"]["confidence"]]
            else:
                if len(cents) >= 5:
                    x_move = centroid[0] - cents[-5][0]
                    new_dir = "left_to_right" if x_move > 0 else "right_to_left"
                    if direction is None:
                        direction = new_dir
                    elif new_dir != direction and abs(x_move) > width * 0.05:
                        flush(det["frame"] - 1)
                        start = det["frame"]
                        direction = new_dir
                        cents = [centroid]
                        boxes = [det["detection"]["bbox"]]
                        confs = [det["detection"]["confidence"]]
                        continue
                cents.append(centroid)
                boxes.append(det["detection"]["bbox"])
                confs.append(det["detection"]["confidence"])
        if detections:
            flush(detections[-1]["frame"])
        return passes

    def _make_pass(self, start, end, direction, cents, boxes, confs):
        xs = [c[0] for c in cents]
        lo, hi = min(xs), max(xs)
        rng = hi - lo if hi > lo else 1
        if direction == "left_to_right":
            progress = [(x - lo) / rng for x in xs]
        else:
            progress = [(hi - x) / rng for x in xs]
        return WalkingPass(start_frame=start, end_frame=end,
                           direction=direction, centroids=list(cents),
                           bboxes=list(boxes), confidences=list(confs),
                           normalized_progress=progress)

    # -- stage 3: window scoring over the cache (clip-curation:291-432) ------
    def score_window(self, wp: WalkingPass, start_idx: int, window_frames: int,
                     video_info: Dict, visual_cache: np.ndarray
                     ) -> QualityMetrics:
        end_idx = min(start_idx + window_frames, len(wp.centroids))
        if end_idx - start_idx < window_frames * 0.8:
            return QualityMetrics(0, 0, 0, 0, 0, 0)
        cents = wp.centroids[start_idx:end_idx]
        boxes = wp.bboxes[start_idx:end_idx]
        confs = wp.confidences[start_idx:end_idx]
        progress = wp.normalized_progress[start_idx:end_idx]
        fw, fh = video_info["width"], video_info["height"]

        areas = [(b[2] - b[0]) * (b[3] - b[1]) for b in boxes]
        size_score = min(1.0, np.mean(areas) / (fw * fh) / 0.3)
        margins = []
        for b in boxes:
            m = min(b[0] / fw, (fw - b[2]) / fw, b[1] / fh, (fh - b[3]) / fh)
            margins.append(min(1.0, m / 0.05))
        framing = size_score * 0.6 + float(np.mean(margins)) * 0.4

        xs = [c[0] for c in cents]
        vel = np.diff(xs)
        mean_speed = abs(float(np.mean(vel)))
        steadiness = max(0.0, 1.0 - float(np.std(vel)) / mean_speed) \
            if mean_speed > 0 else 0.0

        ys = [c[1] for c in cents]
        straightness = max(0.0, 1.0 - (max(ys) - min(ys)) / fh * 10)

        n = end_idx - start_idx
        sample_idx = [wp.start_frame + start_idx + i
                      for i in range(0, n, max(1, n // 5))][:5]
        vis = [visual_cache[i] for i in sample_idx if i < len(visual_cache)]
        visual = float(np.mean(vis)) if vis else 0.5

        occlusion = float(np.mean(confs))
        avg_p = float(np.mean(progress))
        if avg_p < PROGRESS_BAND[0]:
            prog = avg_p / PROGRESS_BAND[0]
        elif avg_p > PROGRESS_BAND[1]:
            prog = (1.0 - avg_p) / (1.0 - PROGRESS_BAND[1])
        else:
            prog = 1.0

        overall = (framing * 0.25 + steadiness * 0.25 + straightness * 0.15
                   + visual * 0.15 + occlusion * 0.10 + prog * 0.10)
        return QualityMetrics(float(framing), float(steadiness),
                              float(straightness), visual, occlusion,
                              float(overall))

    def find_best_window(self, wp: WalkingPass, video_info: Dict,
                         visual_cache: np.ndarray) -> Optional[ClipCandidate]:
        fps = video_info["fps"]
        window_frames = int(CANONICAL_DURATION * fps)
        if len(wp.centroids) < window_frames:
            return None
        best = None
        best_score = -1.0
        step = max(1, window_frames // 4)
        for start_idx in range(0, len(wp.centroids) - window_frames + 1, step):
            m = self.score_window(wp, start_idx, window_frames, video_info,
                                  visual_cache)
            if m.overall_score > best_score:
                best_score = m.overall_score
                sf = wp.start_frame + start_idx
                best = ClipCandidate(
                    start_frame=sf, end_frame=sf + window_frames,
                    start_time=sf / fps, end_time=(sf + window_frames) / fps,
                    metrics=m, needs_flip=wp.direction == "right_to_left")
        return best

    # -- stage 4: extraction (clip-curation:434-505) -------------------------
    def extract_canonical_clip(self, video_path: Path, cand: ClipCandidate,
                               output_path: Path, video_info: Dict,
                               frames_cache: Optional[List[np.ndarray]] = None
                               ) -> Optional[Path]:
        """Write the window's frames at 25 fps, 1280x720, flipped when it
        runs right to left, as ``output_path`` with the suffix ``.y4m``;
        returns the path written (None for no frames).  ``frames_cache``:
        the track pass's decoded frames (indices contiguous from 0,
        matching the decode loop); the selection is the same either way,
        so the output bytes are too."""
        target_frames = int(CANONICAL_DURATION * TARGET_FPS)
        ratio = video_info["fps"] / TARGET_FPS
        picked: List[np.ndarray] = []

        def feed(pairs):
            for idx, frame in pairs:
                if idx < cand.start_frame:
                    continue
                rel = idx - cand.start_frame
                if rel >= len(picked) * ratio and \
                        len(picked) < target_frames:
                    picked.append(frame)
                if len(picked) >= target_frames:
                    break

        if frames_cache is not None:
            feed(enumerate(frames_cache))
        else:
            with VideoReader(video_path, device=self.device) as vr:
                feed(vr.frames(interval=1, rgb=True))
        if not picked:
            return None
        w, h = TARGET_RESOLUTION
        out = rows_at(np.stack(picked)[None], np.arange(len(picked)),
                       h, w)[0]
        if cand.needs_flip:
            out = out[:, :, ::-1]
        return write_video(output_path, out, TARGET_FPS, device=self.device)

    # -- full curation (clip-curation:567-672) -------------------------------
    def curate_video(self, video_path: Path, video_id: str) -> Dict[str, Any]:
        with self.timers.time("curation.track"):
            detections, info, visual_cache = \
                self.track_cow_through_video(video_path)
        # one-video memo: preprocessing of the same raw upload reuses these
        # per-frame detections instead of running the detector again over
        # its first frames (driver._preprocess); one entry only
        self.last_detections = {"video_id": video_id,
                                "detections": detections}
        passes = self.identify_walking_passes(detections, info)
        candidates = []
        for wp in passes:
            c = self.find_best_window(wp, info, visual_cache)
            if c:
                candidates.append(c)
        candidates.sort(key=lambda c: c.metrics.overall_score, reverse=True)
        selected = candidates[0] if candidates else None
        backup = candidates[1] if len(candidates) > 1 else None
        status, rejection = "success", None
        if selected is None and self._is_canonical_like(info):
            # pass-through fallback: the upload is already a canonical-
            # duration clip (a curated clip processed again, or footage the
            # weight-free detector cannot segment): the whole clip unflipped
            # with detector-independent metrics, rather than a rejection
            selected = self._passthrough_candidate(info, visual_cache)
        canonical = self.canonical_dir / f"{video_id}_canonical.y4m"
        if selected is None:
            status = "rejected"
            rejection = ("no valid walking pass of sufficient length"
                         if not passes else "no window long enough for 5s clip")
        else:
            fc = self._frame_cache["frames"] \
                if (self._frame_cache is not None
                    and self._frame_cache["path"]
                    == Path(video_path).resolve()) else None
            with self.timers.time("curation.extract"):
                ok = self.extract_canonical_clip(video_path, selected,
                                                 canonical, info,
                                                 frames_cache=fc)
            if not ok:
                status, rejection = "failed", "clip extraction failed"
            if backup is not None and ok:
                self.extract_canonical_clip(
                    video_path, backup,
                    self.canonical_dir / f"{video_id}_backup.y4m", info,
                    frames_cache=fc)

        report = schemas.quality_report(
            video_id=video_id,
            source=info,
            passes=[{"start_frame": p.start_frame, "end_frame": p.end_frame,
                     "direction": p.direction,
                     "duration": (p.end_frame - p.start_frame + 1) / info["fps"]
                     if info["fps"] > 0 else 0}
                    for p in passes],
            selected_window=self._window_dict(selected),
            backup_window=self._window_dict(backup),
            status=status, rejection_reason=rejection,
            target_fps=TARGET_FPS, target_resolution=TARGET_RESOLUTION,
            target_duration=CANONICAL_DURATION)
        schemas.write_result(self.reports_dir / f"{video_id}_quality.json",
                             report)
        if self.bus is not None:
            subject = (self.subjects.video_curated if self.subjects
                       else "video.curated")
            self.bus.publish_sync(subject, {
                "video_id": video_id, "status": status,
                "canonical_path": str(canonical),
                "quality_report": str(self.reports_dir
                                      / f"{video_id}_quality.json")})
        return report

    @staticmethod
    def _is_canonical_like(info: Dict[str, Any]) -> bool:
        """Already a ~5 s clip? (duration within 1.5x of the canonical
        target and at least 2 s of footage)."""
        fps = info.get("fps") or 0
        frames = info.get("total_frames") or 0
        if fps <= 0:
            return False
        duration = frames / fps
        return 2.0 <= duration <= CANONICAL_DURATION * 1.5

    def _passthrough_candidate(self, info: Dict[str, Any],
                               visual_cache: np.ndarray) -> ClipCandidate:
        fps = info["fps"]
        n = min(int(info["total_frames"]), int(CANONICAL_DURATION * fps))
        visual = float(np.mean(visual_cache[:n])) if len(visual_cache) else 0.0
        m = QualityMetrics(
            framing_score=0.0, steadiness_score=0.0, straightness_score=0.0,
            visual_quality_score=visual, occlusion_score=0.0,
            # only the detector-independent visual term contributes
            # (weight .15, clip-curation:379-386)
            overall_score=0.15 * visual)
        return ClipCandidate(start_frame=0, end_frame=n,
                             start_time=0.0, end_time=n / fps,
                             metrics=m, needs_flip=False)

    @staticmethod
    def _window_dict(c: Optional[ClipCandidate]) -> Optional[Dict[str, Any]]:
        if c is None:
            return None
        return {
            "start_frame": c.start_frame, "end_frame": c.end_frame,
            "start_time": c.start_time, "end_time": c.end_time,
            "needs_flip": c.needs_flip,
            "metrics": {
                "framing_score": c.metrics.framing_score,
                "steadiness_score": c.metrics.steadiness_score,
                "straightness_score": c.metrics.straightness_score,
                "visual_quality_score": c.metrics.visual_quality_score,
                "occlusion_score": c.metrics.occlusion_score,
                "overall_score": c.metrics.overall_score,
            },
        }
