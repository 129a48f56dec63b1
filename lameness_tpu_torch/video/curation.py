"""Clip curation's detectors (port of the detector part of
``lameness_tpu/video/curation.py``).

``BatchedYoloDetector`` letterboxes and runs YOLO over a chunk of frames in
one forward (ceil(F/chunk) dispatches for F frames, the ragged tail chunk
zero-padded to the chunk), and picks each frame's detection with
``_best_detection`` (clip-curation:103-131: a cow, or any detection over
10% of the frame, the largest).  Boxes are not clipped to the frame, as in
the JAX package (the engine's detect stage clips its own).  ``detect_stream``
issues chunk k+1's copy to the device before it reads chunk k back, on the
side streams of ``core/streams.py``.  Frames are BGR by the reference's
convention (OpenCV's); the flip to RGB is a numpy view.

``ClipCurator`` (blur, background subtraction, the curated clip's video)
and the motion detector need OpenCV and are not ported yet.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.streams import Overlap, host_to_device
from ..models.yolo import detect as yolo_detect
from ..ops.preprocess import letterbox, unletterbox_boxes
from .yuv import i420_to_rgb_device, rgb_to_i420

Detector = Callable[[np.ndarray], Optional[Dict[str, Any]]]


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
