"""ByteTrack multi-object tracker, host orchestration (port of
``lameness_tpu/track/bytetrack.py``, copied line for line).

Three-stage association (``tracking-service/app/tracker/bytetrack.py:
75-254``, ``track.py:13-104``):
1. high-confidence (>= 0.6) detections against all live tracks, IoU and
   appearance cost at weight 0.5, IoU gate 0.8;
2. low-confidence (0.1-0.6) detections against the remaining tracks,
   IoU only, gate 0.5;
3. LOST tracks reactivated by leftover high-confidence detections,
   appearance weight 0.7, IoU gate 0.3;
with the TENTATIVE (hits >= 3) -> CONFIRMED -> LOST (> 30 missed) ->
DELETED (> 90) lifecycle and momentum-0.9 appearance smoothing.  Cost
matrices are batched numpy; assignment is ``assignment.solve``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from .assignment import solve as lap_solve
from .kalman import SingleKalman


class TrackState(Enum):
    TENTATIVE = 1
    CONFIRMED = 2
    LOST = 3
    DELETED = 4


@dataclass
class Detection:
    bbox: np.ndarray
    confidence: float
    class_id: int = 0
    embedding: Optional[np.ndarray] = None


@dataclass
class Track:
    track_id: int
    bbox: np.ndarray
    confidence: float = 0.0
    embedding: Optional[np.ndarray] = None
    state: TrackState = TrackState.TENTATIVE
    age: int = 0
    hits: int = 1
    time_since_update: int = 0
    frame_history: List[int] = field(default_factory=list)
    bbox_history: List[np.ndarray] = field(default_factory=list)
    smoothed_embedding: Optional[np.ndarray] = None

    def update(self, bbox, confidence, embedding=None, frame_idx=0):
        self.bbox = np.asarray(bbox, float).copy()
        self.confidence = confidence
        self.hits += 1
        self.time_since_update = 0
        self.bbox_history.append(self.bbox.copy())
        self.frame_history.append(frame_idx)
        if embedding is not None:
            if self.smoothed_embedding is None:
                self.smoothed_embedding = np.asarray(embedding, float).copy()
            else:
                self.smoothed_embedding = (
                    0.9 * self.smoothed_embedding + 0.1 * np.asarray(embedding))
            self.embedding = embedding
        if self.state == TrackState.TENTATIVE and self.hits >= 3:
            self.state = TrackState.CONFIRMED
        elif self.state == TrackState.LOST:
            self.state = TrackState.CONFIRMED

    def mark_missed(self):
        self.age += 1
        self.time_since_update += 1
        if self.state == TrackState.CONFIRMED and self.time_since_update > 30:
            self.state = TrackState.LOST
        elif self.state == TrackState.TENTATIVE and self.time_since_update > 3:
            self.state = TrackState.DELETED
        elif self.state == TrackState.LOST and self.time_since_update > 90:
            self.state = TrackState.DELETED

    def is_confirmed(self):
        return self.state == TrackState.CONFIRMED

    def get_feature(self):
        return self.smoothed_embedding

    def to_dict(self) -> dict:
        return {
            "track_id": self.track_id,
            "bbox": np.asarray(self.bbox).tolist(),
            "confidence": float(self.confidence),
            "state": self.state.name,
            "age": self.age,
            "hits": self.hits,
            "time_since_update": self.time_since_update,
            "start_frame": self.frame_history[0] if self.frame_history else 0,
            "end_frame": self.frame_history[-1] if self.frame_history else 0,
            "has_embedding": self.embedding is not None,
        }


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)x(M,4) xyxy -> (N,M) IoU with the reference's +1e-6 union eps."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-6)


def cosine_distance(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
    f1 = f1 / (np.linalg.norm(f1, axis=1, keepdims=True) + 1e-6)
    f2 = f2 / (np.linalg.norm(f2, axis=1, keepdims=True) + 1e-6)
    return 1.0 - f1 @ f2.T


def associate(det_boxes: np.ndarray, trk_boxes: np.ndarray,
              iou_threshold: float,
              det_feats: Optional[np.ndarray] = None,
              trk_feats: Optional[np.ndarray] = None,
              appearance_weight: float = 0.5
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IoU(⊕appearance) association with post-assignment IoU gating,
    replicating ``matching.py:106-174``."""
    if len(trk_boxes) == 0:
        return (np.empty((0, 2), int), np.arange(len(det_boxes)),
                np.empty(0, int))
    if len(det_boxes) == 0:
        return (np.empty((0, 2), int), np.empty(0, int),
                np.arange(len(trk_boxes)))
    iou = iou_matrix(det_boxes, trk_boxes)
    if det_feats is not None and trk_feats is not None:
        cost = ((1 - appearance_weight) * (1.0 - iou)
                + appearance_weight * cosine_distance(det_feats, trk_feats))
    else:
        cost = 1.0 - iou
    matched, un_d, un_t = lap_solve(cost)
    keep = []
    un_d = list(un_d)
    un_t = list(un_t)
    for i, j in matched:
        if iou[i, j] >= iou_threshold:
            keep.append([i, j])
        else:
            un_d.append(int(i))
            un_t.append(int(j))
    return (np.asarray(keep, int).reshape(-1, 2),
            np.asarray(un_d, int), np.asarray(un_t, int))


class ByteTracker:
    def __init__(self, high_thresh: float = 0.6, low_thresh: float = 0.1,
                 match_thresh: float = 0.8, track_buffer: int = 30,
                 use_appearance: bool = True, appearance_weight: float = 0.5,
                 max_tracks: int = 100):
        self.high_thresh = high_thresh
        self.low_thresh = low_thresh
        self.match_thresh = match_thresh
        self.track_buffer = track_buffer
        self.use_appearance = use_appearance
        self.appearance_weight = appearance_weight
        self.max_tracks = max_tracks
        self.tracks: List[Track] = []
        self.kalman: Dict[int, SingleKalman] = {}
        self.next_id = 0
        self.track_count = 0
        self.frame_id = 0

    # -- helpers ------------------------------------------------------------
    def _features(self, dets: List[Detection], tracks: List[Track]):
        if not self.use_appearance:
            return None, None
        df = [d.embedding for d in dets if d.embedding is not None]
        tf = [t.get_feature() for t in tracks if t.get_feature() is not None]
        if len(df) != len(dets) or len(tf) != len(tracks):
            return None, None
        return np.asarray(df, float), np.asarray(tf, float)

    def _predict_all(self):
        for t in self.tracks:
            kf = self.kalman.get(t.track_id)
            if kf is not None:
                t.bbox = kf.predict()
                t.age += 1

    def _update_track(self, track: Track, det: Detection, frame_idx: int):
        track.update(det.bbox, det.confidence, det.embedding, frame_idx)
        kf = self.kalman.get(track.track_id)
        if kf is not None:
            kf.update(det.bbox)

    def _create_track(self, det: Detection, frame_idx: int) -> Track:
        t = Track(track_id=self.next_id, bbox=np.asarray(det.bbox, float),
                  confidence=det.confidence, embedding=det.embedding,
                  frame_history=[frame_idx],
                  bbox_history=[np.asarray(det.bbox, float).copy()])
        if det.embedding is not None:
            t.smoothed_embedding = np.asarray(det.embedding, float).copy()
        self.next_id += 1
        self.track_count += 1
        self.tracks.append(t)
        self.kalman[t.track_id] = SingleKalman(det.bbox)
        return t

    def _cleanup(self):
        for t in self.tracks:
            if t.state == TrackState.DELETED:
                self.kalman.pop(t.track_id, None)
        self.tracks = [t for t in self.tracks if t.state != TrackState.DELETED]
        if len(self.tracks) > self.max_tracks:
            self.tracks.sort(key=lambda t: t.time_since_update)
            for t in self.tracks[self.max_tracks:]:
                self.kalman.pop(t.track_id, None)
            self.tracks = self.tracks[:self.max_tracks]

    # -- main entry ---------------------------------------------------------
    def update(self, detections: List[Detection],
               frame_idx: Optional[int] = None) -> List[Track]:
        if frame_idx is None:
            frame_idx = self.frame_id
        self.frame_id = frame_idx + 1

        if len(detections) == 0:
            self._predict_all()
            for t in self.tracks:
                t.mark_missed()
            self._cleanup()
            return [t for t in self.tracks if t.is_confirmed()]

        high = [d for d in detections if d.confidence >= self.high_thresh]
        low = [d for d in detections
               if self.low_thresh <= d.confidence < self.high_thresh]
        active = list(self.tracks)
        self._predict_all()

        # stage 1: high-conf vs all live tracks
        df, tf = self._features(high, active)
        m1, un_d1, un_t1 = associate(
            np.asarray([d.bbox for d in high], float).reshape(-1, 4),
            np.asarray([t.bbox for t in active], float).reshape(-1, 4),
            self.match_thresh, df, tf, self.appearance_weight)
        for i, j in m1:
            self._update_track(active[j], high[i], frame_idx)

        # stage 2: low-conf vs remaining tracks, IoU only, gate 0.5
        rem_tracks = [active[j] for j in un_t1]
        m2, _, un_t2 = associate(
            np.asarray([d.bbox for d in low], float).reshape(-1, 4),
            np.asarray([t.bbox for t in rem_tracks], float).reshape(-1, 4),
            0.5)
        for i, j in m2:
            self._update_track(rem_tracks[j], low[i], frame_idx)

        # stage 3: reactivate LOST tracks with leftover high-conf dets
        lost = [t for t in self.tracks if t.state == TrackState.LOST]
        leftover = [high[i] for i in un_d1]
        df, tf = self._features(leftover, lost)
        m3, un_d3, _ = associate(
            np.asarray([d.bbox for d in leftover], float).reshape(-1, 4),
            np.asarray([t.bbox for t in lost], float).reshape(-1, 4),
            0.3, df, tf, appearance_weight=0.7)
        reactivated = set()
        for i, j in m3:
            self._update_track(lost[j], leftover[i], frame_idx)
            reactivated.add(id(lost[j]))

        # mark unmatched remaining tracks missed
        matched2 = {id(rem_tracks[j]) for _, j in m2}
        for t in rem_tracks:
            if id(t) not in matched2 and id(t) not in reactivated:
                t.mark_missed()

        # new tracks from remaining unmatched high-conf detections
        for i in un_d3:
            self._create_track(leftover[i], frame_idx)

        self._cleanup()
        return [t for t in self.tracks if t.is_confirmed()]

    def get_statistics(self) -> dict:
        return {
            "total_tracks": self.track_count,
            "active_tracks": len([t for t in self.tracks if t.is_confirmed()]),
            "confirmed": len([t for t in self.tracks
                              if t.state == TrackState.CONFIRMED]),
            "tentative": len([t for t in self.tracks
                              if t.state == TrackState.TENTATIVE]),
            "lost": len([t for t in self.tracks if t.state == TrackState.LOST]),
            "frame_id": self.frame_id,
            "high_thresh": self.high_thresh,
            "low_thresh": self.low_thresh,
            "use_appearance": self.use_appearance,
        }

    def reset(self):
        self.tracks = []
        self.kalman = {}
        self.next_id = 0
        self.track_count = 0
        self.frame_id = 0
