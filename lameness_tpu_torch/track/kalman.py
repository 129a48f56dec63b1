"""Constant-velocity Kalman filter for box tracking (port of
``lameness_tpu/track/kalman.py``, copied line for line: numpy on the host).

7-state [cx, cy, s, r, vx, vy, vs], observation [cx, cy, s, r], with the
reference's noise and covariance initialisation (R[2:,2:]*=10;
P[4:,4:]*=1000, P*=10; Q[-1,-1]*=0.01, Q[4:,4:]*=0.01).  ``KalmanState``
holds (N, 7) means and (N, 7, 7) covariances, so predict and update run
batched over the tracks; ``device_tracker.py`` runs the same algebra on
the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

_F = np.eye(7)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_H = np.zeros((4, 7))
_H[0, 0] = _H[1, 1] = _H[2, 2] = _H[3, 3] = 1.0
_R = np.diag([1.0, 1.0, 10.0, 10.0])
_Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
_P0 = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])


def bbox_to_z(bbox: np.ndarray) -> np.ndarray:
    """xyxy -> [cx, cy, s, r] (s = area, r = w/(h+1e-6))."""
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    return np.stack([bbox[..., 0] + w / 2, bbox[..., 1] + h / 2,
                     w * h, w / (h + 1e-6)], axis=-1)


def z_to_bbox(z: np.ndarray) -> np.ndarray:
    s = np.maximum(z[..., 2], 1e-6)
    r = np.maximum(z[..., 3], 1e-6)
    w = np.sqrt(s * r)
    h = s / (w + 1e-6)
    return np.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                     z[..., 0] + w / 2, z[..., 1] + h / 2], axis=-1)


@dataclass
class KalmanState:
    mean: np.ndarray            # (N, 7)
    cov: np.ndarray             # (N, 7, 7)

    @staticmethod
    def create(bboxes: np.ndarray) -> "KalmanState":
        n = bboxes.shape[0]
        mean = np.zeros((n, 7))
        mean[:, :4] = bbox_to_z(bboxes)
        cov = np.tile(_P0[None], (n, 1, 1))
        return KalmanState(mean, cov)

    def predict(self) -> np.ndarray:
        """Advance all filters one step; returns predicted xyxy boxes.
        Replicates the negative-area guard (kalman.py:119-121)."""
        vs_bad = self.mean[:, 6] + self.mean[:, 2] <= 0
        self.mean[vs_bad, 6] = 0.0
        self.mean = self.mean @ _F.T
        self.cov = _F @ self.cov @ _F.T + _Q
        return z_to_bbox(self.mean[:, :4])

    def update(self, idx: np.ndarray, bboxes: np.ndarray) -> None:
        """Measurement update for the filters at `idx` with xyxy boxes."""
        if len(idx) == 0:
            return
        z = bbox_to_z(bboxes)                         # (K, 4)
        mean = self.mean[idx]
        cov = self.cov[idx]
        y = z - mean @ _H.T
        s = _H @ cov @ _H.T + _R                      # (K, 4, 4)
        k = cov @ _H.T @ np.linalg.inv(s)             # (K, 7, 4)
        self.mean[idx] = mean + np.einsum("kij,kj->ki", k, y)
        ikh = np.eye(7) - k @ _H
        self.cov[idx] = ikh @ cov

    def boxes(self) -> np.ndarray:
        return z_to_bbox(self.mean[:, :4])


class SingleKalman:
    """Scalar-interface wrapper matching the reference class surface."""

    def __init__(self, bbox: np.ndarray):
        self.state = KalmanState.create(np.asarray(bbox, float)[None])
        self.time_since_update = 0
        self.hits = 0
        self.age = 0

    def predict(self) -> np.ndarray:
        box = self.state.predict()[0]
        self.age += 1
        self.time_since_update += 1
        return box

    def update(self, bbox: np.ndarray) -> None:
        self.time_since_update = 0
        self.hits += 1
        self.state.update(np.array([0]), np.asarray(bbox, float)[None])

    def get_state(self) -> np.ndarray:
        return self.state.boxes()[0]
