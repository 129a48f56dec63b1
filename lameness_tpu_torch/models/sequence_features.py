"""44-d per-frame keypoint features for the temporal heads (port of
``lameness_tpu/models/sequence_features.py``): 20 keypoints x (x, y)
bbox-normalised, centroid x/1280, y/720, area/(1280·720) and centroid
velocity (tcn:255-314, transformer:303-372), and the 125-frame
pad-or-center-crop (tcn:316-328).

- ``extract_from_pose_sequences`` and ``pad_or_truncate``: host numpy over
  result-JSON pose dicts (a copy; the head trainer's dataset reads them).
- ``extract_from_arrays``: torch over keypoint arrays, the engine's path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NUM_KEYPOINTS = 20
FEATURES_PER_KEYPOINT = 2
EXTRA_FEATURES = 4
FEATURE_DIM = NUM_KEYPOINTS * FEATURES_PER_KEYPOINT + EXTRA_FEATURES  # 44
TARGET_LEN = 125
FRAME_W, FRAME_H = 1280, 720


def extract_from_pose_sequences(
    pose_sequences: List[Dict],
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """JSON pose sequences -> (features (T, 44), low_conf_mask (T,)).

    Mask semantics follow the transformer pipeline: True = low-confidence
    frame (avg kp confidence × detection confidence < 0.3, transformer:370).
    """
    if not pose_sequences:
        return None, None
    feats, confs = [], []
    for frame_data in pose_sequences:
        row: List[float] = []
        frame_conf: List[float] = []
        kps = frame_data.get("keypoints", [])
        bbox = frame_data.get("bbox", [0, 0, 100, 100])
        det_conf = frame_data.get("detection_confidence", 1.0)
        bx, by = bbox[0], bbox[1]
        bw = bbox[2] - bbox[0] if len(bbox) > 2 else 100
        bh = bbox[3] - bbox[1] if len(bbox) > 3 else 100
        for kp in kps[:NUM_KEYPOINTS]:
            row.append((kp.get("x", 0) - bx) / max(bw, 1))
            row.append((kp.get("y", 0) - by) / max(bh, 1))
            frame_conf.append(kp.get("confidence", 0.5))
        while len(row) < NUM_KEYPOINTS * FEATURES_PER_KEYPOINT:
            row.extend([0.0, 0.0])
            frame_conf.append(0.0)
        cx = (bbox[0] + bbox[2]) / 2 if len(bbox) > 2 else 0
        cy = (bbox[1] + bbox[3]) / 2 if len(bbox) > 3 else 0
        row.append(cx / FRAME_W)
        row.append(cy / FRAME_H)
        row.append(bw * bh / (FRAME_W * FRAME_H))
        row.append(0.0)  # velocity, filled below
        feats.append(row)
        confs.append(float(np.mean(frame_conf)) * det_conf if frame_conf else 0.0)
    features = np.asarray(feats, np.float32)
    if len(features) > 1:
        vel = np.zeros(len(features), np.float32)
        vel[1:] = np.diff(features[:, -4])
        features[:, -1] = vel
    mask = np.asarray(confs, np.float32) < 0.3
    return features, mask


def pad_or_truncate(features: np.ndarray, mask: Optional[np.ndarray] = None,
                    target_length: int = TARGET_LEN):
    """Center-crop if too long, center-pad with zeros (mask=True) if short."""
    t = features.shape[0]
    if t >= target_length:
        start = (t - target_length) // 2
        f = features[start:start + target_length]
        m = mask[start:start + target_length] if mask is not None else None
    else:
        before = (target_length - t) // 2
        after = target_length - t - before
        f = np.pad(features, ((before, after), (0, 0)))
        m = (np.pad(mask, (before, after), constant_values=True)
             if mask is not None else None)
    return (f, m) if mask is not None else f


def extract_from_arrays(kp_xy: torch.Tensor, kp_conf: torch.Tensor,
                        boxes: torch.Tensor, det_conf: torch.Tensor,
                        frame_valid: torch.Tensor):
    """(B, T, Kp, 2) xy, (B, T, Kp) conf, (B, T, 4) boxes, (B, T) det conf,
    (B, T) valid -> (features (B, T, 44) f32, low_conf_mask (B, T))."""
    b, t = kp_xy.shape[:2]
    bx, by = boxes[..., 0:1], boxes[..., 1:2]
    bw = (boxes[..., 2:3] - boxes[..., 0:1]).clamp(min=1.0)
    bh = (boxes[..., 3:4] - boxes[..., 1:2]).clamp(min=1.0)
    x = (kp_xy[..., 0] - bx) / bw
    y = (kp_xy[..., 1] - by) / bh
    kp_feats = torch.stack([x, y], dim=-1).reshape(b, t, -1)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2 / FRAME_W
    cy = (boxes[..., 1] + boxes[..., 3]) / 2 / FRAME_H
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1]) \
        / (FRAME_W * FRAME_H)
    vel = torch.cat([torch.zeros_like(cx[..., :1]),
                     torch.diff(cx, dim=-1)], dim=-1)
    feats = torch.cat([kp_feats, cx[..., None], cy[..., None],
                       area[..., None], vel[..., None]], dim=-1)
    feats = torch.where(frame_valid[..., None], feats, 0.0)
    avg_conf = kp_conf.mean(dim=-1) * det_conf
    low_conf = (avg_conf < 0.3) | ~frame_valid
    return feats.float(), low_conf
