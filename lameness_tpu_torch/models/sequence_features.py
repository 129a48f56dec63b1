"""44-d per-frame keypoint features for the temporal heads (port of
``extract_from_arrays`` in ``lameness_tpu/models/sequence_features.py``):
20 keypoints x (x, y) bbox-normalised, centroid x/1280, y/720, area/(1280·720)
and centroid velocity (tcn:255-314, transformer:303-372)."""
from __future__ import annotations

import torch

NUM_KEYPOINTS = 20
FEATURE_DIM = 44
TARGET_LEN = 125
FRAME_W, FRAME_H = 1280, 720


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
