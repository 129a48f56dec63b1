"""Box utilities over (..., 4) xyxy tensors (port of ``ops/boxes.py``)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...,) area, clamped at 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def clip_boxes(boxes: torch.Tensor, height: float, width: float
               ) -> torch.Tensor:
    x1 = boxes[..., 0].clamp(0.0, width)
    y1 = boxes[..., 1].clamp(0.0, height)
    x2 = boxes[..., 2].clamp(0.0, width)
    y2 = boxes[..., 3].clamp(0.0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)
