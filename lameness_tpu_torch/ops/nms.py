"""Fixed-K greedy NMS over a batch (port of ``ops/nms.py``).

The JAX ``nms_single`` is a K-step ``lax.scan``; here it is a K-step loop
over the whole batch at once.  Each step takes the first-index argmax of
the live scores (``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does) and suppresses every candidate whose IoU with it
exceeds the threshold.  Classes are kept apart by the 1e4 coordinate
offset of the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.device import constant
from .boxes import pairwise_iou

_CLASS_OFFSET = 1e4


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, max_out: int = 32,
                iou_threshold: float = 0.45, score_threshold: float = 0.0,
                class_agnostic: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """boxes (B, N, 4), scores (B, N), classes (B, N) int32 -> boxes
    (B, K, 4), scores (B, K), classes (B, K), valid (B, K); slots past the
    survivors are zero (class -1) with valid False."""
    neg_inf = constant(float("-inf"), scores.dtype, scores.device)
    live = torch.where(scores > score_threshold, scores, neg_inf)
    if class_agnostic:
        offset_boxes = boxes
    else:
        offset_boxes = boxes + classes.to(boxes.dtype)[..., None] \
            * _CLASS_OFFSET
    iou = pairwise_iou(offset_boxes, offset_boxes)            # (B, N, N)
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    sel_idx, sel_valid = [], []
    for _ in range(max_out):
        idx = torch.argmax(live, dim=-1)                      # (B,)
        best = live[rows, idx]
        keep = best > neg_inf
        suppress = iou[rows, idx] > iou_threshold             # (B, N)
        live = torch.where(keep[:, None] & suppress, neg_inf, live)
        live[rows, idx] = neg_inf
        sel_idx.append(idx)
        sel_valid.append(keep)
    idx = torch.stack(sel_idx, dim=1)                         # (B, K)
    valid = torch.stack(sel_valid, dim=1)
    out_boxes = torch.where(valid[..., None],
                            torch.gather(boxes, 1, idx[..., None].expand(
                                -1, -1, 4)), 0.0)
    out_scores = torch.where(valid, torch.gather(scores, 1, idx), 0.0)
    out_classes = torch.where(valid, torch.gather(classes, 1, idx), -1)
    return out_boxes, out_scores, out_classes.to(torch.int32), valid
