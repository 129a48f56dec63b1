"""Detection evaluation: COCO-style mAP over fixed-shape predictions (port
of ``lameness_tpu/pipeline/evaluation.py``, a copy: host numpy).

The reference inherits its val metrics from the ultralytics validator
(mAP50, mAP50-95, precision/recall at matched IoUs); this is that
contract as plain numpy over our padded ``detect()`` outputs, so a
training run can report the same headline numbers without any torch
dependency.

Matching follows the COCO protocol: per image and class, predictions are
taken in descending score order and greedily matched to the unmatched
ground-truth box with the highest IoU above the threshold; AP is the
area under the 101-point interpolated precision-recall curve.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def _match_image(pred_boxes, pred_scores, gt_boxes, iou_thr):
    """Greedy COCO matching for one image+class at one IoU threshold.
    Returns tp flags aligned with score-sorted predictions."""
    order = np.argsort(-pred_scores)
    tp = np.zeros(len(order), bool)
    if len(gt_boxes):
        iou = _iou_matrix(pred_boxes[order], gt_boxes)
        taken = np.zeros(len(gt_boxes), bool)
        for i in range(len(order)):
            cand = np.where(~taken & (iou[i] >= iou_thr))[0]
            if len(cand):
                j = cand[np.argmax(iou[i][cand])]
                taken[j] = True
                tp[i] = True
    return tp, pred_scores[order]


def _average_precision(tp: np.ndarray, scores: np.ndarray,
                       n_gt: int) -> float:
    """101-point interpolated AP from pooled, score-sorted tp flags."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    pts = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, pts, side="left")
    p = np.where(idx < len(precision), precision[np.clip(idx, 0,
                 len(precision) - 1)], 0.0)
    return float(p.mean())


def evaluate_detections(pred_boxes: np.ndarray, pred_scores: np.ndarray,
                        pred_classes: np.ndarray, pred_valid: np.ndarray,
                        gt_boxes: np.ndarray, gt_labels: np.ndarray,
                        gt_mask: np.ndarray, num_classes: int,
                        iou_thrs: Sequence[float] = tuple(
                            np.arange(0.5, 1.0, 0.05))) -> Dict[str, float]:
    """COCO-style evaluation over padded batches.

    pred_* are ``detect()``-shaped: (N, D, 4)/(N, D)/(N, D)/(N, D) with a
    validity mask; gt_* are the trainer-shaped padded ground truths.
    Returns mAP50, mAP50_95, and per-threshold precision/recall at the
    score-maximising operating point.
    """
    n = pred_boxes.shape[0]
    aps: Dict[float, List[float]] = {float(t): [] for t in iou_thrs}
    for c in range(num_classes):
        pooled = {float(t): ([], []) for t in iou_thrs}   # tp, scores
        n_gt = 0
        for i in range(n):
            pm = pred_valid[i] & (pred_classes[i] == c)
            gm = gt_mask[i] & (gt_labels[i] == c)
            n_gt += int(gm.sum())
            pb, ps = pred_boxes[i][pm], pred_scores[i][pm]
            gb = gt_boxes[i][gm]
            for t in iou_thrs:
                tp, ss = _match_image(pb, ps, gb, float(t))
                pooled[float(t)][0].append(tp)
                pooled[float(t)][1].append(ss)
        for t in iou_thrs:
            tp = np.concatenate(pooled[float(t)][0]) if pooled[float(t)][0] \
                else np.zeros(0, bool)
            ss = np.concatenate(pooled[float(t)][1]) if pooled[float(t)][1] \
                else np.zeros(0)
            ap = _average_precision(tp, ss, n_gt)
            if not np.isnan(ap):
                aps[float(t)].append(ap)

    map50 = float(np.mean(aps[0.5])) if aps[0.5] else 0.0
    all_t = [np.mean(aps[float(t)]) for t in iou_thrs if aps[float(t)]]
    return {"mAP50": map50,
            "mAP50_95": float(np.mean(all_t)) if all_t else 0.0,
            "num_images": n}
