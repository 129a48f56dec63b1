"""ByteTrack on the device: fixed track slots, one step per frame (port of
``lameness_tpu/track/device_tracker.py``).

The host tracker (``bytetrack.py``) is the reference-exact path (optimal
assignment, Python lifecycle).  This one keeps every clip's state in
tensors on the card: greedy best-IoU association (the K-step argmin and
suppress pattern, ties to the lowest index as ``argmin`` gives them), the
same high/low confidence split and TENTATIVE -> CONFIRMED -> LOST ->
EMPTY counters, and Kalman predict and update as batched float32 matrix
algebra.  JAX runs the frames under one ``lax.scan``; here a Python loop
over frames queues each step's kernels without reading anything back, and
the outputs of every frame are read back once, at the end.

Every state tensor has a leading clip dimension, so ``track_clip_batch``
tracks a batch of clips in one loop (the JAX ``vmap``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.device import constant, resolve_device
from ..ops.boxes import pairwise_iou

# Kalman matrices (same numerics as track/kalman.py)
_F = np.eye(7)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_H = np.zeros((4, 7))
_H[0, 0] = _H[1, 1] = _H[2, 2] = _H[3, 3] = 1.0
_R = np.diag([1.0, 1.0, 10.0, 10.0])
_Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
_P0 = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])

# lifecycle states
EMPTY, TENTATIVE, CONFIRMED, LOST = 0, 1, 2, 3
_BIG = 1e9


def _bbox_to_z(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack([b[..., 0] + w / 2, b[..., 1] + h / 2, w * h,
                        w / (h + 1e-6)], -1)


def _z_to_bbox(z):
    s = z[..., 2].clamp(min=1e-6)
    r = z[..., 3].clamp(min=1e-6)
    w = torch.sqrt(s * r)
    h = s / (w + 1e-6)
    return torch.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                        z[..., 0] + w / 2, z[..., 1] + h / 2], -1)


def _mat(m: np.ndarray, device) -> torch.Tensor:
    return constant(m, torch.float32, device)


def init_state(max_tracks: int, batch: int = 1,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "mean": torch.zeros(batch, max_tracks, 7, device=dev),
        "cov": _mat(_P0, dev).expand(batch, max_tracks, 7, 7).clone(),
        "track_id": torch.zeros(batch, max_tracks, dtype=torch.int32,
                                device=dev),
        "state": torch.full((batch, max_tracks), EMPTY, dtype=torch.int32,
                            device=dev),
        "hits": torch.zeros(batch, max_tracks, dtype=torch.int32,
                            device=dev),
        "tsu": torch.zeros(batch, max_tracks, dtype=torch.int32,
                           device=dev),                # time_since_update
        "score": torch.zeros(batch, max_tracks, device=dev),
        "next_id": torch.ones(batch, dtype=torch.int32, device=dev),
    }


def _greedy_match(cost, row_ok, col_ok, thresh: float, n_steps: int):
    """Greedy min-cost matching: take the best remaining pair n_steps times.
    cost (B, R, C) -> col_for_row (B, R), -1 = unmatched."""
    b, n_rows, n_cols = cost.shape
    rows = torch.arange(n_rows, device=cost.device)
    cols = torch.arange(n_cols, device=cost.device)
    cost = torch.where(row_ok[:, :, None] & col_ok[:, None, :], cost, _BIG)
    col_for_row = torch.full((b, n_rows), -1, dtype=torch.int32,
                             device=cost.device)
    for _ in range(n_steps):
        flat = cost.reshape(b, -1)
        idx = flat.argmin(dim=1)
        r, c = idx // n_cols, idx % n_cols
        ok = flat.gather(1, idx[:, None])[:, 0] <= thresh
        hit = ok[:, None] & (rows[None] == r[:, None])
        col_for_row = torch.where(hit, c[:, None].to(torch.int32),
                                  col_for_row)
        taken = (rows[None, :, None] == r[:, None, None]) \
            | (cols[None, None, :] == c[:, None, None])
        cost = torch.where(ok[:, None, None] & taken, _BIG, cost)
    return col_for_row


def _kalman_predict(state):
    f, q = _mat(_F, state["mean"].device), _mat(_Q, state["mean"].device)
    mean = state["mean"].clone()
    vs_bad = mean[..., 6] + mean[..., 2] <= 0
    mean[..., 6] = torch.where(vs_bad, 0.0, mean[..., 6])
    return dict(state, mean=mean @ f.T, cov=f @ state["cov"] @ f.T + q)


def _kalman_update_where(state, boxes, update_mask):
    """Batched measurement update applied only where update_mask."""
    dev = state["mean"].device
    h, r = _mat(_H, dev), _mat(_R, dev)
    mean, cov = state["mean"], state["cov"]
    y = _bbox_to_z(boxes) - mean @ h.T
    s = h @ cov @ h.T + r
    # inv_ex: no check of the factorisation, so no wait for the device
    k = cov @ h.T @ torch.linalg.inv_ex(s).inverse
    new_mean = mean + torch.einsum("...ij,...j->...i", k, y)
    new_cov = (_mat(np.eye(7), dev) - k @ h) @ cov
    return dict(state,
                mean=torch.where(update_mask[..., None], new_mean, mean),
                cov=torch.where(update_mask[..., None, None], new_cov, cov))


def tracker_step(state: Dict[str, torch.Tensor], boxes: torch.Tensor,
                 scores: torch.Tensor, valid: torch.Tensor,
                 high_thresh: float = 0.6, low_thresh: float = 0.1,
                 match_iou: float = 0.2, match_iou_low: float = 0.5,
                 min_hits: int = 3, max_missed_lost: int = 30,
                 max_missed_delete: int = 90):
    """One frame of every clip: fixed-K detections (B, K, 4) with (B, K)
    scores and valid flags -> the updated state and the per-slot outputs."""
    max_tracks = state["mean"].shape[1]
    k_det = boxes.shape[1]
    dets = torch.arange(k_det, device=boxes.device)
    state = _kalman_predict(state)
    track_boxes = _z_to_bbox(state["mean"][..., :4])
    live = state["state"] > EMPTY
    cost = 1.0 - pairwise_iou(track_boxes, boxes)            # (B, S, K)

    def taken_by(col, matched):
        return ((col[..., None] == dets) & matched[..., None]).any(dim=1)

    # stage 1: high-confidence detections vs live tracks
    high_ok = valid & (scores >= high_thresh)
    col1 = _greedy_match(cost, live, high_ok, 1.0 - match_iou,
                         min(max_tracks, k_det))
    matched1 = col1 >= 0
    det_taken = taken_by(col1, matched1)

    # stage 2: low-confidence detections vs remaining tracks (IoU gate 0.5)
    low_ok = valid & (scores >= low_thresh) & (scores < high_thresh) \
        & ~det_taken
    col2 = _greedy_match(cost, live & ~matched1, low_ok, 1.0 - match_iou_low,
                         min(max_tracks, k_det))
    matched2 = col2 >= 0
    det_taken = det_taken | taken_by(col2, matched2)

    matched = matched1 | matched2
    det_idx = torch.where(matched1, col1,
                          torch.where(matched2, col2, 0)).long()
    det_box = boxes.gather(1, det_idx[..., None].expand(-1, -1, 4))
    det_score = scores.gather(1, det_idx)

    # kalman + lifecycle updates for matched slots
    state = _kalman_update_where(state, det_box, matched)
    hits = torch.where(matched, state["hits"] + 1, state["hits"])
    tsu = torch.where(matched, 0, state["tsu"] + 1)
    score = torch.where(matched, det_score, state["score"])
    st = state["state"]
    st = torch.where(matched & (st == TENTATIVE) & (hits >= min_hits),
                     CONFIRMED, st)
    st = torch.where(matched & (st == LOST), CONFIRMED, st)
    st = torch.where(~matched & (st == CONFIRMED) & (tsu > max_missed_lost),
                     LOST, st)
    st = torch.where(~matched & (st == TENTATIVE) & (tsu > 3), EMPTY, st)
    st = torch.where(~matched & (st == LOST) & (tsu > max_missed_delete),
                     EMPTY, st)

    # births: unmatched high-conf detections claim empty slots in order
    free = st == EMPTY
    unclaimed = high_ok & ~det_taken
    free_rank = free.cumsum(-1) - 1                 # slot's index among free
    det_rank = unclaimed.cumsum(-1) - 1             # det's index among new
    # the det of each rank (-1 where none); slot s takes the det whose rank
    # is its rank among the free slots
    det_of_rank = torch.full_like(det_rank, -1).scatter(
        1, torch.where(unclaimed, det_rank, k_det - 1),
        torch.where(unclaimed, dets, -1).expand_as(det_rank))
    cand = det_of_rank.gather(1, free_rank.clamp(0, k_det - 1))
    birth = free & (cand >= 0) \
        & (free_rank < unclaimed.sum(-1, keepdim=True))
    birth_idx = cand.clamp(0, k_det - 1)
    birth_z = _bbox_to_z(boxes.gather(1, birth_idx[..., None]
                                      .expand(-1, -1, 4)))
    new_mean = torch.cat([birth_z, torch.zeros_like(birth_z[..., :3])], -1)
    state_mean = torch.where(birth[..., None], new_mean, state["mean"])
    state_cov = torch.where(birth[..., None, None],
                            _mat(_P0, boxes.device), state["cov"])
    birth_order = (birth.cumsum(-1) - 1).to(torch.int32)
    track_id = torch.where(birth, state["next_id"][:, None] + birth_order,
                           state["track_id"])
    st = torch.where(birth, TENTATIVE, st)
    hits = torch.where(birth, 1, hits)
    tsu = torch.where(birth, 0, tsu)
    score = torch.where(birth, scores.gather(1, birth_idx), score)

    out_state = {
        "mean": state_mean, "cov": state_cov, "track_id": track_id,
        "state": st, "hits": hits, "tsu": tsu, "score": score,
        "next_id": state["next_id"] + birth.sum(-1).to(torch.int32),
    }
    return out_state, _slot_outputs(out_state)


def _slot_outputs(state) -> Dict[str, torch.Tensor]:
    return {"boxes": _z_to_bbox(state["mean"][..., :4]),
            "track_id": state["track_id"], "state": state["state"],
            "score": state["score"], "confirmed": state["state"] == CONFIRMED}


def track_clip_batch(boxes, scores, valid, max_tracks: int = 8,
                     device=None):
    """Track a batch of clips: (B, T, K, 4) boxes and (B, T, K) scores and
    valid flags (numpy or tensors) -> (final state, per-frame slot outputs
    (B, T, S, ...)), on ``device`` (default: the card)."""
    dev = resolve_device(device)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    scores = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    state = init_state(max_tracks, boxes.shape[0], dev)
    outs: List[Dict[str, torch.Tensor]] = []
    for t in range(boxes.shape[1]):
        state, out = tracker_step(state, boxes[:, t], scores[:, t],
                                  valid[:, t])
        outs.append(out)
    if not outs:                # a clip with no frames: (B, 0, S, ...)
        return state, {k: v[:, None][:, :0]
                       for k, v in _slot_outputs(state).items()}
    return state, {k: torch.stack([o[k] for o in outs], dim=1)
                   for k in outs[0]}


def track_clip(boxes, scores, valid, max_tracks: int = 8, device=None):
    """Track one clip: (T, K, 4) boxes + (T, K) scores/valid -> per-frame
    slot outputs (T, S, ...)."""
    final, outs = track_clip_batch(
        torch.as_tensor(boxes)[None], torch.as_tensor(scores)[None],
        torch.as_tensor(valid)[None], max_tracks, device)
    return ({k: v[0] for k, v in final.items()},
            {k: v[0] for k, v in outs.items()})


def pack_detection_frames(frame_entries, max_det: int = 16):
    """yolo-result frames -> fixed-K (T, K, 4) boxes, (T, K) scores and
    valid flags, and the frame numbers."""
    t = len(frame_entries)
    boxes = np.zeros((t, max_det, 4), np.float32)
    scores = np.zeros((t, max_det), np.float32)
    valid = np.zeros((t, max_det), bool)
    frames = []
    for i, entry in enumerate(frame_entries):
        frames.append(int(entry.get("frame", i)))
        for j, d in enumerate(entry.get("detections", [])[:max_det]):
            boxes[i, j] = d["bbox"]
            scores[i, j] = d["confidence"]
            valid[i, j] = True
    return boxes, scores, valid, frames


def track_detection_frames(frame_entries, max_tracks: int = 8,
                           max_det: int = 16, device=None
                           ) -> Tuple[list, list, dict]:
    """The driver's wrapper over ``track_clip`` for yolo-result frames.

    ``frame_entries`` is the yolo result's ``detections`` list (each entry
    ``{"frame": int, "detections": [{"bbox", "confidence"}, ...]}``).
    Returns (frame_tracks, summaries, statistics) in the structures of the
    host ByteTracker path, so the two backends are interchangeable in the
    driver.
    """
    t = len(frame_entries)
    boxes, scores, valid, frames = pack_detection_frames(frame_entries,
                                                         max_det)
    final, outs = track_clip(boxes, scores, valid, max_tracks=max_tracks,
                             device=device)
    st = outs["state"].cpu().numpy()            # (T, S)
    ids = outs["track_id"].cpu().numpy()
    ob = outs["boxes"].cpu().numpy()
    sc = outs["score"].cpu().numpy()

    frame_tracks = []
    per_track: Dict[int, Dict] = {}
    for i in range(t):
        for s in np.where(st[i] == CONFIRMED)[0]:
            tid = int(ids[i, s])
            frame_tracks.append({
                "frame": frames[i], "track_id": tid,
                "bbox": ob[i, s].tolist(),
                "confidence": float(sc[i, s]), "state": "CONFIRMED"})
            rec = per_track.setdefault(tid, {"frames": [], "confs": []})
            rec["frames"].append(frames[i])
            rec["confs"].append(float(sc[i, s]))
    summaries = [{
        "track_id": tid,
        "start_frame": rec["frames"][0], "end_frame": rec["frames"][-1],
        "total_frames": len(rec["frames"]),
        "avg_confidence": float(np.mean(rec["confs"])),
    } for tid, rec in sorted(per_track.items())]
    fs = final["state"].cpu().numpy()
    statistics = {
        "total_tracks": int(final["next_id"]) - 1,
        "active_tracks": int((fs == CONFIRMED).sum()),
        "confirmed": int((fs == CONFIRMED).sum()),
        "tentative": int((fs == TENTATIVE).sum()),
        "lost": int((fs == LOST).sum()),
        "frame_id": frames[-1] + 1 if frames else 0,
        "high_thresh": 0.6,
        "backend": "device",
    }
    return frame_tracks, summaries, statistics
