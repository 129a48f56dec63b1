"""Cow pose + locomotion features (port of ``lameness_tpu/models/pose.py``).

``heuristic_keypoints_device`` is the reference's anatomical-proportion
fallback (tleap:199-265) over boxes; ``map_roboflow_to_old_device`` turns a
trained model's 20 Roboflow keypoints into the heuristic's (old animal-pose)
order; ``locomotion_features_device`` the masked, static-shape locomotion
features (tleap:338-436), ``features_dict_from_device`` one clip's of them
as the host dict.  The host half the result writer reads (numpy):
``compute_locomotion_features`` (the result JSON's authoritative
features), ``heuristic_keypoints`` and the published skeleton tables.  The
tables are copies of the JAX module's (this package imports nothing of it).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.device import constant

# the trained model's 20 Roboflow keypoints, the published skeleton
# contract (tleap:43-64)
KEYPOINT_NAMES = [
    "left_ear_base", "neck", "withers", "mid_back", "right_hind_hip",
    "right_hind_mid_leg", "right_hind_fetlock", "left_hind_shoulder",
    "left_hind_mid_leg", "left_hind_fetlock", "right_front_shoulder",
    "right_front_mid_leg", "right_front_lower_leg", "left_front_shoulder",
    "left_front_mid_leg", "left_front_lower_leg", "right_front_hoof",
    "left_front_hoof", "right_hind_hoof", "left_hind_hoof",
]
NUM_KEYPOINTS = len(KEYPOINT_NAMES)

# Old animal-pose names emitted by the heuristic (tleap:221-263), in emission
# order — locomotion features index these names.
OLD_NAMES = [
    "left_eye", "right_eye", "nose", "left_ear", "right_ear",
    "left_front_elbow", "right_front_elbow", "left_back_elbow",
    "right_back_elbow", "left_front_knee", "right_front_knee",
    "left_back_knee", "right_back_knee", "left_front_paw", "right_front_paw",
    "left_back_paw", "right_back_paw", "throat", "withers", "tailbase",
]

# Skeleton connections + colors (tleap:67-104) — published contract
COW_SKELETON = [
    (0, 1), (0, 2), (1, 2), (0, 3), (1, 4), (2, 17), (17, 18), (18, 19),
    (5, 9), (6, 10), (7, 11), (8, 12), (9, 13), (10, 14), (11, 15), (12, 16),
]
SKELETON_COLORS = {
    "face": (0, 255, 255), "spine": (0, 255, 0), "front_left": (255, 0, 0),
    "front_right": (0, 165, 255), "back_left": (255, 0, 255),
    "back_right": (0, 255, 255),
}

# Roboflow -> old names, so locomotion features resolve in trained mode too
ROBOFLOW_TO_OLD = {
    "left_ear_base": "left_ear", "neck": "throat", "withers": "withers",
    "mid_back": "tailbase",
    "left_front_hoof": "left_front_paw", "right_front_hoof": "right_front_paw",
    "left_hind_hoof": "left_back_paw", "right_hind_hoof": "right_back_paw",
    "left_front_mid_leg": "left_front_knee",
    "right_front_mid_leg": "right_front_knee",
    "left_hind_mid_leg": "left_back_knee",
    "right_hind_mid_leg": "right_back_knee",
    "left_front_shoulder": "left_front_elbow",
    "right_front_shoulder": "right_front_elbow",
    "left_hind_shoulder": "left_back_elbow",
    "right_hind_hip": "right_back_elbow",
}

# (name, ax, ay, conf): x = x1 + ax·w, y = y1 + ay·h (tleap:210-263)
_H = [
    ("left_eye",          0.10 - 0.02, 0.30 - 0.05, 0.7),
    ("right_eye",         0.10 + 0.02, 0.30 - 0.05, 0.7),
    ("nose",              0.10,        0.30 + 0.05, 0.8),
    ("left_ear",          0.10 - 0.05, 0.30 - 0.10, 0.6),
    ("right_ear",         0.10 + 0.05, 0.30 - 0.10, 0.6),
    ("left_front_elbow",  0.25 - 0.05, 0.40, 0.7),
    ("right_front_elbow", 0.25 + 0.05, 0.40, 0.7),
    ("left_back_elbow",   0.75 - 0.05, 0.40, 0.7),
    ("right_back_elbow",  0.75 + 0.05, 0.40, 0.7),
    ("left_front_knee",   0.25 - 0.03, 0.60, 0.7),
    ("right_front_knee",  0.25 + 0.07, 0.60, 0.7),
    ("left_back_knee",    0.75 - 0.07, 0.60, 0.7),
    ("right_back_knee",   0.75 + 0.03, 0.60, 0.7),
    ("left_front_paw",    0.25 - 0.02, 0.95, 0.7),
    ("right_front_paw",   0.25 + 0.08, 0.95, 0.7),
    ("left_back_paw",     0.75 - 0.08, 0.95, 0.7),
    ("right_back_paw",    0.75 + 0.02, 0.95, 0.7),
    ("throat",            0.15, 0.25, 0.8),
    ("withers",           0.30, 0.15, 0.8),
    ("tailbase",          0.90, 0.25, 0.7),
]
_H_AX = np.array([r[1] for r in _H], np.float32)
_H_AY = np.array([r[2] for r in _H], np.float32)
H_CONF = np.array([r[3] for r in _H], np.float32)
H_NAMES = [r[0] for r in _H]
_OLD_IDX = {n: i for i, n in enumerate(H_NAMES)}

# old-name slot -> its source in the Roboflow order; old names with no
# Roboflow source (eyes, nose, right_ear) stay masked (confidence 0)
_OLD_FROM_ROBO = {old: rb for rb, old in ROBOFLOW_TO_OLD.items()}
_ROBO_IDX = {n: i for i, n in enumerate(KEYPOINT_NAMES)}
_R2O_SRC = np.array([_ROBO_IDX.get(_OLD_FROM_ROBO.get(n, ""), 0)
                     for n in H_NAMES], np.int32)
_R2O_OK = np.array([n in _OLD_FROM_ROBO for n in H_NAMES], bool)


def heuristic_keypoints(bbox: List[float]) -> List[Dict[str, Any]]:
    """Host path: bbox xyxy (int-truncated like the reference, tleap:210) ->
    list of 20 old-name keypoint dicts."""
    x1, y1, x2, y2 = [int(c) for c in bbox]
    w, h = x2 - x1, y2 - y1
    return [{"name": n, "x": float(x1 + ax * w), "y": float(y1 + ay * h),
             "confidence": float(c)} for (n, ax, ay, c) in _H]


def heuristic_keypoints_device(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 20, 3) xy + conf in H_NAMES order."""
    def t(a):
        return constant(a, torch.float32, boxes.device)
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    w = boxes[..., 2:3] - x1
    h = boxes[..., 3:4] - y1
    xs = x1 + t(_H_AX) * w
    ys = y1 + t(_H_AY) * h
    conf = t(H_CONF).expand(xs.shape)
    return torch.stack([xs, ys, conf], dim=-1)


def map_roboflow_to_old_device(kpts: torch.Tensor) -> torch.Tensor:
    """(..., 20, 3) keypoints in KEYPOINT_NAMES order -> (..., 20, 3) in
    H_NAMES order, the slots with no source confidence-masked."""
    src = constant(_R2O_SRC, torch.long, kpts.device)
    ok = constant(_R2O_OK, torch.bool, kpts.device)
    mapped = kpts[..., src, :]
    conf = torch.where(ok, mapped[..., 2], torch.zeros_like(mapped[..., 2]))
    return torch.cat([mapped[..., :2], conf[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# locomotion features — host (numpy, result-JSON authoritative)
# ---------------------------------------------------------------------------
def compute_locomotion_features(pose_sequences: List[Dict]) -> Dict[str, float]:
    """Exact replication of tleap:338-436 (conditional feature inclusion,
    thresholds, normalisations, composite score)."""
    if not pose_sequences or len(pose_sequences) < 2:
        return {}
    features: Dict[str, float] = {}
    head_positions: List[float] = []
    hoof_positions = {"fl": [], "fr": [], "rl": [], "rr": []}
    spine_angles: List[float] = []
    for frame_data in pose_sequences:
        keypoints = frame_data.get("keypoints", [])
        if len(keypoints) < 20:
            continue
        kp = {k["name"]: k for k in keypoints}
        nose = kp.get("nose", {})
        if nose.get("confidence", 0) > 0.3:
            head_positions.append(nose.get("y", 0))
        throat, withers, tailbase = (kp.get("throat", {}), kp.get("withers", {}),
                                     kp.get("tailbase", {}))
        if all(k.get("confidence", 0) > 0.3 for k in (throat, withers, tailbase)):
            v1 = np.array([throat["x"] - withers["x"], throat["y"] - withers["y"]])
            v2 = np.array([tailbase["x"] - withers["x"], tailbase["y"] - withers["y"]])
            cosang = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-6)
            spine_angles.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        for leg, name in (("fl", "left_front_paw"), ("fr", "right_front_paw"),
                          ("rl", "left_back_paw"), ("rr", "right_back_paw")):
            k = kp.get(name, {})
            if k.get("confidence", 0) > 0.3:
                hoof_positions[leg].append(k.get("x", 0))
    if spine_angles:
        features["back_arch_mean"] = float(np.mean(spine_angles))
        features["back_arch_std"] = float(np.std(spine_angles))
        features["back_arch_score"] = float(1.0 - np.mean(spine_angles) / 180.0)
    if len(head_positions) > 1:
        features["head_bob_magnitude"] = float(np.std(head_positions))
        head_diff = np.diff(head_positions)
        features["head_bob_frequency"] = float(
            np.sum(np.abs(np.diff(np.sign(head_diff)))) / 2)
        features["head_bob_score"] = float(
            min(1.0, features["head_bob_magnitude"] / 50.0))
    for leg, positions in hoof_positions.items():
        if len(positions) > 1:
            strides = np.diff(positions)
            features[f"stride_{leg}_mean"] = float(np.mean(np.abs(strides)))
            features[f"stride_{leg}_std"] = float(np.std(strides))
    if "stride_fl_mean" in features and "stride_fr_mean" in features:
        features["front_leg_asymmetry"] = float(
            abs(features["stride_fl_mean"] - features["stride_fr_mean"]) /
            (features["stride_fl_mean"] + features["stride_fr_mean"] + 1e-6))
    if "stride_rl_mean" in features and "stride_rr_mean" in features:
        features["rear_leg_asymmetry"] = float(
            abs(features["stride_rl_mean"] - features["stride_rr_mean"]) /
            (features["stride_rl_mean"] + features["stride_rr_mean"] + 1e-6))
    comps = [features[k] for k in ("back_arch_score", "head_bob_score",
                                   "front_leg_asymmetry", "rear_leg_asymmetry")
             if k in features]
    if comps:
        features["lameness_score"] = float(np.mean(comps))
    return features


# ---------------------------------------------------------------------------
# locomotion features — device (masked, static shapes)
# ---------------------------------------------------------------------------
def _masked_mean(x, m):
    """Mean of x over mask m along the last axis, 0 where m is empty."""
    m = m.to(x.dtype)
    n = m.sum(-1)
    return torch.where(n > 0, (x * m).sum(-1) / n.clamp(min=1),
                       torch.zeros_like(n))


def _masked_std(x, m):
    mu = _masked_mean(x, m)
    return torch.sqrt(_masked_mean((x - mu[..., None]) ** 2, m))


def locomotion_features_device(kp_xy: torch.Tensor, kp_conf: torch.Tensor,
                               frame_valid: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
    """(B, T, 20, 2) xy + (B, T, 20) conf in H_NAMES order + (B, T) valid
    -> dict of (B,) features and ``*_ok`` flags (the JAX function vmapped
    over the batch)."""
    i = _OLD_IDX
    conf_ok = (kp_conf > 0.3) & frame_valid[..., None]
    nose_ok = conf_ok[..., i["nose"]]
    head_y = kp_xy[..., i["nose"], 1]

    spine_ok = (conf_ok[..., i["throat"]] & conf_ok[..., i["withers"]]
                & conf_ok[..., i["tailbase"]])
    v1 = kp_xy[..., i["throat"], :] - kp_xy[..., i["withers"], :]
    v2 = kp_xy[..., i["tailbase"], :] - kp_xy[..., i["withers"], :]
    cosang = (v1 * v2).sum(-1) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1) + 1e-6)
    angles = torch.rad2deg(torch.arccos(cosang.clamp(-1, 1)))

    out: Dict[str, torch.Tensor] = {}
    out["back_arch_mean"] = _masked_mean(angles, spine_ok)
    out["back_arch_std"] = _masked_std(angles, spine_ok)
    out["back_arch_score"] = 1.0 - out["back_arch_mean"] / 180.0
    out["back_arch_ok"] = spine_ok.sum(-1) > 0

    out["head_bob_magnitude"] = _masked_std(head_y, nose_ok)
    hd = torch.diff(head_y, dim=-1)
    hd_ok = nose_ok[..., 1:] & nose_ok[..., :-1]
    flips = torch.abs(torch.diff(torch.sign(hd), dim=-1)) \
        * (hd_ok[..., 1:] & hd_ok[..., :-1])
    out["head_bob_frequency"] = flips.sum(-1) / 2
    out["head_bob_score"] = torch.clamp(out["head_bob_magnitude"] / 50.0,
                                        max=1.0)
    out["head_bob_ok"] = nose_ok.sum(-1) > 1

    means = {}
    for leg, name in (("fl", "left_front_paw"), ("fr", "right_front_paw"),
                      ("rl", "left_back_paw"), ("rr", "right_back_paw")):
        x = kp_xy[..., i[name], 0]
        ok = conf_ok[..., i[name]]
        d = torch.diff(x, dim=-1)
        d_ok = ok[..., 1:] & ok[..., :-1]
        out[f"stride_{leg}_mean"] = _masked_mean(torch.abs(d), d_ok)
        out[f"stride_{leg}_std"] = _masked_std(d, d_ok)
        out[f"stride_{leg}_ok"] = ok.sum(-1) > 1
        means[leg] = out[f"stride_{leg}_mean"]

    out["front_leg_asymmetry"] = torch.abs(means["fl"] - means["fr"]) / (
        means["fl"] + means["fr"] + 1e-6)
    out["front_asym_ok"] = out["stride_fl_ok"] & out["stride_fr_ok"]
    out["rear_leg_asymmetry"] = torch.abs(means["rl"] - means["rr"]) / (
        means["rl"] + means["rr"] + 1e-6)
    out["rear_asym_ok"] = out["stride_rl_ok"] & out["stride_rr_ok"]

    comps = torch.stack([out["back_arch_score"], out["head_bob_score"],
                         out["front_leg_asymmetry"],
                         out["rear_leg_asymmetry"]], dim=-1)
    oks = torch.stack([out["back_arch_ok"], out["head_bob_ok"],
                       out["front_asym_ok"], out["rear_asym_ok"]], dim=-1)
    out["lameness_score"] = _masked_mean(comps, oks)
    return out


def features_dict_from_device(out: Dict[str, Any]) -> Dict[str, float]:
    """One clip's ``locomotion_features_device`` output (0-d tensors or
    numpy scalars) -> the host JSON dict: each group's keys only where its
    flag holds, in the JAX function's order, and the lameness score as the
    mean of the components present."""
    f: Dict[str, float] = {}
    if bool(out["back_arch_ok"]):
        for k in ("back_arch_mean", "back_arch_std", "back_arch_score"):
            f[k] = float(out[k])
    if bool(out["head_bob_ok"]):
        for k in ("head_bob_magnitude", "head_bob_frequency",
                  "head_bob_score"):
            f[k] = float(out[k])
    for leg in ("fl", "fr", "rl", "rr"):
        if bool(out[f"stride_{leg}_ok"]):
            f[f"stride_{leg}_mean"] = float(out[f"stride_{leg}_mean"])
            f[f"stride_{leg}_std"] = float(out[f"stride_{leg}_std"])
    if bool(out["front_asym_ok"]):
        f["front_leg_asymmetry"] = float(out["front_leg_asymmetry"])
    if bool(out["rear_asym_ok"]):
        f["rear_leg_asymmetry"] = float(out["rear_leg_asymmetry"])
    comps = [f[k] for k in ("back_arch_score", "head_bob_score",
                            "front_leg_asymmetry", "rear_leg_asymmetry")
             if k in f]
    if comps:
        f["lameness_score"] = float(np.mean(comps))
    return f
