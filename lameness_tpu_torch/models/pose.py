"""Cow pose + locomotion features, device path (port of the device
functions of ``lameness_tpu/models/pose.py``).

``heuristic_keypoints_device`` is the reference's anatomical-proportion
fallback (tleap:199-265) over boxes; ``map_roboflow_to_old_device`` turns a
trained model's 20 Roboflow keypoints into the heuristic's (old animal-pose)
order; ``locomotion_features_device`` the masked, static-shape locomotion
features (tleap:338-436).  The tables are copies of the JAX module's (this
package imports nothing of it).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def heuristic_keypoints_device(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 20, 3) xy + conf in H_NAMES order."""
    def t(a):
        return torch.as_tensor(a, device=boxes.device)
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
    src = torch.as_tensor(_R2O_SRC, dtype=torch.long, device=kpts.device)
    ok = torch.as_tensor(_R2O_OK, device=kpts.device)
    mapped = kpts[..., src, :]
    conf = torch.where(ok, mapped[..., 2], torch.zeros_like(mapped[..., 2]))
    return torch.cat([mapped[..., :2], conf[..., None]], dim=-1)


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
