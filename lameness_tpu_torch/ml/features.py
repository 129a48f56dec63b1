"""Tabular features from the pipeline results (port of
``lameness_tpu/ml/features.py``, copied line for line).

``services/ml-pipeline/app/main.py:148-239``: up to 12 features from
whichever results exist (YOLO 4, SAM3 3, DINOv3 2, T-LEAP 3), a ten-0.5
vector when none does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def extract_features(pipeline_results: Dict[str, Optional[Dict[str, Any]]]
                     ) -> Tuple[np.ndarray, List[str]]:
    features: List[float] = []
    names: List[str] = []

    yolo = pipeline_results.get("yolo")
    if yolo and "features" in yolo:
        f = yolo["features"]
        features += [f.get("avg_confidence", 0), f.get("position_stability", 0),
                     f.get("avg_box_area", 0), f.get("detection_rate", 0)]
        names += ["yolo_conf", "yolo_stability", "yolo_area", "yolo_rate"]

    sam3 = pipeline_results.get("sam3")
    if sam3 and "features" in sam3:
        f = sam3["features"]
        features += [f.get("avg_area_ratio", 0), f.get("avg_circularity", 0),
                     f.get("avg_aspect_ratio", 0)]
        names += ["sam3_area_ratio", "sam3_circularity", "sam3_aspect"]

    dinov3 = pipeline_results.get("dinov3")
    if dinov3:
        features += [dinov3.get("neighbor_evidence", 0.5),
                     len(dinov3.get("similar_cases", []))]
        names += ["dinov3_neighbor_evidence", "dinov3_similar_count"]

    tleap = pipeline_results.get("tleap")
    if tleap:
        loco = (tleap.get("locomotion_traits")
                or tleap.get("locomotion_features") or {})
        if any(k in loco for k in ("avg_stride_length", "avg_head_bob",
                                   "asymmetry_score")):
            features += [loco.get("avg_stride_length", 0),
                         loco.get("avg_head_bob", 0),
                         loco.get("asymmetry_score", 0)]
        else:
            strides = [loco.get(f"stride_{leg}_mean")
                       for leg in ("fl", "fr", "rl", "rr")]
            strides = [float(x) for x in strides if x is not None]
            avg_stride = float(np.mean(strides)) if strides else 0.0
            head_bob = float(
                loco.get("head_bob_magnitude")
                if loco.get("head_bob_magnitude") is not None
                else loco.get("head_bob_score", 0.0))
            asyms = [loco.get("front_leg_asymmetry"),
                     loco.get("rear_leg_asymmetry")]
            asyms = [float(x) for x in asyms if x is not None]
            asym = float(np.mean(asyms)) if asyms else 0.0
            features += [avg_stride, head_bob, asym]
        names += ["tleap_stride", "tleap_head_bob", "tleap_asymmetry"]

    if not features:
        features = [0.5] * 10
        names = [f"default_{i}" for i in range(10)]
    return np.asarray(features, np.float64), names


FULL_FEATURE_NAMES = [
    "yolo_conf", "yolo_stability", "yolo_area", "yolo_rate",
    "sam3_area_ratio", "sam3_circularity", "sam3_aspect",
    "dinov3_neighbor_evidence", "dinov3_similar_count",
    "tleap_stride", "tleap_head_bob", "tleap_asymmetry",
]
