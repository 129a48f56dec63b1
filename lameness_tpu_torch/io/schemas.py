"""Result-JSON schema builders (port of ``lameness_tpu/io/schemas.py``).

The result files are the system's public contract: every downstream
consumer of the reference reads files, not messages.  These are the JAX
module's builders for the files the stream writes (yolo, sam3, dinov3,
tleap, tcn, transformer) and the analysis after it (gnn,
graph_transformer, ml, tracking, fusion, cow predictions) and curation's
quality report, copied line for line (numpy only), with its
required-key registry and ``validate``; keys, nesting and number formats
equal the JAX package's.  The deliberate fixes of the reference's quirks
stay: the SAM shape features under both ``aggregated_features`` and
``features``, and the top-level average ``embedding`` in the dinov3 file.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _f(x) -> float:
    return float(np.asarray(x))


def write_result(path: Path, obj: Dict[str, Any]) -> Path:
    """Atomic result-file write (tmp + rename in the same directory).

    Result JSONs are read concurrently with their production: the admin
    API serves them, fusion best-effort-reads sibling pipelines'
    files (§2.9.4), ``wait_for_analysis`` polls for the fusion file, and
    the stream path's writer thread races all of them.  A bare
    ``json.dump`` exposes partially-written files to those readers
    (caught by tests/test_soak.py); ``os.replace`` is atomic on POSIX so
    readers see either the old file or the complete new one, never a
    torn write.  (The reference writes non-atomically and carries this
    race.)
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------
def yolo_detection_entry(frame: int, bbox: Sequence[float], confidence: float,
                         class_name: str, class_id: int) -> Dict[str, Any]:
    return {
        "frame": int(frame),
        "bbox": [_f(b) for b in bbox],
        "confidence": _f(confidence),
        "class": class_name,
        "class_id": int(class_id),
    }


def yolo_frame_entry(frame: int, fps: float,
                     detections: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "frame": int(frame),
        "time": frame / fps if fps > 0 else 0,
        "detections": detections,
    }


def yolo_features(all_boxes: np.ndarray, confidences: np.ndarray,
                  num_frames_with_dets: int, total_frames: int) -> Dict[str, Any]:
    """Aggregate detection features (yolo:120-164)."""
    if all_boxes.size == 0:
        return {}
    widths = all_boxes[:, 2] - all_boxes[:, 0]
    heights = all_boxes[:, 3] - all_boxes[:, 1]
    areas = widths * heights
    cx = (all_boxes[:, 0] + all_boxes[:, 2]) / 2
    cy = (all_boxes[:, 1] + all_boxes[:, 3]) / 2
    position_stability = 1.0 / (1.0 + np.std(cx) + np.std(cy))
    return {
        "num_detections": int(len(all_boxes)),
        "avg_confidence": _f(np.mean(confidences)),
        "max_confidence": _f(np.max(confidences)),
        "min_confidence": _f(np.min(confidences)),
        "avg_box_area": _f(np.mean(areas)),
        "avg_box_width": _f(np.mean(widths)),
        "avg_box_height": _f(np.mean(heights)),
        "position_stability": _f(position_stability),
        "avg_center_x": _f(np.mean(cx)),
        "avg_center_y": _f(np.mean(cy)),
        "detection_rate": num_frames_with_dets / total_frames if total_frames > 0 else 0,
    }


def yolo_result(detections: List[Dict[str, Any]], features: Dict[str, Any],
                total_frames: int, fps: float) -> Dict[str, Any]:
    return {
        "detections": detections,
        "features": features,
        "total_frames": int(total_frames),
        "fps": int(fps),
        "frames_processed": len(detections),
    }


def yolo_message(video_id: str, results_path: str, result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "yolo",
        "results_path": results_path,
        "features": result["features"],
        "num_detections": len(result["detections"]),
        "total_frames": result["total_frames"],
    }


# ---------------------------------------------------------------------------
# SAM3
# ---------------------------------------------------------------------------
def sam3_frame_features(mask_area: float, area_ratio: float, circularity: float,
                        aspect_ratio: float, centroid_x: float, centroid_y: float,
                        perimeter: float, frame: int, fps: float) -> Dict[str, Any]:
    return {
        "mask_area": _f(mask_area),
        "area_ratio": _f(area_ratio),
        "circularity": _f(circularity),
        "aspect_ratio": _f(aspect_ratio),
        "centroid_x": _f(centroid_x),
        "centroid_y": _f(centroid_y),
        "perimeter": _f(perimeter),
        "frame": int(frame),
        "time": frame / fps if fps > 0 else 0,
    }


def sam3_segmentation_entry(frame: int, fps: float, mask_available: bool,
                            features: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "frame": int(frame),
        "time": frame / fps if fps > 0 else 0,
        "mask_available": bool(mask_available),
    }
    if mask_available and features is not None:
        entry["features"] = features
    return entry


def sam3_aggregated(frame_features: List[Dict[str, Any]]) -> Dict[str, Any]:
    if not frame_features:
        return {}
    return {
        "avg_mask_area": _f(np.mean([f["mask_area"] for f in frame_features])),
        "avg_area_ratio": _f(np.mean([f["area_ratio"] for f in frame_features])),
        "avg_circularity": _f(np.mean([f["circularity"] for f in frame_features])),
        "avg_aspect_ratio": _f(np.mean([f["aspect_ratio"] for f in frame_features])),
    }


def sam3_result(segmentations: List[Dict[str, Any]], aggregated: Dict[str, Any],
                total_frames: int, fps: float) -> Dict[str, Any]:
    return {
        "segmentations": segmentations,
        "aggregated_features": aggregated,
        # Quirk-1 fix: duplicate under "features" for ml/gnn/gt readers.
        "features": aggregated,
        "total_frames": int(total_frames),
        "fps": int(fps),
        "frames_processed": len(segmentations),
    }


def sam3_message(video_id: str, results_path: str, result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "sam3",
        "results_path": results_path,
        "features": result["aggregated_features"],
        "num_segmentations": len(result["segmentations"]),
    }


# ---------------------------------------------------------------------------
# DINOv3
# ---------------------------------------------------------------------------
def dinov3_embedding_entry(frame: int, fps: float,
                           embedding: Sequence[float]) -> Dict[str, Any]:
    return {
        "frame": int(frame),
        "time": frame / fps if fps > 0 else 0,
        "embedding": [float(v) for v in embedding],
    }


def dinov3_result(video_id: str, avg_embedding: np.ndarray,
                  num_embeddings: int, similar_cases: List[Dict[str, Any]],
                  neighbor_evidence: float,
                  canonical_frames: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "embedding_dim": int(len(avg_embedding)),
        "num_embeddings": int(num_embeddings),
        "similar_cases": similar_cases,
        "neighbor_evidence": _f(neighbor_evidence),
        "canonical_frames": canonical_frames,
        # Quirk-2 fix: top-level average embedding so gnn/gt kNN works.
        "embedding": [float(v) for v in np.asarray(avg_embedding)],
    }


def dinov3_message(video_id: str, results_path: str, result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "dinov3",
        "results_path": results_path,
        "neighbor_evidence": result["neighbor_evidence"],
        "similar_cases": result["similar_cases"],
        "embedding_dim": result["embedding_dim"],
    }


# ---------------------------------------------------------------------------
# T-LEAP pose
# ---------------------------------------------------------------------------
def tleap_result(video_id: str, total_frames: int, fps: float,
                 pose_sequences: List[Dict[str, Any]],
                 locomotion_features: Dict[str, Any], model_type: str,
                 keypoint_names: List[str], skeleton: List[List[str]],
                 colors: Dict[str, List[int]]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "tleap",
        "total_frames": int(total_frames),
        "fps": int(fps),
        "frames_processed": len(pose_sequences),
        "pose_sequences": pose_sequences,
        "locomotion_features": locomotion_features,
        "model_type": model_type,
        "skeleton_definition": {
            "keypoint_names": keypoint_names,
            "skeleton_connections": skeleton,
            "colors": colors,
        },
    }


def tleap_message(video_id: str, results_path: str, result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "tleap",
        "results_path": results_path,
        "features": result["locomotion_features"],
        "frames_processed": result["frames_processed"],
        "model_type": result["model_type"],
    }


# ---------------------------------------------------------------------------
# Sequence predictor heads (TCN / transformer)
# ---------------------------------------------------------------------------
def tcn_result(video_id: str, severity: float, uncertainty: float,
               input_frames: int, input_features: int,
               receptive_field: int) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "tcn",
        "severity_score": _f(severity),
        "uncertainty": _f(uncertainty),
        "prediction": int(severity > 0.5),
        "confidence": 1.0 - _f(uncertainty),
        "input_frames": int(input_frames),
        "input_features": int(input_features),
        "model_receptive_field": int(receptive_field),
    }


def transformer_result(video_id: str, severity: float, uncertainty: float,
                       input_frames: int, input_features: int, masked_frames: int,
                       temporal_saliency: Sequence[float], d_model: int,
                       num_layers: int, nhead: int) -> Dict[str, Any]:
    sal = [float(v) for v in temporal_saliency]
    return {
        "video_id": video_id,
        "pipeline": "transformer",
        "severity_score": _f(severity),
        "uncertainty": _f(uncertainty),
        "prediction": int(severity > 0.5),
        "confidence": 1.0 - _f(uncertainty),
        "input_frames": int(input_frames),
        "input_features": int(input_features),
        "masked_frames": int(masked_frames),
        "temporal_saliency": sal[:20],
        "model_info": {"d_model": d_model, "num_layers": num_layers, "nhead": nhead},
    }


# ---------------------------------------------------------------------------
# Graph heads
# ---------------------------------------------------------------------------
def gnn_result(video_id: str, cow_id: Optional[str], model: str,
               node_score: float, cow_score: float, uncertainty: float,
               graph_info: Dict[str, Any],
               neighbor_influence: List[Dict[str, Any]],
               videos_in_graph: List[str]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "cow_id": cow_id,
        "pipeline": "gnn",
        "model": model,
        "severity_score": _f(node_score),
        "cow_severity_score": _f(cow_score),
        "uncertainty": _f(uncertainty),
        "prediction": int(node_score > 0.5),
        "cow_prediction": int(cow_score > 0.5),
        "confidence": 1.0 - _f(uncertainty),
        "graph_info": graph_info,
        "neighbor_influence": neighbor_influence[:5],
        "videos_in_graph": videos_in_graph,
    }


def graph_transformer_result(video_id: str, cow_id: Optional[str],
                             node_score: float, cow_score: float,
                             uncertainty: float, graph_info: Dict[str, Any],
                             attention_info: Dict[str, Any],
                             videos_in_graph: List[str]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "cow_id": cow_id,
        "pipeline": "graph_transformer",
        "model": "CowLamenessGraphormer",
        "graph_prediction": _f(cow_score),
        "node_prediction": _f(node_score),
        "cow_severity_score": _f(cow_score),
        "uncertainty": _f(uncertainty),
        "prediction": int(node_score > 0.5),
        "cow_prediction": int(cow_score > 0.5),
        "confidence": 1.0 - _f(uncertainty),
        "graph_info": graph_info,
        "attention_info": attention_info,
        "videos_in_graph": videos_in_graph,
    }


# ---------------------------------------------------------------------------
# ML tabular ensemble
# ---------------------------------------------------------------------------
def ml_result(video_id: str, features: np.ndarray, feature_names: List[str],
              predictions: Dict[str, Any],
              availability: Dict[str, bool]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "features": [float(v) for v in np.asarray(features).ravel()],
        "feature_names": feature_names,
        "predictions": predictions,
        "pipeline_results_available": availability,
    }


def ml_message(video_id: str, results_path: str, result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "ml",
        "results_path": results_path,
        "predictions": result["predictions"],
    }


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------
def tracking_result(video_id: str, track_summaries: List[Dict[str, Any]],
                    frame_tracks: List[Dict[str, Any]],
                    statistics: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "pipeline": "tracking",
        "total_tracks": len(track_summaries),
        "track_summaries": track_summaries,
        "frame_tracks": frame_tracks,
        "statistics": statistics,
    }


def reid_entry(track_id: int, cow_id: str, identity_id: str, similarity: float,
               confidence: float, is_new: bool) -> Dict[str, Any]:
    return {
        "track_id": int(track_id),
        "cow_id": cow_id,
        "identity_id": identity_id,
        "similarity": _f(similarity),
        "confidence": _f(confidence),
        "is_new": bool(is_new),
    }


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------
def fusion_result_file(video_id: str, cow_id: Optional[str],
                       fusion_result: Dict[str, Any],
                       cow_prediction: Optional[Dict[str, Any]],
                       pipeline_predictions: Dict[str, Any],
                       timestamp: str = "") -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "cow_id": cow_id,
        "fusion_result": fusion_result,
        "cow_prediction": cow_prediction,
        "pipeline_predictions": pipeline_predictions,
        "timestamp": timestamp,
    }


def cow_prediction_file(cow_id: str, prediction: Dict[str, Any],
                        latest_video: str, last_updated: str) -> Dict[str, Any]:
    return {
        "cow_id": cow_id,
        "prediction": prediction,
        "last_updated": last_updated,
        "latest_video": latest_video,
    }


def quality_report(video_id: str, source: Dict[str, Any], passes: List[Dict[str, Any]],
                   selected_window: Optional[Dict[str, Any]],
                   backup_window: Optional[Dict[str, Any]], status: str,
                   rejection_reason: Optional[str],
                   target_fps: int = 25, target_resolution=(1280, 720),
                   target_duration: float = 5.0) -> Dict[str, Any]:
    return {
        "video_id": video_id,
        "source_video": source,
        "canonical_clip": {
            "target_fps": target_fps,
            "target_resolution": list(target_resolution),
            "target_duration": target_duration,
        },
        "walking_passes_detected": len(passes),
        "passes": passes,
        "selected_window": selected_window,
        "backup_window": backup_window,
        "status": status,
        "rejection_reason": rejection_reason,
    }


# ---------------------------------------------------------------------------
# Required-key registry for schema validation tests
# ---------------------------------------------------------------------------
REQUIRED_KEYS: Dict[str, List[str]] = {
    "yolo": ["detections", "features", "total_frames", "fps", "frames_processed"],
    "sam3": ["segmentations", "aggregated_features", "total_frames", "fps",
             "frames_processed"],
    "dinov3": ["video_id", "embedding_dim", "num_embeddings", "similar_cases",
               "neighbor_evidence", "canonical_frames"],
    "tleap": ["video_id", "pipeline", "total_frames", "fps", "frames_processed",
              "pose_sequences", "locomotion_features", "model_type",
              "skeleton_definition"],
    "tcn": ["video_id", "pipeline", "severity_score", "uncertainty", "prediction",
            "confidence", "input_frames", "input_features", "model_receptive_field"],
    "transformer": ["video_id", "pipeline", "severity_score", "uncertainty",
                    "prediction", "confidence", "input_frames", "input_features",
                    "masked_frames", "temporal_saliency", "model_info"],
    "gnn": ["video_id", "cow_id", "pipeline", "model", "severity_score",
            "cow_severity_score", "uncertainty", "prediction", "cow_prediction",
            "confidence", "graph_info", "neighbor_influence", "videos_in_graph"],
    "graph_transformer": ["video_id", "cow_id", "pipeline", "model",
                          "graph_prediction", "node_prediction", "cow_severity_score",
                          "uncertainty", "prediction", "cow_prediction", "confidence",
                          "graph_info", "attention_info", "videos_in_graph"],
    "ml": ["video_id", "features", "feature_names", "predictions",
           "pipeline_results_available"],
    "tracking": ["video_id", "pipeline", "total_tracks", "track_summaries",
                 "frame_tracks", "statistics"],
    "fusion": ["video_id", "cow_id", "fusion_result", "pipeline_predictions",
               "timestamp"],
    "quality": ["video_id", "source_video", "canonical_clip",
                "walking_passes_detected", "passes", "selected_window",
                "backup_window", "status", "rejection_reason"],
}


def validate(kind: str, obj: Dict[str, Any]) -> List[str]:
    """Return list of missing required keys (empty == valid)."""
    return [k for k in REQUIRED_KEYS[kind] if k not in obj]
