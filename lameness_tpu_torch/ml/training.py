"""Training service for the tabular ensemble (port of
``lameness_tpu/ml/training.py``, a copy: host numpy).

Behavioral rebuild of ``services/training-service/app/main.py``: collects
``data/training/labels/*_label.json`` paired with per-pipeline feature
files, trains the three-slot GBDT ensemble with stratified CV, persists
models + a status JSON (``data/training/training_status.json``,
training-service:56-67), and publishes ``training.completed``.

Deliberate quirk §2.9.6 fix: the reference silently synthesizes RANDOM
features for videos with no pipeline results (training-service:177-191).
We refuse to fabricate data — such videos are skipped and counted in the
status report instead.  Videos with partial features still get the
reference's default fill-ins.
"""
from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .ensemble import GBDTEnsemble

FEATURE_DEFAULTS = {
    "yolo_confidence_mean": 0.5, "yolo_detection_count": 1,
    "yolo_bbox_area_mean": 0.3, "stride_length": 0.5,
    "stride_regularity": 0.5, "back_arch": 0.1, "head_bob": 0.1,
    "limb_asymmetry": 0.1, "dinov3_embedding_norm": 1.0,
    "dinov3_similarity_score": 0.5, "fusion_probability": 0.5,
}
FEATURE_ORDER = list(FEATURE_DEFAULTS)


class TrainingService:
    def __init__(self, dirs, models_dir: Optional[Path] = None,
                 bus=None, subjects=None):
        self.dirs = dirs
        self.labels_dir = dirs.training / "labels"
        self.labels_dir.mkdir(parents=True, exist_ok=True)
        self.models_dir = Path(models_dir) if models_dir else dirs.models / "ml"
        self.ensemble = GBDTEnsemble(self.models_dir)
        self.bus = bus
        self.subjects = subjects
        self.status_path = dirs.training / "training_status.json"

    # -- feature collection --------------------------------------------------
    def _load_features(self, video_id: str) -> Optional[Dict[str, float]]:
        feats: Dict[str, float] = {}

        def read(pipeline: str):
            f = self.dirs.results_for(pipeline) / f"{video_id}_{pipeline}.json"
            if f.exists():
                try:
                    return json.load(open(f))
                except Exception:
                    return None
            return None

        yolo = read("yolo")
        if yolo:
            yf = yolo.get("features", {})
            feats["yolo_confidence_mean"] = yf.get("avg_confidence", 0.5)
            feats["yolo_detection_count"] = yf.get("num_detections", 0)
            feats["yolo_bbox_area_mean"] = yf.get("avg_box_area", 0)
        tleap = read("tleap")
        if tleap:
            loco = (tleap.get("locomotion_traits")
                    or tleap.get("locomotion_features") or {})
            strides = [loco.get(f"stride_{leg}_mean")
                       for leg in ("fl", "fr", "rl", "rr")]
            strides = [s for s in strides if s is not None]
            feats["stride_length"] = float(np.mean(strides)) if strides else 0
            stds = [loco.get(f"stride_{leg}_std")
                    for leg in ("fl", "fr", "rl", "rr")]
            stds = [s for s in stds if s is not None]
            feats["stride_regularity"] = 1.0 / (1.0 + float(np.mean(stds))) \
                if stds else 0
            feats["back_arch"] = loco.get("back_arch_score", 0)
            feats["head_bob"] = loco.get("head_bob_score", 0)
            asyms = [loco.get("front_leg_asymmetry"),
                     loco.get("rear_leg_asymmetry")]
            asyms = [a for a in asyms if a is not None]
            feats["limb_asymmetry"] = float(np.mean(asyms)) if asyms else 0
        dino = read("dinov3")
        if dino:
            emb = dino.get("embedding")
            feats["dinov3_embedding_norm"] = float(
                np.linalg.norm(emb)) if emb else 0
            cases = dino.get("similar_cases", [])
            feats["dinov3_similarity_score"] = float(
                np.mean([c.get("score", 0) for c in cases])) if cases else 0
        fusion = read("fusion")
        if fusion:
            feats["fusion_probability"] = fusion.get(
                "fusion_result", {}).get("final_probability", 0.5)

        if not feats:
            return None                 # §2.9.6 fix: no fabricated features
        for k, v in FEATURE_DEFAULTS.items():
            feats.setdefault(k, v)
        return feats

    def get_labeled_data(self):
        """Returns (X, y, video_ids, skipped)."""
        rows: List[List[float]] = []
        labels: List[int] = []
        vids: List[str] = []
        skipped: List[str] = []
        for label_file in sorted(self.labels_dir.glob("*_label.json")):
            video_id = label_file.stem.replace("_label", "")
            try:
                label_data = json.load(open(label_file))
            except Exception:
                continue
            label = label_data.get("label")
            if label is None:
                continue
            feats = self._load_features(video_id)
            if feats is None:
                skipped.append(video_id)
                continue
            rows.append([float(feats[k]) for k in FEATURE_ORDER])
            labels.append(int(label))
            vids.append(video_id)
        x = np.asarray(rows, np.float64) if rows else np.zeros((0, len(FEATURE_ORDER)))
        return x, np.asarray(labels, np.int64), vids, skipped

    def add_label(self, video_id: str, label: int,
                  confidence: str = "certain") -> None:
        from ..io import schemas
        schemas.write_result(      # atomic: get_labeled_data scans live
            self.labels_dir / f"{video_id}_label.json",
            {"label": int(label), "confidence": confidence,
             "labeled_at": datetime.now(timezone.utc).isoformat()})

    # -- training ------------------------------------------------------------
    def _apply_ml_config(self) -> int:
        """Load the admin-editable ml_config.json (the reference persists
        it via routers/ml_config.py save_config) and apply per-model
        hyperparameters + cv_folds to this run. Returns cv_folds."""
        cfg_path = Path(self.dirs.root) / "ml_config.json"
        if not cfg_path.exists():
            return 5
        try:
            cfg = json.load(open(cfg_path))
        except Exception:
            return 5
        for slot in ("catboost", "xgboost", "lightgbm"):
            if isinstance(cfg.get(slot), dict):
                self.ensemble.params[slot] = cfg[slot]
        return int((cfg.get("training") or {}).get("cv_folds", 5))

    def run_training(self, cv_folds: Optional[int] = None) -> Dict[str, Any]:
        configured = self._apply_ml_config()
        if cv_folds is None:
            cv_folds = configured
        x, y, vids, skipped = self.get_labeled_data()
        status: Dict[str, Any] = {
            "status": "running",
            "started_at": datetime.now(timezone.utc).isoformat(),
            "num_labeled": int(len(y)),
            "num_skipped_no_features": len(skipped),
            "skipped_videos": skipped,
        }
        self._write_status(status)
        if len(y) < 2 or len(np.unique(y)) < 2:
            status["status"] = "failed"
            status["error"] = ("insufficient labeled data: need >=2 samples "
                               "covering both classes")
            self._write_status(status)
            return status
        report = self.ensemble.fit(x, y, cv_folds=cv_folds,
                                   feature_names=FEATURE_ORDER)
        status.update({"status": "completed", "report": report,
                       "completed_at": datetime.now(timezone.utc).isoformat(),
                       "feature_names": FEATURE_ORDER})
        self._write_status(status)
        if self.bus is not None:
            subject = (self.subjects.training_completed if self.subjects
                       else "training.completed")
            self.bus.publish_sync(subject, {
                "type": "ml", "num_samples": int(len(y)), "report": report})
        return status

    def handle_training_request(self, message: dict) -> Dict[str, Any]:
        """``training.ml.requested`` handler (training-service:380-394)."""
        return self.run_training()

    def _write_status(self, status: Dict[str, Any]) -> None:
        # atomic: the admin API's /api/training/status reads this file
        # while training updates it
        from ..io import schemas
        schemas.write_result(self.status_path, status)

    def get_status(self) -> Dict[str, Any]:
        if self.status_path.exists():
            return json.load(open(self.status_path))
        return {"status": "never_run"}
