"""SHAP service: real per-video explanations over the tabular ensemble (port of
``lameness_tpu/xai/shap_service.py``, copied; it runs over the port's
``ml/ensemble.py``).

Replaces the reference's stub (``services/shap-service/app/main.py:35-47``)
with exact Shapley values computed against a background of previously-seen
feature vectors, triggered on ``analysis.complete`` and written under
``data/results/shap/{video_id}_shap.json`` (the path the admin SHAP router
serves, routers/shap.py).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..io import schemas
from .shapley import shap_report


class ShapService:
    def __init__(self, dirs, ensemble, background_size: int = 32):
        self.dirs = dirs
        self.ensemble = ensemble
        self.results_dir = dirs.results / "shap"
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.background_size = background_size

    def _predict(self, rows: np.ndarray) -> np.ndarray:
        out = np.empty(len(rows))
        for i, r in enumerate(rows):
            out[i] = self.ensemble.predict(r)["ensemble"]["probability"]
        return out

    def _background(self, exclude: str, dim: int) -> np.ndarray:
        rows: List[List[float]] = []
        ml_dir = self.dirs.results_for("ml")
        if ml_dir.exists():
            for f in sorted(ml_dir.glob("*_ml.json")):
                if f.stem.replace("_ml", "") == exclude:
                    continue
                try:
                    data = json.load(open(f))
                    feats = data.get("features", [])
                    if len(feats) == dim:
                        rows.append(feats)
                except Exception:
                    continue
                if len(rows) >= self.background_size:
                    break
        if not rows:
            rows = [[0.5] * dim]
        return np.asarray(rows, float)

    def process_analysis(self, message: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """``analysis.complete`` handler — the reference subscribes the same
        way (shap:52) but writes a placeholder; we compute the real values."""
        video_id = message.get("video_id")
        if not video_id:
            return None
        ml_file = self.dirs.results_for("ml") / f"{video_id}_ml.json"
        if not ml_file.exists():
            return None
        ml_data = json.load(open(ml_file))
        feats = np.asarray(ml_data.get("features", []), float)
        names = ml_data.get("feature_names", [])
        if feats.size == 0 or len(names) != feats.size:
            return None
        if not self.ensemble.has_models:
            report = {"video_id": video_id, "status": "no_models",
                      "note": "train the tabular ensemble to enable SHAP"}
        else:
            bg = self._background(video_id, feats.size)
            report = shap_report(self._predict, feats, bg, names, video_id)
        schemas.write_result(self.results_dir / f"{video_id}_shap.json",
                             report)
        return report
