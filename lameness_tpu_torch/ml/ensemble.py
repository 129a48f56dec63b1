"""The tabular GBDT ensemble's inference (port of
``lameness_tpu/ml/ensemble.py``: ``load`` and ``predict``).

The ml-pipeline's CatBoost / XGBoost / LightGBM trio and its weighted
ensemble (``services/ml-pipeline/app/main.py:72-114, 241-303``), on the
host.  The reference-format files (``xgboost_latest.json``,
``lightgbm_latest.txt``, ``catboost_latest.json``) load through the numpy
readers of ``gbdt_io``; a slot without one falls back to its
``<slot>_latest.joblib`` dump, and ``joblib`` is imported only when such a
file exists (the card's machine has no joblib).  Fitting and saving stay
with the JAX package's trainer until the port has training.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

from .gbdt_io import load_reference_model

MODEL_SLOTS = ("catboost", "xgboost", "lightgbm")
DEFAULT_WEIGHTS = {"catboost": 0.35, "xgboost": 0.35, "lightgbm": 0.30}


class GBDTEnsemble:
    """Three-slot boosted ensemble with the reference's predict() contract."""

    def __init__(self, models_dir: Path):
        self.models_dir = Path(models_dir)
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self.models: Dict[str, Any] = {}
        self.ensemble_weights: Dict[str, float] = dict(DEFAULT_WEIGHTS)
        self.load()

    def _slot_path(self, slot: str) -> Path:
        return self.models_dir / f"{slot}_latest.joblib"

    def load(self) -> None:
        for slot in MODEL_SLOTS:
            # the reference's own model-file formats take precedence
            try:
                ref = load_reference_model(self.models_dir, slot)
            except Exception:
                ref = None
            if ref is not None:
                self.models[slot] = ref
                continue
            p = self._slot_path(slot)
            if p.exists():
                try:
                    import joblib
                    self.models[slot] = joblib.load(p)
                except Exception:
                    pass
        w = self.models_dir / "ensemble_weights.json"
        if w.exists():
            try:
                with open(w) as f:
                    self.ensemble_weights = json.load(f)
            except (OSError, ValueError):
                pass

    def predict(self, features: np.ndarray) -> Dict[str, Any]:
        """Per-model probabilities + weighted ensemble (ml:241-303).  Missing
        models are skipped; with none loaded the ensemble defaults to 0.5."""
        if features.ndim == 1:
            features = features.reshape(1, -1)
        predictions: Dict[str, Any] = {}
        for slot in MODEL_SLOTS:
            model = self.models.get(slot)
            if model is None:
                continue
            try:
                proba = float(model.predict_proba(features)[0, 1])
            except Exception:
                continue
            predictions[slot] = {"probability": proba,
                                 "prediction": int(proba > 0.5)}
        ens = 0.0
        total_w = 0.0
        for slot, w in self.ensemble_weights.items():
            if slot in predictions:
                ens += predictions[slot]["probability"] * w
                total_w += w
        ens = ens / total_w if total_w > 0 else 0.5
        predictions["ensemble"] = {"probability": float(ens),
                                   "prediction": int(ens > 0.5),
                                   "weights": self.ensemble_weights}
        return predictions

    @property
    def has_models(self) -> bool:
        return bool(self.models)
