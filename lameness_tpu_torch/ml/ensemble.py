"""The tabular GBDT ensemble (port of ``lameness_tpu/ml/ensemble.py``).

The ml-pipeline's CatBoost / XGBoost / LightGBM trio and its weighted
ensemble (``services/ml-pipeline/app/main.py:72-114, 241-303``), on the
host.  The reference-format files (``xgboost_latest.json``,
``lightgbm_latest.txt``, ``catboost_latest.json``) load through the numpy
readers of ``gbdt_io``; a slot without one falls back to its
``<slot>_latest.joblib`` dump, and ``joblib`` is imported only when such a
file exists (the card's machine has no joblib).

``fit`` trains each slot with the numpy trainer in that library's style
(``gbdt_train``; the boosting libraries are not on the card's machine) and
reports stratified cross-validated accuracy over the folds of
scikit-learn's ``StratifiedKFold(shuffle=True, random_state=42)``
(:func:`stratified_kfold`, the same algorithm).  ``save`` writes the three
reference files and ``ensemble_weights.json``, and no joblib dump.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io import schemas
from .gbdt_io import CATBOOST_JSON, REFERENCE_FILES, load_reference_model
from .gbdt_train import BoostedTreesClassifier, make_numpy_model

MODEL_SLOTS = ("catboost", "xgboost", "lightgbm")
DEFAULT_WEIGHTS = {"catboost": 0.35, "xgboost": 0.35, "lightgbm": 0.30}
CV_SEED = 42            # the reference's StratifiedKFold random_state


def _make_model(slot: str, params: Optional[Dict[str, Any]] = None
                ) -> BoostedTreesClassifier:
    """The numpy trainer in a slot's library style with the reference's
    defaults: 100 boosting rounds, learning rate 0.1, depth 6
    (routers/ml_config.py:26-96, training-service:204-224)."""
    if slot not in MODEL_SLOTS:
        raise ValueError(slot)
    params = params or {}
    return make_numpy_model(slot, dict(
        params, n_estimators=params.get("n_estimators", 100),
        learning_rate=params.get("learning_rate", 0.1),
        max_depth=params.get("max_depth", 6)))


def stratified_kfold(y: np.ndarray, n_splits: int
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index pairs of scikit-learn's
    ``StratifiedKFold(n_splits, shuffle=True, random_state=42).split``:
    classes in order of first appearance, each class's fold sizes dealt
    round robin over the sorted labels, each class's fold labels shuffled
    by one ``RandomState(42)`` in class order; indices ascending."""
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         f"number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)])
    rng = np.random.RandomState(CV_SEED)
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        test = test_folds == i
        yield indices[~test], indices[test]


class GBDTEnsemble:
    """Three-slot boosted ensemble with the reference's predict() contract."""

    def __init__(self, models_dir: Path,
                 params: Optional[Dict[str, Dict[str, Any]]] = None):
        self.models_dir = Path(models_dir)
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self.params = params or {}
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

    def save(self, feature_names: Optional[List[str]] = None) -> None:
        """Write each numpy-trained slot in its reference file format
        (``xgboost_latest.json``, ``lightgbm_latest.txt``,
        ``catboost_latest.json``: what ``load`` reads first) and the
        ensemble weights."""
        for slot, model in self.models.items():
            if not isinstance(model, BoostedTreesClassifier):
                continue
            if slot == "xgboost":
                model.save_xgboost_json(
                    self.models_dir / REFERENCE_FILES[slot],
                    feature_names=feature_names)
            elif slot == "lightgbm":
                model.save_lightgbm_txt(
                    self.models_dir / REFERENCE_FILES[slot],
                    feature_names=feature_names)
            elif slot == "catboost" and model.growth == "oblivious":
                model.save_catboost_json(self.models_dir / CATBOOST_JSON,
                                         feature_names=feature_names)
        schemas.write_result(self.models_dir / "ensemble_weights.json",
                             self.ensemble_weights)

    def fit(self, x: np.ndarray, y: np.ndarray, cv_folds: int = 5,
            feature_names: Optional[List[str]] = None) -> Dict[str, Any]:
        """Train all slots with stratified CV accuracy reporting
        (training-service/app/main.py:193-293), then save."""
        report: Dict[str, Any] = {"models": {}}
        n_splits = min(cv_folds, int(np.bincount(y.astype(int)).min()))
        for slot in MODEL_SLOTS:
            params = self.params.get(slot)
            model = _make_model(slot, params)
            if n_splits >= 2:
                scores = np.asarray([
                    _make_model(slot, params).fit(x[tr], y[tr])
                    .score(x[te], y[te])
                    for tr, te in stratified_kfold(y, n_splits)])
                report["models"][slot] = {
                    "cv_accuracy_mean": float(scores.mean()),
                    "cv_accuracy_std": float(scores.std()),
                }
            else:
                report["models"][slot] = {"cv_accuracy_mean": None,
                                          "cv_accuracy_std": None}
            report["models"][slot]["backend"] = type(model).__name__
            model.fit(x, y)
            self.models[slot] = model
        self.save(feature_names=feature_names)
        report["num_samples"] = int(len(y))
        report["class_balance"] = {str(c): int(n) for c, n in
                                   zip(*np.unique(y, return_counts=True))}
        return report

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
