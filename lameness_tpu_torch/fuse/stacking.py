"""Stacking meta-model for fusion + the voting/blending helpers (port of
``lameness_tpu/fuse/stacking.py``).

The reference loads ``shared/models/fusion/stacking_model.pkl`` if present
(fusion:157-167) but nothing ever trains it; its ml-pipeline also ships
voting/stacking/blending helpers (``ml-pipeline/app/ensemble.py:9-46``).
This module provides both: a logistic-regression meta-model fit on the
per-pipeline probabilities of labeled videos, pickled where the fusion
service looks for it, plus the pure-numpy combination helpers.

The meta-model is :class:`LogisticRegression`, the port's own, since the
card's machine has no scikit-learn: scikit-learn's
``LogisticRegression(max_iter=1000)`` objective (mean log-loss plus
``||w||² / (2·C·n)``, C = 1, the intercept not penalised) minimised by
scipy's L-BFGS-B with that class's options.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
from scipy import optimize
from scipy.special import expit

from .fusion import AUTO_KEYS


class LogisticRegression:
    """Binary L2 logistic regression with scikit-learn's
    ``LogisticRegression(max_iter=max_iter)`` fit (lbfgs, C = 1, tol 1e-4)
    and its ``coef_``, ``intercept_``, ``classes_``, ``predict_proba``,
    ``predict`` and ``score``."""

    C = 1.0
    tol = 1e-4

    def __init__(self, max_iter: int = 1000):
        self.max_iter = max_iter

    def fit(self, x, y) -> "LogisticRegression":
        x = np.asarray(x, np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"binary classification only (got classes "
                             f"{self.classes_})")
        t = (y == self.classes_[1]).astype(np.float64)
        n, d = x.shape
        l2 = 1.0 / (self.C * n)

        def loss_grad(w):
            raw = x @ w[:d] + w[d]
            # HalfBinomialLoss: log(1 + e^raw) - t·raw, gradient p - t
            loss = (np.logaddexp(0.0, raw) - t * raw).sum() / n \
                + 0.5 * l2 * (w[:d] @ w[:d])
            gp = (expit(raw) - t) / n
            return loss, np.concatenate([x.T @ gp + l2 * w[:d],
                                         [gp.sum()]])

        res = optimize.minimize(
            loss_grad, np.zeros(d + 1), method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50,
                     "gtol": self.tol, "ftol": 64 * np.finfo(float).eps})
        self.coef_ = res.x[None, :d]
        self.intercept_ = res.x[d:]
        self.n_iter_ = np.asarray([res.nit])
        return self

    def decision_function(self, x) -> np.ndarray:
        return np.asarray(x, np.float64) @ self.coef_[0] + self.intercept_[0]

    def predict_proba(self, x) -> np.ndarray:
        p = expit(self.decision_function(x))
        return np.stack([1.0 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return self.classes_[(self.decision_function(x) > 0).astype(int)]

    def score(self, x, y) -> float:
        return float(np.average(self.predict(x) == np.asarray(y)))


def soft_voting(probabilities: Sequence[float],
                weights: Optional[Sequence[float]] = None) -> float:
    """Weighted mean of probabilities (ensemble.py voting helper)."""
    p = np.asarray(probabilities, float)
    if weights is None:
        return float(p.mean())
    w = np.asarray(weights, float)
    return float((p * w).sum() / max(w.sum(), 1e-12))


def blending(probabilities: Sequence[float], holdout_acc: Sequence[float]
             ) -> float:
    """Accuracy-weighted blend: weights ∝ holdout accuracy − 0.5 (clamped)."""
    w = np.clip(np.asarray(holdout_acc, float) - 0.5, 0.0, None)
    if w.sum() <= 0:
        return soft_voting(probabilities)
    return soft_voting(probabilities, w)


def collect_stacking_dataset(dirs) -> Optional[Dict[str, np.ndarray]]:
    """Labeled videos × per-pipeline probabilities from fusion result files
    (the features the fusion stacking path consumes, fusion:560-567)."""
    labels_dir = dirs.training / "labels"
    if not labels_dir.exists():
        return None
    rows, ys, vids = [], [], []
    for label_file in sorted(labels_dir.glob("*_label.json")):
        vid = label_file.stem.replace("_label", "")
        try:
            label = json.load(open(label_file)).get("label")
        except Exception:
            continue
        if label is None:
            continue
        fusion_file = dirs.results_for("fusion") / f"{vid}_fusion.json"
        if not fusion_file.exists():
            continue
        data = json.load(open(fusion_file))
        contribs = data.get("fusion_result", {}).get(
            "pipeline_contributions", {})
        row = [contribs.get(k, {}).get("probability", 0.5)
               for k in AUTO_KEYS]
        rows.append(row)
        ys.append(int(label))
        vids.append(vid)
    if len(ys) < 4 or len(set(ys)) < 2:
        return None
    return {"x": np.asarray(rows, float), "y": np.asarray(ys, int),
            "video_ids": vids}


def train_stacking_model(dirs, models_dir: Optional[Path] = None
                         ) -> Dict[str, Any]:
    """Fit the logistic meta-model and pickle it where fusion loads it."""
    data = collect_stacking_dataset(dirs)
    if data is None:
        return {"status": "failed",
                "error": "need >=4 labeled videos of both classes with "
                         "fusion results"}
    model = LogisticRegression(max_iter=1000)
    model.fit(data["x"], data["y"])
    acc = float(model.score(data["x"], data["y"]))
    out_dir = (Path(models_dir) if models_dir else dirs.models) / "fusion"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "stacking_model.pkl", "wb") as f:
        pickle.dump(model, f)
    return {"status": "completed", "num_samples": int(len(data["y"])),
            "train_accuracy": acc,
            "feature_order": list(AUTO_KEYS),
            "coefficients": model.coef_[0].tolist()}
