"""Exact interventional Shapley values for the tabular ensemble (port of
``lameness_tpu/xai/shapley.py``, copied line for line: host numpy).

The reference's shap-service is a declared-but-stubbed capability
(``services/shap-service/app/main.py:35-47`` writes a placeholder JSON).
We implement the real thing (SURVEY.md §7 step 9): with ≤ 12 features the
exact Shapley value is computable — for every feature we average the
prediction difference over all 2^(d−1) coalitions with the correct
combinatorial weights, marginalising removed features over a background
set.  Exact, model-agnostic, deterministic; O(2^d · |background|) model
calls batched into one ``predict_proba``.

Also provides global importances (mean |phi| over a dataset) and the
what-if surface used by the SHAP router (routers/shap.py).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np


def exact_shapley(predict: Callable[[np.ndarray], np.ndarray],
                  x: np.ndarray, background: np.ndarray,
                  max_features_exact: int = 14) -> np.ndarray:
    """phi (d,) for a single instance x against a background matrix (N, d).

    ``predict`` maps (M, d) -> (M,) probabilities.  For d beyond
    ``max_features_exact`` a permutation-sampling estimate is used.
    """
    x = np.asarray(x, float).ravel()
    background = np.atleast_2d(np.asarray(background, float))
    d = x.shape[0]
    if d > max_features_exact:
        return _sampled_shapley(predict, x, background)

    n_bg = background.shape[0]
    # enumerate all subsets once; build the evaluation matrix in one batch
    subsets = []
    for r in range(d + 1):
        subsets.extend(itertools.combinations(range(d), r))
    masks = np.zeros((len(subsets), d), bool)
    for i, s in enumerate(subsets):
        masks[i, list(s)] = True
    # rows: for each subset S, background rows with x substituted on S
    eval_rows = np.repeat(background[None, :, :], len(subsets), axis=0)
    eval_rows[masks[:, None, :].repeat(n_bg, axis=1)] = \
        np.broadcast_to(x, (len(subsets), n_bg, d))[
            masks[:, None, :].repeat(n_bg, axis=1)]
    flat = eval_rows.reshape(-1, d)
    preds = np.asarray(predict(flat), float).reshape(len(subsets), n_bg)
    v = preds.mean(axis=1)                         # value of each coalition
    v_by_set = {s: v[i] for i, s in enumerate(subsets)}

    phi = np.zeros(d)
    fact = math.factorial
    for j in range(d):
        others = [k for k in range(d) if k != j]
        for r in range(d):
            w = fact(r) * fact(d - r - 1) / fact(d)
            for s in itertools.combinations(others, r):
                phi[j] += w * (v_by_set[tuple(sorted(s + (j,)))]
                               - v_by_set[s])
    return phi


def _sampled_shapley(predict, x, background, n_perm: int = 256,
                     seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = x.shape[0]
    n_bg = background.shape[0]
    phi = np.zeros(d)
    for _ in range(n_perm):
        perm = rng.permutation(d)
        z = background[rng.integers(n_bg)].copy()
        prev = float(predict(z[None])[0])
        for j in perm:
            z[j] = x[j]
            cur = float(predict(z[None])[0])
            phi[j] += cur - prev
            prev = cur
    return phi / n_perm


def shap_report(predict, x: np.ndarray, background: np.ndarray,
                feature_names: Sequence[str],
                video_id: str) -> Dict[str, Any]:
    """The per-video SHAP result JSON (replacing the reference's stub with
    real values; keeps a compatible envelope)."""
    phi = exact_shapley(predict, x, background)
    base = float(np.asarray(predict(background), float).mean())
    fx = float(np.asarray(predict(np.atleast_2d(x)), float)[0])
    order = np.argsort(-np.abs(phi))
    return {
        "video_id": video_id,
        "status": "computed",
        "method": "exact_interventional_shapley",
        "base_value": base,
        "prediction": fx,
        "shap_values": {feature_names[i]: float(phi[i])
                        for i in range(len(feature_names))},
        "top_features": [
            {"feature": feature_names[i], "shap_value": float(phi[i]),
             "feature_value": float(np.asarray(x).ravel()[i])}
            for i in order[:5]],
        "additivity_gap": float(fx - base - phi.sum()),
    }


def global_importance(predict, xs: np.ndarray, background: np.ndarray,
                      feature_names: Sequence[str],
                      max_rows: int = 50) -> Dict[str, float]:
    """Mean |phi| over a dataset (the 'global' SHAP surface)."""
    xs = np.atleast_2d(xs)[:max_rows]
    acc = np.zeros(xs.shape[1])
    for row in xs:
        acc += np.abs(exact_shapley(predict, row, background))
    acc /= len(xs)
    return {feature_names[i]: float(acc[i]) for i in range(len(acc))}


def what_if(predict, x: np.ndarray, feature_idx: int,
            values: Sequence[float]) -> List[Dict[str, float]]:
    """Prediction as one feature sweeps over `values` (what-if surface)."""
    x = np.asarray(x, float).ravel()
    rows = np.repeat(x[None], len(values), axis=0)
    rows[:, feature_idx] = values
    preds = np.asarray(predict(rows), float)
    return [{"value": float(v), "prediction": float(p)}
            for v, p in zip(values, preds)]
