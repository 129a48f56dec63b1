"""Pure-numpy readers for the reference's GBDT model files (port of
``lameness_tpu/ml/gbdt_io.py``, copied line for line).

``xgboost_latest.json`` and ``lightgbm_latest.txt`` (the reference
ml-pipeline's files, ``services/ml-pipeline/app/main.py:72-114``) are
documented tree dumps: these readers parse them and evaluate the trees
exactly, with no boosting library.  CatBoost's binary ``.cbm`` needs the
catboost library (imported only when such a file exists); its JSON export
``catboost_latest.json`` is read here.  Each reader has the
``predict_proba`` / ``predict_margin`` surface ``ensemble.GBDTEnsemble``
calls.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


# ---------------------------------------------------------------------------
# XGBoost JSON
# ---------------------------------------------------------------------------
class _XgbTree:
    __slots__ = ("left", "right", "feat", "cond", "default_left")

    def __init__(self, t: Dict[str, Any]):
        self.left = np.asarray(t["left_children"], np.int64)
        self.right = np.asarray(t["right_children"], np.int64)
        self.feat = np.asarray(t["split_indices"], np.int64)
        # split_conditions holds the threshold for internal nodes and the
        # LEAF VALUE for leaves (xgboost JSON schema)
        self.cond = np.asarray(t["split_conditions"], np.float64)
        self.default_left = np.asarray(t["default_left"], bool)

    def eval(self, x: np.ndarray) -> np.ndarray:
        """x (n, f) float -> leaf values (n,).  Rule: x[feat] < cond goes
        left; NaN goes to the default child."""
        node = np.zeros(x.shape[0], np.int64)
        active = self.left[node] != -1
        while active.any():
            n = node[active]
            xv = x[active, self.feat[n]]
            go_left = np.where(np.isnan(xv), self.default_left[n],
                               xv < self.cond[n])
            node[active] = np.where(go_left, self.left[n], self.right[n])
            active = self.left[node] != -1
        return self.cond[node]


class XgbJsonModel:
    """``xgboost_latest.json`` (``Booster.save_model``) evaluator.

    Exact for tree boosters: per-tree traversal reproduces xgboost's
    ``x < threshold`` / default-direction rules and leaf sums; the
    logistic link applies ``sigmoid(margin + logit(base_score))``
    (identity at the default ``base_score=0.5``).
    """

    def __init__(self, path: Path):
        doc = json.loads(Path(path).read_text())
        learner = doc["learner"]
        model = learner["gradient_booster"]["model"]
        self.trees: List[_XgbTree] = [_XgbTree(t) for t in model["trees"]]
        self.tree_info = np.asarray(model.get("tree_info",
                                              [0] * len(self.trees)),
                                    np.int64)
        lmp = learner.get("learner_model_param", {})
        self.base_score = float(lmp.get("base_score", 0.5))
        self.num_class = int(lmp.get("num_class", 0) or 0)
        self.objective = learner.get("objective", {}).get("name",
                                                          "binary:logistic")
        self.n_features = int(lmp.get("num_feature", 0) or 0)

    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        """(n, f) -> raw margins: (n,) binary/regression, (n, C) multiclass
        (before the base-score offset)."""
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[None]
        n_class = max(1, self.num_class)
        out = np.zeros((x.shape[0], n_class))
        for tree, cls in zip(self.trees, self.tree_info):
            out[:, cls] += tree.eval(x)
        return out[:, 0] if n_class == 1 else out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        m = self.predict_margin(x)
        if self.num_class > 1:                       # multi:softprob
            m = m + self._base_margin()
            e = np.exp(m - m.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        p = _sigmoid(m + self._base_margin())
        return np.stack([1.0 - p, p], axis=1)

    def _base_margin(self) -> float:
        if self.objective.startswith(("binary:", "reg:logistic",
                                      "multi:")):
            b = min(max(self.base_score, 1e-15), 1 - 1e-15)
            return float(np.log(b / (1.0 - b)))
        return self.base_score

    def predict(self, x: np.ndarray) -> np.ndarray:
        p = self.predict_proba(x)
        return np.argmax(p, axis=1)


# ---------------------------------------------------------------------------
# LightGBM text
# ---------------------------------------------------------------------------
class _LgbTree:
    __slots__ = ("feat", "thr", "left", "right", "dtype", "leaf_value")

    def __init__(self, fields: Dict[str, str]):
        self.leaf_value = np.asarray(
            [float(v) for v in fields["leaf_value"].split()], np.float64)
        if int(fields.get("num_leaves", "1")) <= 1:
            self.feat = np.zeros(0, np.int64)
            self.thr = np.zeros(0)
            self.left = np.zeros(0, np.int64)
            self.right = np.zeros(0, np.int64)
            self.dtype = np.zeros(0, np.int64)
            return
        self.feat = np.asarray(fields["split_feature"].split(), np.int64)
        self.thr = np.asarray(fields["threshold"].split(), np.float64)
        self.left = np.asarray(fields["left_child"].split(), np.int64)
        self.right = np.asarray(fields["right_child"].split(), np.int64)
        self.dtype = np.asarray(fields.get(
            "decision_type", " ".join("2" * len(self.feat))).split(),
            np.int64)

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Numerical splits: x <= threshold goes left; child < 0 means
        leaf ``-(child) - 1``.  Missing handling follows decision_type:
        bit1 = default-left, missing_type (bits 2-3) NaN/Zero."""
        if len(self.feat) == 0:                      # constant tree
            return np.full(x.shape[0], self.leaf_value[0])
        node = np.zeros(x.shape[0], np.int64)        # internal node index
        out = np.zeros(x.shape[0])
        live = np.ones(x.shape[0], bool)
        while live.any():
            n = node[live]
            xv = x[live, self.feat[n]]
            dt = self.dtype[n]
            default_left = (dt & 2) != 0
            missing_type = (dt >> 2) & 3
            # LightGBM's NumericalDecision: NaN is converted to 0.0
            # unless missing_type is NaN; THEN zero/NaN missing routing
            # applies; remaining values compare x <= threshold.
            xv = np.where(np.isnan(xv) & (missing_type != 2), 0.0, xv)
            is_missing = np.where(
                missing_type == 2, np.isnan(xv),
                np.where(missing_type == 1, np.abs(xv) <= 1e-35, False))
            go_left = np.where(is_missing, default_left, xv <= self.thr[n])
            child = np.where(go_left, self.left[n], self.right[n])
            leaf = child < 0
            idx = np.flatnonzero(live)
            out[idx[leaf]] = self.leaf_value[-child[leaf] - 1]
            node[idx[~leaf]] = child[~leaf]
            new_live = np.zeros_like(live)
            new_live[idx[~leaf]] = True
            live = new_live
        return out


class LgbTextModel:
    """``lightgbm_latest.txt`` (``Booster.save_model``) evaluator.

    Parses the section-per-tree text dump and evaluates numerical
    splits exactly (categorical splits — ``num_cat > 0`` — are not used
    by the reference's tabular features and raise).
    """

    def __init__(self, path: Path):
        text = Path(path).read_text()
        self.num_class = 1
        self.sigmoid = 1.0
        self.objective = "binary"
        self.trees: List[_LgbTree] = []
        for line in text.splitlines():
            if line.startswith("num_class="):
                self.num_class = int(line.split("=", 1)[1])
            elif line.startswith("objective="):
                parts = line.split("=", 1)[1].split()
                self.objective = parts[0]
                for p in parts[1:]:
                    if p.startswith("sigmoid:"):
                        self.sigmoid = float(p.split(":")[1])
        for section in text.split("\nTree=")[1:]:
            fields: Dict[str, str] = {}
            for line in section.splitlines()[1:]:
                if not line.strip() or line.startswith("end of trees"):
                    break
                if "=" in line:
                    k, v = line.split("=", 1)
                    fields[k] = v
            if int(fields.get("num_cat", "0")) > 0:
                raise ValueError("categorical splits not supported")
            self.trees.append(_LgbTree(fields))

    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[None]
        out = np.zeros((x.shape[0], max(1, self.num_class)))
        for i, tree in enumerate(self.trees):
            out[:, i % max(1, self.num_class)] += tree.eval(x)
        return out[:, 0] if self.num_class <= 1 else out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        m = self.predict_margin(x)
        if self.num_class > 1:                       # multiclass softmax
            e = np.exp(m - m.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if self.objective == "binary":
            p = _sigmoid(self.sigmoid * m)
        else:                                        # regression-ish: clip
            p = np.clip(m, 0.0, 1.0)
        return np.stack([1.0 - p, p], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=1)


# ---------------------------------------------------------------------------
# CatBoost JSON export
# ---------------------------------------------------------------------------
class CatboostJsonModel:
    """CatBoost's documented JSON export format (``save_model(...,
    format="json")``): oblivious trees where every tree level applies one
    shared (feature, border) condition, a leaf index built bitwise from
    the per-level ``x > border`` outcomes, and ``scale_and_bias`` applied
    to the summed leaf values before the sigmoid.

    The reference loads the binary ``.cbm`` (ml-pipeline:74-79), which
    stays catboost-lib-gated; this reader covers the library's portable
    JSON export so a converted model file drops in without the C++ lib.
    Bit-order convention: ``splits[d]`` is tree level ``d`` from the
    root and sets bit ``d`` of the leaf index — the same convention
    ``gbdt_train.save_catboost_json`` writes, so round trips are exact.
    """

    def __init__(self, path: Path):
        doc = json.loads(Path(path).read_text())
        self.trees = []
        for t in doc["oblivious_trees"]:
            splits = [(int(s["float_feature_index"]), float(s["border"]))
                      for s in t["splits"]]
            self.trees.append((splits,
                               np.asarray(t["leaf_values"], np.float64)))
        sb = doc.get("scale_and_bias", [1.0, [0.0]])
        self.scale = float(sb[0])
        bias = sb[1]
        self.bias = float(bias[0] if isinstance(bias, (list, tuple))
                          else bias)

    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[None]
        out = np.zeros(x.shape[0])
        for splits, leaves in self.trees:
            idx = np.zeros(x.shape[0], np.int64)
            for d, (feat, border) in enumerate(splits):
                idx |= (x[:, feat] > border).astype(np.int64) << d
            out += leaves[idx]
        return self.scale * out + self.bias

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p = _sigmoid(self.predict_margin(x))
        return np.stack([1.0 - p, p], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=1)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------
REFERENCE_FILES = {"xgboost": "xgboost_latest.json",
                   "lightgbm": "lightgbm_latest.txt",
                   "catboost": "catboost_latest.cbm"}
CATBOOST_JSON = "catboost_latest.json"


def load_reference_model(models_dir: Path, slot: str) -> Optional[Any]:
    """Load the reference-format model file for a slot, if present.

    xgboost/lightgbm use the numpy readers above; catboost prefers the
    binary ``.cbm`` when the catboost library is installed and falls
    back to the JSON export format (``catboost_latest.json``,
    CatboostJsonModel) which needs no library.
    """
    path = Path(models_dir) / REFERENCE_FILES[slot]
    if slot == "xgboost":
        return XgbJsonModel(path) if path.exists() else None
    if slot == "lightgbm":
        return LgbTextModel(path) if path.exists() else None
    if path.exists():
        try:
            from catboost import CatBoostClassifier  # type: ignore
            m = CatBoostClassifier()
            m.load_model(str(path))
            return m
        except ImportError:
            import logging
            logging.getLogger(__name__).warning(
                "%s present but the catboost library is not installed; "
                "its flatbuffers payload cannot be parsed lib-free (see "
                "docs/adr/ADR-001-cbm.md). Convert it once on a "
                "catboost-equipped host with scripts/convert_cbm.py to "
                "produce %s, which loads here without the library.",
                path.name, CATBOOST_JSON)
    jpath = Path(models_dir) / CATBOOST_JSON
    return CatboostJsonModel(jpath) if jpath.exists() else None
