"""Gradient-boosted tree training in each reference library's style (port of
``lameness_tpu/ml/gbdt_train.py``, copied line for line but for the
estimator base: the card's machine has no scikit-learn).

The reference trains CatBoost / XGBoost / LightGBM classifiers
(``services/training-service/app/main.py:193-293``).  This module
implements each library's training algorithm in numpy:

* ``growth="depthwise"`` — XGBoost: exact-greedy, second-order
  (grad/hess) splits, depth-limited level growth, ``reg_lambda`` /
  ``min_child_weight`` / ``gamma`` regularization, leaf weight
  ``-G/(H+lambda)``.
* ``growth="leafwise"``  — LightGBM: the same second-order gain, but
  best-first leaf growth bounded by ``num_leaves`` (and optionally
  ``max_depth``).
* ``growth="oblivious"`` — CatBoost: symmetric (oblivious) trees — one
  shared (feature, threshold) condition per level picked to maximize
  the summed gain across all leaves of that level.

All three share the binary-logistic boosting loop (margin starts at
``logit(base_score)``; per round ``g = p - y``, ``h = p(1-p)``).

Trained models serialize to the reference's model-file formats: the
XGBoost JSON schema (``xgboost_latest.json``), the LightGBM text dump
(``lightgbm_latest.txt``) and CatBoost's JSON export
(``catboost_latest.json``), which the readers in :mod:`.gbdt_io` load.

Thresholds are midpoints between adjacent distinct training values, so
XGBoost's ``x < thr`` and LightGBM's ``x <= thr`` route identically for
any value the training data contained.  Training requires finite
features; saved files route NaN queries to the left child.
"""
from __future__ import annotations

import heapq
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_EPS_GAIN = 1e-12


# ---------------------------------------------------------------------------
# split search (shared second-order exact-greedy gain)
# ---------------------------------------------------------------------------
def _best_split(x: np.ndarray, g: np.ndarray, h: np.ndarray, idx: np.ndarray,
                reg_lambda: float, min_child_weight: float, gamma: float,
                feats: Optional[np.ndarray] = None,
                min_data_in_leaf: int = 1
                ) -> Optional[Tuple[float, int, float]]:
    """Best (gain, feature, threshold) over ``feats`` (default: all
    features) for the samples in ``idx``, or None when no split clears
    ``gamma``.  Exact enumeration of every between-distinct-values
    position (XGBoost ``tree_method=exact``).  ``min_data_in_leaf``
    (LightGBM's count-based leaf constraint, library default 20, ours 1
    — docs/TRAINING.md deviations) forbids splits leaving fewer samples
    on either side."""
    gs, hs = g[idx], h[idx]
    gt, ht = gs.sum(), hs.sum()
    parent = gt * gt / (ht + reg_lambda)
    best: Optional[Tuple[float, int, float]] = None
    for j in (range(x.shape[1]) if feats is None else feats):
        xv = x[idx, j]
        order = np.argsort(xv, kind="stable")
        xo = xv[order]
        gl = np.cumsum(gs[order])[:-1]
        hl = np.cumsum(hs[order])[:-1]
        valid = xo[1:] != xo[:-1]
        if min_child_weight > 0:
            valid &= (hl >= min_child_weight) & \
                (ht - hl >= min_child_weight)
        if min_data_in_leaf > 1:
            cnt = np.arange(1, xo.size)
            valid &= (cnt >= min_data_in_leaf) & \
                (xo.size - cnt >= min_data_in_leaf)
        if not valid.any():
            continue
        gr, hr = gt - gl, ht - hl
        gains = 0.5 * (gl * gl / (hl + reg_lambda)
                       + gr * gr / (hr + reg_lambda) - parent) - gamma
        gains = np.where(valid, gains, -np.inf)
        k = int(np.argmax(gains))
        if gains[k] > _EPS_GAIN and (best is None or gains[k] > best[0]):
            thr = float(xo[k]) + (float(xo[k + 1]) - float(xo[k])) / 2.0
            best = (float(gains[k]), int(j), thr)
    return best


def _leaf_weight(g: np.ndarray, h: np.ndarray, idx: np.ndarray,
                 reg_lambda: float) -> float:
    return float(-g[idx].sum() / (h[idx].sum() + reg_lambda))


# ---------------------------------------------------------------------------
# tree node (shared by all growth modes; array export reads these)
# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("feat", "thr", "left", "right", "value", "gain",
                 "sum_hess", "count")

    def __init__(self):
        self.feat = -1
        self.thr = 0.0
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None
        self.value = 0.0            # leaf output (already lr-scaled)
        self.gain = 0.0
        self.sum_hess = 0.0
        self.count = 0

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Vectorized traversal, XGBoost routing: ``x < thr`` (and NaN)
        goes left."""
        out = np.empty(x.shape[0])
        stack = [(self, np.arange(x.shape[0]))]
        while stack:
            node, idx = stack.pop()
            if idx.size == 0:
                continue
            if node.is_leaf:
                out[idx] = node.value
                continue
            xv = x[idx, node.feat]
            go_left = ~(xv >= node.thr)          # NaN -> left
            stack.append((node.left, idx[go_left]))
            stack.append((node.right, idx[~go_left]))
        return out


def _grow_depthwise(x, g, h, idx, depth_left, lr, reg_lambda,
                    min_child_weight, gamma, feats=None) -> _Node:
    node = _Node()
    node.sum_hess = float(h[idx].sum())
    node.count = int(idx.size)
    split = None
    if depth_left > 0 and idx.size >= 2:
        split = _best_split(x, g, h, idx, reg_lambda, min_child_weight,
                            gamma, feats)
    if split is None:
        node.value = _leaf_weight(g, h, idx, reg_lambda) * lr
        return node
    node.gain, node.feat, node.thr = split
    mask = x[idx, node.feat] < node.thr
    node.left = _grow_depthwise(x, g, h, idx[mask], depth_left - 1, lr,
                                reg_lambda, min_child_weight, gamma, feats)
    node.right = _grow_depthwise(x, g, h, idx[~mask], depth_left - 1, lr,
                                 reg_lambda, min_child_weight, gamma, feats)
    return node


def _grow_leafwise(x, g, h, idx, num_leaves, max_depth, lr, reg_lambda,
                   min_child_weight, gamma, feats=None,
                   min_data_in_leaf: int = 1) -> _Node:
    """LightGBM-style best-first growth: always expand the current leaf
    with the highest split gain until ``num_leaves`` is reached."""
    root = _Node()
    root.sum_hess = float(h[idx].sum())
    root.count = int(idx.size)
    root.value = _leaf_weight(g, h, idx, reg_lambda) * lr
    # heap of (-gain, tiebreak, node, idx, depth, split)
    heap: List[Tuple[float, int, _Node, np.ndarray, int,
                     Tuple[float, int, float]]] = []
    serial = 0

    def push(node: _Node, node_idx: np.ndarray, depth: int) -> None:
        nonlocal serial
        if node_idx.size < 2 or (max_depth > 0 and depth >= max_depth):
            return
        split = _best_split(x, g, h, node_idx, reg_lambda,
                            min_child_weight, gamma, feats,
                            min_data_in_leaf)
        if split is not None:
            heapq.heappush(heap, (-split[0], serial, node, node_idx,
                                  depth, split))
            serial += 1

    push(root, idx, 0)
    leaves = 1
    while heap and leaves < num_leaves:
        _, _, node, node_idx, depth, split = heapq.heappop(heap)
        node.gain, node.feat, node.thr = split
        mask = x[node_idx, node.feat] < node.thr
        for child_idx in (node_idx[mask], node_idx[~mask]):
            child = _Node()
            child.sum_hess = float(h[child_idx].sum())
            child.count = int(child_idx.size)
            child.value = _leaf_weight(g, h, child_idx, reg_lambda) * lr
            if node.left is None:
                node.left = child
            else:
                node.right = child
            push(child, child_idx, depth + 1)
        node.value = 0.0
        leaves += 1
    return root


def _grow_oblivious(x, g, h, idx, depth, lr, reg_lambda,
                    min_child_weight, gamma, max_borders: int = 254,
                    feats=None) -> _Node:
    """CatBoost-style symmetric tree: each level applies ONE shared
    (feature, threshold) condition to every node, chosen to maximize the
    summed split gain across the level's leaves.  Candidate thresholds are
    per-feature borders (midpoints, quantile-capped at ``max_borders`` —
    CatBoost's ``border_count``); the per-level search is one vectorized
    (leaf, border) histogram pass per feature."""
    xs, gs, hs = x[idx], g[idx], h[idx]
    feat_list = list(range(x.shape[1])) if feats is None else list(feats)
    borders: Dict[int, np.ndarray] = {}
    for j in feat_list:
        vals = np.unique(xs[:, j])
        mids = vals[:-1] + np.diff(vals) / 2.0
        if mids.size > max_borders:
            mids = mids[np.unique(np.linspace(
                0, mids.size - 1, max_borders).astype(np.int64))]
        borders[j] = mids

    leaf = np.zeros(idx.size, np.int64)      # leaf index per sample
    n_leaves = 1
    conditions: List[Tuple[int, float]] = []
    for _ in range(depth):
        best_total = _EPS_GAIN
        best_cond: Optional[Tuple[int, float]] = None
        for j in feat_list:
            bj = borders[j]
            if bj.size == 0:
                continue
            # bin = count of borders < x (midpoints never equal data
            # values), so "x < border_k" == "bin <= k": the cumulative
            # histogram over bins 0..k is the left side of split k
            bins = np.searchsorted(bj, xs[:, j], side="left")
            gh = np.zeros((n_leaves, bj.size + 1))
            hh = np.zeros((n_leaves, bj.size + 1))
            np.add.at(gh, (leaf, bins), gs)
            np.add.at(hh, (leaf, bins), hs)
            gl = np.cumsum(gh, axis=1)[:, :-1]
            hl = np.cumsum(hh, axis=1)[:, :-1]
            gt = gh.sum(axis=1, keepdims=True)
            ht = hh.sum(axis=1, keepdims=True)
            gr, hr = gt - gl, ht - hl
            gains = 0.5 * (gl * gl / (hl + reg_lambda)
                           + gr * gr / (hr + reg_lambda)
                           - gt * gt / (ht + reg_lambda)) - gamma
            if min_child_weight > 0:
                gains = np.where((hl >= min_child_weight)
                                 & (hr >= min_child_weight), gains, 0.0)
            totals = np.where(gains > _EPS_GAIN, gains, 0.0).sum(axis=0)
            k = int(np.argmax(totals))
            if totals[k] > best_total:
                best_total = float(totals[k])
                best_cond = (int(j), float(bj[k]))
        if best_cond is None:
            break
        conditions.append(best_cond)
        j, thr = best_cond
        leaf = leaf * 2 + (xs[:, j] >= thr)
        n_leaves *= 2

    def build(level: int, node_idx: np.ndarray) -> _Node:
        node = _Node()
        node.sum_hess = float(h[node_idx].sum())
        node.count = int(node_idx.size)
        if level == len(conditions):
            node.value = (_leaf_weight(g, h, node_idx, reg_lambda) * lr
                          if node_idx.size else 0.0)
            return node
        node.feat, node.thr = conditions[level]
        mask = x[node_idx, node.feat] < node.thr
        node.left = build(level + 1, node_idx[mask])
        node.right = build(level + 1, node_idx[~mask])
        return node

    return build(0, idx)


# ---------------------------------------------------------------------------
# the boosted model
# ---------------------------------------------------------------------------
class BoostedTreesClassifier:
    """Binary gradient-boosted trees with selectable growth style.

    Picklable; ``score`` is the accuracy, as scikit-learn's classifiers
    give it; ``save_xgboost_json`` / ``save_lightgbm_txt`` /
    ``save_catboost_json`` export the reference model-file formats.
    """

    def __init__(self, n_estimators: int = 100, learning_rate: float = 0.1,
                 max_depth: int = 6, growth: str = "depthwise",
                 num_leaves: int = 31, reg_lambda: float = 1.0,
                 min_child_weight: float = 1.0, gamma: float = 0.0,
                 base_score: float = 0.5, subsample: float = 1.0,
                 colsample_bytree: float = 1.0, random_state: int = 42,
                 min_data_in_leaf: int = 1):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.growth = growth
        self.num_leaves = num_leaves
        self.min_data_in_leaf = min_data_in_leaf
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.gamma = gamma
        self.base_score = base_score
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.random_state = random_state

    # -- training -------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "BoostedTreesClassifier":
        x = np.asarray(x, np.float64)
        y = np.asarray(y)
        if x.ndim != 2:
            raise ValueError("x must be (n, features)")
        if not np.isfinite(x).all():
            raise ValueError("training features must be finite")
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError("binary classification only "
                             f"(got classes {self.classes_})")
        self.feature_range_ = np.stack([x.min(axis=0), x.max(axis=0)],
                                       axis=1)
        yb = (y == self.classes_[1]).astype(np.float64)
        n = x.shape[0]
        self.n_features_in_ = x.shape[1]
        base = min(max(float(self.base_score), 1e-15), 1 - 1e-15)
        self._base_margin = float(np.log(base / (1.0 - base)))
        margin = np.full(n, self._base_margin)
        all_idx = np.arange(n)
        d = x.shape[1]
        rng = np.random.default_rng(int(self.random_state))
        self.trees_: List[_Node] = []
        for _ in range(int(self.n_estimators)):
            p = 1.0 / (1.0 + np.exp(-margin))
            g = p - yb
            h = np.maximum(p * (1.0 - p), 1e-16)
            # per-round row/feature sampling (xgb subsample /
            # colsample_bytree; lgbm bagging_fraction / feature_fraction)
            idx = all_idx
            if self.subsample < 1.0:
                k = max(2, int(round(n * self.subsample)))
                idx = np.sort(rng.choice(n, size=k, replace=False))
            feats = None
            if self.colsample_bytree < 1.0:
                kf = max(1, int(round(d * self.colsample_bytree)))
                feats = np.sort(rng.choice(d, size=kf, replace=False))
            if self.growth == "leafwise":
                tree = _grow_leafwise(x, g, h, idx, int(self.num_leaves),
                                      int(self.max_depth),
                                      self.learning_rate, self.reg_lambda,
                                      self.min_child_weight, self.gamma,
                                      feats,
                                      int(self.min_data_in_leaf))
            elif self.growth == "oblivious":
                tree = _grow_oblivious(x, g, h, idx, int(self.max_depth),
                                       self.learning_rate, self.reg_lambda,
                                       self.min_child_weight, self.gamma,
                                       feats=feats)
            elif self.growth == "depthwise":
                tree = _grow_depthwise(x, g, h, idx, int(self.max_depth),
                                       self.learning_rate, self.reg_lambda,
                                       self.min_child_weight, self.gamma,
                                       feats)
            else:
                raise ValueError(f"unknown growth {self.growth!r}")
            self.trees_.append(tree)
            margin = margin + tree.eval(x)
            # no split found WITHOUT sampling: the feature geometry won't
            # change and the hessians only shrink (min_child_weight gets
            # harder) — later rounds can only repeat this constant; stop.
            # Under row/feature sampling a later draw may still split.
            if tree.is_leaf and self.subsample >= 1.0 \
                    and self.colsample_bytree >= 1.0:
                break
        return self

    # -- inference ------------------------------------------------------------
    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[None]
        out = np.full(x.shape[0], self._base_margin)
        for tree in self.trees_:
            out += tree.eval(x)
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-self.predict_margin(x)))
        return np.stack([1.0 - p, p], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.classes_[
            (self.predict_proba(x)[:, 1] > 0.5).astype(np.int64)]

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        """Mean accuracy on (x, y)."""
        return float(np.average(self.predict(x) == np.asarray(y)))

    # -- array linearization (shared by both exporters) ------------------------
    @staticmethod
    def _linearize(tree: _Node) -> Dict[str, List[Any]]:
        """BFS arrays in XGBoost layout: children indices, -1 for leaves."""
        nodes: List[_Node] = []
        parents: List[int] = []
        queue: List[Tuple[_Node, int]] = [(tree, 2147483647)]
        while queue:
            node, parent = queue.pop(0)
            nid = len(nodes)
            nodes.append(node)
            parents.append(parent)
            if not node.is_leaf:
                queue.append((node.left, nid))
                queue.append((node.right, nid))
        left = np.full(len(nodes), -1, np.int64)
        right = np.full(len(nodes), -1, np.int64)
        child_ptr = 1
        for i, node in enumerate(nodes):
            if not node.is_leaf:
                left[i] = child_ptr
                right[i] = child_ptr + 1
                child_ptr += 2
        return {"nodes": nodes, "parents": parents,
                "left": left.tolist(), "right": right.tolist()}

    # -- XGBoost JSON export ----------------------------------------------------
    def save_xgboost_json(self, path: Path,
                          feature_names: Optional[List[str]] = None) -> None:
        """Write the XGBoost ``Booster.save_model`` JSON schema
        (loadable by ``xgb.Booster().load_model`` — the reference's
        ml-pipeline loader — and by gbdt_io.XgbJsonModel)."""
        trees_json = []
        for tid, tree in enumerate(self.trees_):
            lin = self._linearize(tree)
            nodes: List[_Node] = lin["nodes"]
            n = len(nodes)
            trees_json.append({
                "base_weights": [
                    (nd.value / self.learning_rate if nd.is_leaf and
                     self.learning_rate else nd.value) for nd in nodes],
                "categories": [], "categories_nodes": [],
                "categories_segments": [], "categories_sizes": [],
                "default_left": [1 if not nd.is_leaf else 0
                                 for nd in nodes],
                "id": tid,
                "left_children": lin["left"],
                "loss_changes": [nd.gain for nd in nodes],
                "parents": lin["parents"],
                "right_children": lin["right"],
                "split_conditions": [
                    nd.value if nd.is_leaf else nd.thr for nd in nodes],
                "split_indices": [max(nd.feat, 0) for nd in nodes],
                "split_type": [0] * n,
                "sum_hessian": [nd.sum_hess for nd in nodes],
                "tree_param": {
                    "num_deleted": "0",
                    "num_feature": str(self.n_features_in_),
                    "num_nodes": str(n),
                    "size_leaf_vector": "1",
                },
            })
        names = feature_names or [f"f{i}"
                                  for i in range(self.n_features_in_)]
        doc = {
            "learner": {
                "attributes": {},
                "feature_names": names,
                "feature_types": ["float"] * self.n_features_in_,
                "gradient_booster": {
                    "model": {
                        "gbtree_model_param": {
                            "num_parallel_tree": "1",
                            "num_trees": str(len(self.trees_)),
                        },
                        "iteration_indptr": list(
                            range(len(self.trees_) + 1)),
                        "tree_info": [0] * len(self.trees_),
                        "trees": trees_json,
                    },
                    "name": "gbtree",
                },
                "learner_model_param": {
                    "base_score": repr(float(self.base_score)),
                    "boost_from_average": "1",
                    "num_class": "0",
                    "num_feature": str(self.n_features_in_),
                    "num_target": "1",
                },
                "objective": {
                    "name": "binary:logistic",
                    "reg_loss_param": {"scale_pos_weight": "1"},
                },
            },
            "version": [2, 0, 0],
        }
        Path(path).write_text(json.dumps(doc))

    # -- LightGBM text export ----------------------------------------------------
    def save_lightgbm_txt(self, path: Path,
                          feature_names: Optional[List[str]] = None,
                          feature_infos: Optional[np.ndarray] = None
                          ) -> None:
        """Write the LightGBM ``Booster.save_model`` text dump (loadable by
        ``lgb.Booster(model_file=...)`` and gbdt_io.LgbTextModel).

        Leaf values carry the base margin folded into every tree's share
        (LightGBM has no separate base-score field): tree 0's leaves get
        ``value + base_margin``.  decision_type 2 = numerical,
        default-left, missing-type None.
        """
        names = feature_names or [f"Column_{i}"
                                  for i in range(self.n_features_in_)]
        blocks: List[str] = []
        for tid, tree in enumerate(self.trees_):
            lin = self._linearize(tree)
            nodes: List[_Node] = lin["nodes"]
            internal = [i for i, nd in enumerate(nodes) if not nd.is_leaf]
            leaf_ids = [i for i, nd in enumerate(nodes) if nd.is_leaf]
            to_int = {i: k for k, i in enumerate(internal)}
            to_leaf = {i: k for k, i in enumerate(leaf_ids)}

            def child(i: int) -> int:
                return -to_leaf[i] - 1 if nodes[i].is_leaf else to_int[i]

            offset = self._base_margin if tid == 0 else 0.0
            leaf_values = [nodes[i].value + offset for i in leaf_ids]
            fields = [f"Tree={tid}",
                      f"num_leaves={len(leaf_ids)}",
                      "num_cat=0"]
            if internal:
                fields += [
                    "split_feature=" + " ".join(
                        str(nodes[i].feat) for i in internal),
                    "split_gain=" + " ".join(
                        repr(nodes[i].gain) for i in internal),
                    "threshold=" + " ".join(
                        repr(nodes[i].thr) for i in internal),
                    "decision_type=" + " ".join("2" for _ in internal),
                    "left_child=" + " ".join(
                        str(child(lin["left"][i])) for i in internal),
                    "right_child=" + " ".join(
                        str(child(lin["right"][i])) for i in internal),
                ]
            fields += [
                "leaf_value=" + " ".join(repr(v) for v in leaf_values),
                "leaf_weight=" + " ".join(
                    repr(nodes[i].sum_hess) for i in leaf_ids),
                "leaf_count=" + " ".join(
                    str(nodes[i].count) for i in leaf_ids),
            ]
            if internal:
                fields += [
                    "internal_value=" + " ".join(
                        "0" for _ in internal),
                    "internal_weight=" + " ".join(
                        repr(nodes[i].sum_hess) for i in internal),
                    "internal_count=" + " ".join(
                        str(nodes[i].count) for i in internal),
                ]
            fields += ["is_linear=0", f"shrinkage={self.learning_rate}"]
            blocks.append("\n".join(fields) + "\n\n")
        if feature_infos is None:
            feature_infos = getattr(self, "feature_range_", None)
        if feature_infos is not None:
            infos = " ".join(
                f"[{lo!r}:{hi!r}]" for lo, hi in feature_infos)
        else:
            infos = " ".join("[-1e+308:1e+308]"
                             for _ in range(self.n_features_in_))
        header = "\n".join([
            "tree",
            "version=v3",
            "num_class=1",
            "num_tree_per_iteration=1",
            "label_index=0",
            f"max_feature_idx={self.n_features_in_ - 1}",
            "objective=binary sigmoid:1",
            "feature_names=" + " ".join(names),
            "feature_infos=" + infos,
            "tree_sizes=" + " ".join(
                str(len(b.encode())) for b in blocks),
        ]) + "\n\n"
        Path(path).write_text(
            header + "".join(blocks) + "end of trees\n\n"
            + "feature_importances:\n\n"
            + "parameters:\nend of parameters\n\n"
            + "pandas_categorical:null\n")


    # -- CatBoost JSON export ----------------------------------------------------
    def save_catboost_json(self, path: Path,
                           feature_names: Optional[List[str]] = None
                           ) -> None:
        """Write the CatBoost JSON export format (``save_model(...,
        format="json")``) for an oblivious-tree model: per tree the
        shared per-level (feature, border) splits and the 2^depth leaf
        values indexed bitwise by the ``x > border`` outcomes
        (bit d = level d from the root — gbdt_io.CatboostJsonModel's
        convention).  ``x > border`` vs our ``x < thr`` routing agree
        everywhere except exactly at a border, which midpoint thresholds
        make measure-zero.  The base margin rides in scale_and_bias."""
        if self.growth != "oblivious":
            raise ValueError("catboost JSON needs oblivious trees "
                             f"(growth={self.growth!r})")
        trees_json = []
        for tree in self.trees_:
            conds: List[Tuple[int, float]] = []
            node = tree
            while not node.is_leaf:
                conds.append((node.feat, node.thr))
                node = node.left
            leaves: List[float] = []
            weights: List[float] = []
            stack = [tree]
            while stack:
                nd = stack.pop()
                if nd.is_leaf:
                    leaves.append(nd.value)
                    weights.append(nd.sum_hess)
                else:
                    stack.extend([nd.right, nd.left])   # left pops first
            depth = len(conds)
            assert len(leaves) == 1 << depth
            vals = [0.0] * (1 << depth)
            wts = [0.0] * (1 << depth)
            for c in range(1 << depth):
                # catboost leaf index: bit d = right at level d; our DFS
                # order carries level 0 as the most-significant bit
                li = 0
                for d in range(depth):
                    if (c >> d) & 1:
                        li |= 1 << (depth - 1 - d)
                vals[c] = leaves[li]
                wts[c] = weights[li]
            trees_json.append({
                "splits": [{"float_feature_index": f,
                            "flat_feature_index": f, "border": t,
                            "split_index": i, "split_type": "FloatFeature"}
                           for i, (f, t) in enumerate(conds)],
                "leaf_values": vals,
                "leaf_weights": wts,
            })
        names = feature_names or [f"f{i}"
                                  for i in range(self.n_features_in_)]
        doc = {
            "features_info": {"float_features": [
                {"feature_index": i, "flat_feature_index": i,
                 "feature_id": names[i], "has_nans": False,
                 "nan_value_treatment": "AsIs"}
                for i in range(self.n_features_in_)]},
            "model_info": {"params": {
                "loss_function": {"type": "Logloss"}}},
            "oblivious_trees": trees_json,
            "scale_and_bias": [1.0, [self._base_margin]],
        }
        Path(path).write_text(json.dumps(doc))


def make_numpy_model(slot: str,
                     params: Optional[Dict[str, Any]] = None
                     ) -> BoostedTreesClassifier:
    """The numpy trainer configured in a slot's library style, mapping the
    ml-config hyperparameter names the reference uses
    (training-service:204-224).  Regularization defaults follow each
    library's own: XGBoost min_child_weight=1 / lambda=1, LightGBM
    min_child_weight=1e-3 / lambda=0, CatBoost l2_leaf_reg=3 (no hessian
    minimum).  LightGBM's min_data_in_leaf=20 default is deliberately NOT
    replicated — it forbids learning at this system's early-stage label
    counts; the knob remains settable via ml-config."""
    params = params or {}

    def common(lam_default: float, mcw_default: float) -> Dict[str, Any]:
        return dict(
            n_estimators=int(params.get("n_estimators",
                                        params.get("iterations", 100))),
            learning_rate=float(params.get("learning_rate", 0.1)),
            max_depth=int(params.get("max_depth", params.get("depth", 6))),
            reg_lambda=float(params.get("reg_lambda",
                                        params.get("l2_leaf_reg",
                                                   lam_default))),
            min_child_weight=float(params.get("min_child_weight",
                                              mcw_default)),
            gamma=float(params.get("gamma",
                                   params.get("min_split_gain", 0.0))),
            subsample=float(params.get("subsample",
                                       params.get("bagging_fraction", 1.0))),
            colsample_bytree=float(params.get(
                "colsample_bytree", params.get("feature_fraction", 1.0))),
            random_state=int(params.get("random_state",
                                        params.get("random_seed", 42))),
        )

    if slot == "xgboost":
        return BoostedTreesClassifier(growth="depthwise", **common(1.0, 1.0))
    if slot == "lightgbm":
        return BoostedTreesClassifier(
            growth="leafwise",
            num_leaves=int(params.get("num_leaves", 31)),
            # library default is 20; ours is 1 (docs/TRAINING.md
            # deviations) — settable via /api/ml-config/lightgbm
            # (min_child_samples is LightGBM's sklearn-facing alias)
            min_data_in_leaf=int(params.get(
                "min_data_in_leaf", params.get("min_child_samples", 1))),
            **common(0.0, 1e-3))
    if slot == "catboost":
        return BoostedTreesClassifier(growth="oblivious", **common(3.0, 0.0))
    raise ValueError(slot)
