"""The port's tabular training (``lameness_tpu_torch/ml/{gbdt_train,ensemble,
training}.py``, ``fuse/stacking.py``) against the JAX package and
scikit-learn on the CPU.

- ``BoostedTreesClassifier`` in each slot's style: predictions equal to
  JAX's bit for bit, and the three reference files byte for byte.
- ``stratified_kfold``: the folds of scikit-learn's
  ``StratifiedKFold(shuffle=True, random_state=42)`` over a range of sizes,
  class ratios and label values, equal.
- ``TrainingService.run_training``: the report equal to JAX's, the
  reference files and weights byte for byte (and no joblib dump), the
  status file, the ``training.completed`` message, and the port's
  ``GBDTEnsemble`` predicting from the saved files as JAX's does.
- The stacking meta-model: probabilities within 1e-4 of scikit-learn's
  ``LogisticRegression(max_iter=1000)``; the helpers and the collected
  dataset equal to JAX's; the pickle loaded by the port's fusion service.
"""
import json

import numpy as np
import pytest
from sklearn.linear_model import LogisticRegression as SkLogistic
from sklearn.model_selection import StratifiedKFold

from lameness_tpu.fuse import stacking as jst
from lameness_tpu.io import schemas as jschemas
from lameness_tpu.ml import gbdt_train as jgt
from lameness_tpu.ml.training import TrainingService as JTrainingService
from lameness_tpu_torch.core.config import DataDirs
from lameness_tpu_torch.fuse import fusion as tfu
from lameness_tpu_torch.fuse import stacking as tst
from lameness_tpu_torch.io.bus import MessageBus
from lameness_tpu_torch.ml import gbdt_train as tgt
from lameness_tpu_torch.ml.ensemble import GBDTEnsemble, stratified_kfold
from lameness_tpu_torch.ml.gbdt_io import CATBOOST_JSON, REFERENCE_FILES
from lameness_tpu_torch.ml.training import TrainingService
from tests.test_stacking import _write_fusion_with_contribs

SLOT_FILES = {"xgboost": ("save_xgboost_json", REFERENCE_FILES["xgboost"]),
              "lightgbm": ("save_lightgbm_txt", REFERENCE_FILES["lightgbm"]),
              "catboost": ("save_catboost_json", CATBOOST_JSON)}


def _tabular(rng, n=60, d=6):
    x = rng.standard_normal((n, d))
    x[:, 2] = np.round(x[:, 2], 1)             # repeated values: ties
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.3 * rng.standard_normal(n)
         > 0.4).astype(np.int64)
    return x, y


@pytest.mark.parametrize("params", [{}, {"subsample": 0.7,
                                         "colsample_bytree": 0.6,
                                         "max_depth": 3}])
@pytest.mark.parametrize("slot", ["xgboost", "lightgbm", "catboost"])
def test_boosted_trees_bit_for_bit(tmp_path, slot, params):
    x, y = _tabular(np.random.default_rng(0))
    params = dict(params, n_estimators=25)
    want = jgt.make_numpy_model(slot, params).fit(x, y)
    got = tgt.make_numpy_model(slot, params).fit(x, y)
    q = np.random.default_rng(1).standard_normal((40, x.shape[1]))
    np.testing.assert_array_equal(got.predict_proba(q), want.predict_proba(q))
    np.testing.assert_array_equal(got.predict(q), want.predict(q))
    assert got.score(q, want.predict(q)) == 1.0
    method, name = SLOT_FILES[slot]
    names = [f"f{i}" for i in range(x.shape[1])]
    getattr(got, method)(tmp_path / ("port_" + name), feature_names=names)
    getattr(want, method)(tmp_path / ("jax_" + name), feature_names=names)
    assert (tmp_path / ("port_" + name)).read_bytes() == \
        (tmp_path / ("jax_" + name)).read_bytes()


@pytest.mark.parametrize("n,ratio,splits,labels", [
    (10, 0.5, 2, (0, 1)), (17, 0.3, 3, (0, 1)), (40, 0.1, 4, (1, 0)),
    (64, 0.5, 5, (0, 1)), (33, 0.7, 5, (2, 7)), (101, 0.25, 2, (5, 3))])
def test_stratified_folds_equal_sklearn(n, ratio, splits, labels):
    rng = np.random.default_rng(n)
    y = np.where(rng.uniform(0, 1, n) < ratio, labels[1], labels[0])
    y[:splits] = labels[0]
    y[-splits:] = labels[1]
    want = StratifiedKFold(splits, shuffle=True, random_state=42).split(
        np.zeros((n, 1)), y)
    got = list(stratified_kfold(y, splits))
    for (tr, te), (wtr, wte) in zip(got, want, strict=True):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


def _write_training_set(dirs, rng, n=12):
    """Labels and per-pipeline result files, with the signal in the yolo
    and tleap features; one labeled video without any result file."""
    for i in range(n):
        vid, lame = f"v{i:02d}", i % 2
        labels_dir = dirs.training / "labels"
        labels_dir.mkdir(parents=True, exist_ok=True)
        json.dump({"label": lame}, open(labels_dir / f"{vid}_label.json",
                                        "w"))
        jschemas.write_result(dirs.results_for("yolo") / f"{vid}_yolo.json", {
            "features": {"avg_confidence": 0.6 + 0.2 * lame
                         + 0.05 * rng.standard_normal(),
                         "num_detections": int(5 + i),
                         "avg_box_area": float(rng.uniform(50, 150))}})
        if i % 3:
            jschemas.write_result(
                dirs.results_for("tleap") / f"{vid}_tleap.json",
                {"locomotion_features": {
                    "stride_fl_mean": float(rng.uniform(0.4, 0.6)),
                    "stride_rr_std": float(rng.uniform(0, 0.2)),
                    "head_bob_score": 0.3 * lame + 0.05 * rng.random(),
                    "back_arch_score": float(rng.random()),
                    "front_leg_asymmetry": float(rng.random())}})
        if i % 4 == 0:
            jschemas.write_result(
                dirs.results_for("dinov3") / f"{vid}_dinov3.json",
                {"embedding": rng.standard_normal(8).tolist(),
                 "similar_cases": [{"score": float(rng.random())}]})
    json.dump({"label": 1}, open(dirs.training / "labels"
                                 / "ghost_label.json", "w"))


@pytest.mark.parametrize("cv_folds", [2, 5])
def test_run_training_matches_jax(tmp_data_root, tmp_path, cv_folds):
    dirs = tmp_data_root.dirs
    _write_training_set(dirs, np.random.default_rng(cv_folds))
    want = JTrainingService(dirs, models_dir=tmp_path / "jax").run_training(
        cv_folds=cv_folds)
    bus = MessageBus()
    port_dirs = DataDirs(root=dirs.root)
    svc = TrainingService(port_dirs, models_dir=tmp_path / "port", bus=bus)
    got = svc.run_training(cv_folds=cv_folds)
    assert got["status"] == want["status"] == "completed"
    assert got["report"] == want["report"]
    for key in ("num_labeled", "num_skipped_no_features", "skipped_videos",
                "feature_names"):
        assert got[key] == want[key], key
    assert svc.get_status()["report"] == want["report"]
    names = [REFERENCE_FILES["xgboost"], REFERENCE_FILES["lightgbm"],
             CATBOOST_JSON, "ensemble_weights.json"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert not list((tmp_path / "port").glob("*.joblib"))
    (message,) = bus.messages_on("training.completed")
    assert message == {"type": "ml", "num_samples": 12,
                       "report": want["report"]}
    # the saved files are what the port's ensemble serves
    ens = GBDTEnsemble(tmp_path / "port")
    assert set(ens.models) == {"catboost", "xgboost", "lightgbm"}
    x, _, _, _ = svc.get_labeled_data()
    for row in x:
        p = ens.predict(row)
        for slot in ("catboost", "xgboost", "lightgbm"):
            assert p[slot]["probability"] == pytest.approx(
                svc.ensemble.models[slot].predict_proba(row[None])[0, 1],
                rel=1e-12, abs=1e-12), slot


def test_run_training_refuses_one_class(tmp_data_root, tmp_path):
    dirs = DataDirs(root=tmp_data_root.dirs.root)
    svc = TrainingService(dirs, models_dir=tmp_path)
    svc.add_label("a", 1)
    jschemas.write_result(dirs.results_for("yolo") / "a_yolo.json",
                          {"features": {"avg_confidence": 0.9}})
    status = svc.run_training()
    assert status["status"] == "failed"
    assert svc.get_status()["status"] == "failed"


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_logistic_regression_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 80))
    x = rng.uniform(0, 1, (n, 5))
    y = (x[:, 1] + 0.3 * rng.standard_normal(n) > 0.5).astype(int)
    y[:2] = [0, 1]
    want = SkLogistic(max_iter=1000).fit(x, y)
    got = tst.LogisticRegression(max_iter=1000).fit(x, y)
    q = rng.uniform(0, 1, (30, 5))
    np.testing.assert_allclose(got.predict_proba(q), want.predict_proba(q),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.classes_, want.classes_)
    assert got.score(x, y) == want.score(x, y)


def test_voting_and_blending_match_jax():
    probs, w = [0.2, 0.9, 0.6], [1.0, 3.0, 0.5]
    assert tst.soft_voting(probs) == jst.soft_voting(probs)
    assert tst.soft_voting(probs, w) == jst.soft_voting(probs, w)
    for acc in ([0.9, 0.6, 0.55], [0.4, 0.5, 0.3]):
        assert tst.blending(probs, acc) == jst.blending(probs, acc)


def test_stacking_model_matches_sklearn_and_serves(tmp_data_root, tmp_path):
    dirs = tmp_data_root.dirs
    rng = np.random.default_rng(11)
    for i in range(14):
        label = i % 2
        probs = {"ml": float(rng.random()),
                 "tcn": 0.8 * label + 0.1 + 0.1 * float(rng.random()),
                 "transformer": float(rng.random()), "gnn": 0.5,
                 "graph_transformer": 0.5}
        _write_fusion_with_contribs(dirs, f"s{i}", probs, label, rng)
    port_dirs = DataDirs(root=dirs.root)
    got_ds = tst.collect_stacking_dataset(port_dirs)
    want_ds = jst.collect_stacking_dataset(dirs)
    np.testing.assert_array_equal(got_ds["x"], want_ds["x"])
    np.testing.assert_array_equal(got_ds["y"], want_ds["y"])
    assert got_ds["video_ids"] == want_ds["video_ids"]
    got = tst.train_stacking_model(port_dirs, tmp_path / "port")
    want = jst.train_stacking_model(dirs, tmp_path / "jax")
    assert set(got) == set(want)
    assert got["train_accuracy"] == want["train_accuracy"]
    assert got["feature_order"] == want["feature_order"]
    np.testing.assert_allclose(got["coefficients"], want["coefficients"],
                               atol=1e-4)
    # the fusion service loads the port's pickle where it looks for it
    port_dirs.models.mkdir(parents=True, exist_ok=True)
    tst.train_stacking_model(port_dirs)
    svc = tfu.FusionService(port_dirs)
    assert isinstance(svc.stacking_model, tst.LogisticRegression)
    sk = SkLogistic(max_iter=1000).fit(want_ds["x"], want_ds["y"])
    feats = [[0.3, 0.85, 0.4, 0.5, 0.5]]
    assert svc.stacking_model.predict_proba(feats)[0, 1] == pytest.approx(
        sk.predict_proba(feats)[0, 1], abs=1e-4)
    assert tst.train_stacking_model(DataDirs(root=str(tmp_path / "none")))[
        "status"] == "failed"
