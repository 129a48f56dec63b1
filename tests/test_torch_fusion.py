"""The port's tabular ensemble and fusion (``lameness_tpu_torch/ml``,
``fuse``) and the back half of ``process_video_file`` against the JAX
package on the CPU.

- The schema builders of the analysis files: equal.
- ``extract_features`` on every combination of present results: equal.
- ``GBDTEnsemble.predict`` on reference-format files written by the JAX
  package's ``GBDTEnsemble.fit``/``save``: probabilities within 1e-12;
  0.5 with no models; no ``joblib`` import without a ``.joblib`` file.
- ``severity_level``, ``apply_gating_rules`` and ``fuse_predictions`` on
  each decision mode, ``aggregate_cow_predictions`` on files with set
  mtimes, ``FusionService.process_video`` at a fixed timestamp: equal.
- The drivers' back half over the same result files of 3 cows x 3 videos:
  ``run_tracking`` -> graph heads (dropout 0, the JAX runner's weights) ->
  ``run_ml`` -> ``fusion.process_video``: every file equal, the graph
  heads' numbers within 1e-5.
"""
import itertools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from lameness_tpu.fuse import fusion as jfusion
from lameness_tpu.io import schemas as jschemas
from lameness_tpu.ml import ensemble as jens
from lameness_tpu.ml import features as jfeat
from lameness_tpu.track import reid as jreid
from lameness_tpu_torch.fuse import fusion as tfusion
from lameness_tpu_torch.io import schemas as tschemas
from lameness_tpu_torch.ml import ensemble as tens
from lameness_tpu_torch.ml import features as tfeat
from test_torch_graph import N_PAD, assert_json_close

TS = "2026-01-01T00:00:00+00:00"


def test_analysis_schema_builders_match_jax():
    rng = np.random.default_rng(0)
    cases = [
        ("gnn_result", ("v", "COW-0001", "EnhancedGraphGPS", 0.7, 0.4, 0.1,
                        {"num_nodes": 3}, [{"video_id": "a"}] * 7,
                        ["a", "b"])),
        ("gnn_result", ("v", None, "m", np.float32(0.2), 0.6, 0.0, {}, [],
                        [])),
        ("graph_transformer_result", ("v", "COW-0002", 0.3, 0.8, 0.05,
                                      {"num_layers": 6}, {"top": []},
                                      ["v"])),
        ("ml_result", ("v", rng.uniform(0, 1, 12), ["f"] * 12,
                       {"ensemble": {"probability": 0.5}}, {"yolo": True})),
        ("ml_message", ("v", "/p", {"predictions": {"x": 1}})),
        ("tracking_result", ("v", [{"track_id": 0}], [{"frame": 0}],
                             {"total_tracks": 1})),
        ("reid_entry", (np.int64(3), "COW-0001", "id", np.float32(0.9), 1.0,
                        np.bool_(True))),
        ("fusion_result_file", ("v", "COW-0001", {"a": 1}, None, {"b": 2},
                                TS)),
        ("cow_prediction_file", ("COW-0001", {"p": 1}, "v", TS)),
    ]
    for name, args in cases:
        assert getattr(tschemas, name)(*args) == \
            getattr(jschemas, name)(*args), name
    for kind in ("gnn", "graph_transformer", "ml", "tracking", "fusion"):
        assert tschemas.REQUIRED_KEYS[kind] == jschemas.REQUIRED_KEYS[kind]


def _results(rng):
    return {
        "yolo": {"features": {"avg_confidence": rng.uniform(),
                              "position_stability": rng.uniform(),
                              "avg_box_area": rng.uniform(1e3, 1e5),
                              "detection_rate": rng.uniform()}},
        "sam3": {"features": {"avg_area_ratio": rng.uniform(),
                              "avg_circularity": rng.uniform(),
                              "avg_aspect_ratio": rng.uniform(1, 3)}},
        "dinov3": {"neighbor_evidence": rng.uniform(),
                   "similar_cases": [{}] * 3},
        "tleap": {"locomotion_features": {"stride_fl_mean": rng.uniform(),
                                          "stride_rr_mean": rng.uniform(),
                                          "head_bob_score": rng.uniform(),
                                          "rear_leg_asymmetry": 0.2}},
    }


@pytest.mark.parametrize("present", [0b0000, 0b0001, 0b0110, 0b1011,
                                     0b1111])
def test_features_match_jax(present):
    full = _results(np.random.default_rng(present))
    res = {k: (v if present >> i & 1 else None)
           for i, (k, v) in enumerate(full.items())}
    got, want = tfeat.extract_features(res), jfeat.extract_features(res)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    traits = {"tleap": {"locomotion_traits": {"avg_stride_length": 1.0,
                                              "asymmetry_score": 0.3}}}
    np.testing.assert_array_equal(tfeat.extract_features(traits)[0],
                                  jfeat.extract_features(traits)[0])


@pytest.fixture(scope="module")
def fitted_models(tmp_path_factory):
    """The JAX package's GBDTEnsemble fitted on a small seeded task and
    saved: xgboost_latest.json, lightgbm_latest.txt, catboost_latest.json
    (and joblib dumps)."""
    d = tmp_path_factory.mktemp("ml")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((80, 12))
    y = (x[:, 0] + 0.5 * x[:, 3] + rng.normal(0, 0.5, 80) > 0).astype(int)
    params = {s: {"n_estimators": 8, "max_depth": 3}
              for s in jens.MODEL_SLOTS}
    jens.GBDTEnsemble(d / "models", params=params).fit(x, y, cv_folds=2)
    return d / "models", rng.standard_normal((20, 12))


def test_ensemble_predict_matches_jax(fitted_models):
    models, xs = fitted_models
    t, j = tens.GBDTEnsemble(models), jens.GBDTEnsemble(models)
    assert set(t.models) == set(jens.MODEL_SLOTS)
    assert t.ensemble_weights == j.ensemble_weights
    for x in xs:
        got, want = t.predict(x), j.predict(x)
        assert set(got) == set(want)
        for slot, w in want.items():
            assert abs(got[slot]["probability"] - w["probability"]) <= 1e-12
            assert got[slot]["prediction"] == w["prediction"]


def test_ensemble_without_models(tmp_path):
    t = tens.GBDTEnsemble(tmp_path / "none")
    assert not t.has_models
    got = t.predict(np.full(10, 0.5))
    assert got == jens.GBDTEnsemble(tmp_path / "none").predict(
        np.full(10, 0.5))
    assert got["ensemble"]["probability"] == 0.5


def test_ensemble_reads_joblib_only_when_present(fitted_models, tmp_path):
    """With only the lightgbm file, loading imports no joblib; with a
    .joblib dump in a slot without its reference file, it loads it."""
    models, _ = fitted_models
    only = tmp_path / "only"
    only.mkdir()
    shutil.copy(models / "lightgbm_latest.txt", only)
    code = ("import sys; from lameness_tpu_torch.ml.ensemble import "
            "GBDTEnsemble; e = GBDTEnsemble(sys.argv[1]); "
            "print(sorted(e.models), 'joblib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(only)],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(chip_smoke.__file__))
    assert out.stdout.split() == ["['lightgbm']", "False"], out.stderr
    shutil.copy(models / "xgboost_latest.joblib", only)
    assert sorted(tens.GBDTEnsemble(only).models) == ["lightgbm", "xgboost"]


# ---------------------------------------------------------------- fusion ---
def _predictions(mode):
    auto = {"ml": 0.9, "tcn": 0.85, "transformer": 0.88, "gnn": 0.95,
            "graph_transformer": 0.9}
    if mode == "hybrid":
        auto = {"ml": 0.6, "tcn": 0.5, "transformer": 0.55}
    elif mode == "uncertain":
        auto = {"ml": 0.05, "tcn": 0.95, "gnn": 0.1}
    preds = {k: {"probability": p, "uncertainty": 0.1 * i}
             for i, (k, p) in enumerate(auto.items())}
    if mode == "human":
        preds["human"] = {"probability": 0.2, "confidence": 0.9,
                          "num_raters": 4}
    if mode == "none":
        preds = {"human": {"probability": 0.3, "confidence": 0.5,
                           "num_raters": 1}}
    preds["tleap"] = {"stride_fl_mean": 0.3}
    return preds


@pytest.mark.parametrize("mode", ["automated", "hybrid", "uncertain",
                                  "human", "none"])
def test_fuse_predictions_matches_jax(mode):
    preds = _predictions(mode)
    assert tfusion.apply_gating_rules(preds) == \
        jfusion.apply_gating_rules(preds)
    assert tfusion.fuse_predictions(preds) == jfusion.fuse_predictions(preds)
    for s in (0.0, 0.29, 0.3, 0.5, 0.69, 0.7, 1.0):
        assert tfusion.severity_level(s) == jfusion.severity_level(s)


def _service(mod, root):
    from lameness_tpu.core.config import DataDirs as JDataDirs
    from lameness_tpu_torch.core.config import DataDirs
    dirs = (JDataDirs if mod is jfusion else DataDirs)(root=str(root))
    dirs.ensure()
    return mod.FusionService(dirs)


def test_fusion_service_matches_jax(tmp_path):
    """process_video at a fixed timestamp on single-video cows, and
    aggregate_cow_predictions over fusion files with set mtimes."""
    roots = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        chip_smoke.write_cow_videos(root, cows=2, per_cow=1, dim=32)
        roots[tag] = root
    got = _service(tfusion, roots["port"]).process_video("cow01_v0", TS)
    want = _service(jfusion, roots["jax"]).process_video("cow01_v0", TS)
    assert got == want
    assert got["cow_id"] == "COW-0002"
    assert set(got["fusion_result"]["pipeline_contributions"]) == {
        "tcn", "transformer"}
    # three fusion files of one cow, mtimes a day apart
    root = tmp_path / "agg"
    chip_smoke.write_cow_videos(root, cows=1, per_cow=3, dim=32)
    svc = {"port": _service(tfusion, root), "jax": _service(jfusion, root)}
    for i, vid in enumerate(("cow00_v0", "cow00_v1", "cow00_v2")):
        tschemas.write_result(
            root / "results" / "fusion" / f"{vid}_fusion.json",
            {"fusion_result": {"final_probability": 0.2 + 0.3 * i,
                               "confidence": 0.9 - 0.2 * i}})
        t = 1.7e9 + 86400 * i
        os.utime(root / "results" / "fusion" / f"{vid}_fusion.json", (t, t))
    assert svc["port"].aggregate_cow_predictions("COW-0001") == \
        svc["jax"].aggregate_cow_predictions("COW-0001")
    assert svc["port"].aggregate_cow_predictions("COW-0009") == \
        svc["jax"].aggregate_cow_predictions("COW-0009")


def test_stacking_model_that_does_not_load(tmp_path):
    """A stacking model whose pickle needs a library that is missing fuses
    by the weights, as in JAX."""
    from lameness_tpu_torch.core.config import DataDirs
    dirs = DataDirs(root=str(tmp_path)).ensure()
    (dirs.models / "fusion").mkdir()
    # a pickle of the global no_such_module.X (protocol 0)
    (dirs.models / "fusion" / "stacking_model.pkl").write_bytes(
        b"cno_such_module\nX\n.")
    assert tfusion.FusionService(dirs).stacking_model is None


# -------------------------------------------------------------- back half ---
def _json_files(root):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted((root / "results").glob("*/*.json"))}


def test_back_half_matches_jax(tmp_path, monkeypatch):
    """The drivers' run_tracking -> graph heads -> run_ml -> fusion over the
    same result files (copied with their mtimes)."""
    from lameness_tpu.core.config import Config as JConfig
    from lameness_tpu.core.config import DataDirs as JDataDirs
    from lameness_tpu.models.graphgps import EnhancedGraphGPS as JGraphGPS
    from lameness_tpu.models.graphormer import \
        CowLamenessGraphormer as JGraphormer
    from lameness_tpu.serve.driver import PipelineDriver as JDriver
    from lameness_tpu.serve.graph_runner import GraphHeadRunner as JRunner
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.serve.graph_runner import GraphHeadRunner
    from lameness_tpu_torch.weights import from_jax_params
    counter = [itertools.count()]
    monkeypatch.setattr(jreid.uuid, "uuid4",
                        lambda: f"id-{next(counter[0])}")
    src = tmp_path / "src"
    vids = chip_smoke.write_cow_videos(src, cows=3, per_cow=3,
                                       tracking=False)
    files = {}
    for tag in ("jax", "port"):
        counter[0] = itertools.count()
        root = tmp_path / tag
        shutil.copytree(src, root)
        if tag == "jax":
            cfg = JConfig(dirs=JDataDirs(root=str(root)))
            drv = JDriver(config=cfg)
            drv.graph_runner = JRunner(cfg, bus=drv.bus, max_nodes=N_PAD)
            drv.graph_runner.gnn = JGraphGPS(dropout=0.0)
            drv.graph_runner.gt = JGraphormer(dropout=0.0)
            drv.graph_runner._ensure_params(N_PAD)
            params = from_jax_params({"gnn": drv.graph_runner._params["gnn"],
                                      "gt": drv.graph_runner._params["gt"]})
        else:
            cfg = Config(dirs=DataDirs(root=str(root)))
            drv = PipelineDriver(config=cfg, device="cpu")
            drv.graph_runner = chip_smoke.zero_dropout(GraphHeadRunner(
                cfg, bus=drv.bus, max_nodes=N_PAD, device="cpu",
                params=params))
        for vid in vids:
            drv.run_tracking(vid)
            drv._ensure_graph_runner().process_video(vid)
            drv.run_ml(vid)
            drv.fusion.process_video(vid, timestamp=TS)
        files[tag] = _json_files(root)
        drv.bus.shutdown()
    got, want = files["port"], files["jax"]
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        if name.startswith("results/cow_predictions/"):
            g, w = dict(g), dict(w)
            assert g.pop("last_updated") and w.pop("last_updated")
        if name.startswith(("results/gnn/", "results/graph_transformer/",
                            "results/fusion/", "results/cow_predictions/")):
            assert_json_close(g, w)
        else:
            assert g == w, name
    # every fusion file names the five automated predictors, and Re-ID
    # found each cow.  (FusionService reads the video -> cow mapping once,
    # at its first video, as JAX's does: later videos fuse without a cow.)
    assert got[f"results/fusion/{vids[0]}_fusion.json"]["cow_id"] == \
        "COW-0001"
    for vid in vids:
        fr = got[f"results/fusion/{vid}_fusion.json"]
        assert set(fr["fusion_result"]["pipeline_contributions"]) == set(
            tfusion.AUTO_KEYS)
        cow = f"COW-{int(vid[3:5]) + 1:04d}"
        assert got[f"results/tracking/{vid}_tracking.json"][
            "reid_results"][0]["cow_id"] == cow
        assert got[f"results/gnn/{vid}_gnn.json"]["cow_id"] == cow
        for kind in ("gnn", "graph_transformer", "ml", "tracking", "fusion"):
            assert not tschemas.validate(
                kind, got[f"results/{kind}/{vid}_{kind}.json"])


def test_analysis_config_matches_jax():
    """The config fields the analysis reads (the graph runner's kNN degree
    and padding bound) have the JAX package's defaults."""
    import dataclasses
    from lameness_tpu.core import config as jconfig
    from lameness_tpu_torch.core import config as tconfig
    got = tconfig.Config().graphgps
    want = jconfig.Config().graphgps
    assert isinstance(got, tconfig.GraphGPSConfig)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
