"""The port's explanations (``lameness_tpu_torch/xai``) against the JAX
package's.

- ``shapley``: exact Shapley values, the report, what-if and global
  importance on seeded functions: equal.
- ``ShapService.process_analysis`` over the port's and JAX's
  ``GBDTEnsemble`` loaded from the same reference files (written by the JAX
  package's ``fit``/``save``), with the same ML result files as background:
  the reports within 1e-9, and the files written.
- The LLM prompt and template explanation: equal.  The Ollama request,
  sent to a stub server on localhost: the same JSON body as JAX's (which
  posts with httpx; the port with ``urllib.request``), and the answer used.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from lameness_tpu.core import config as jconfig
from lameness_tpu.io import schemas as jschemas
from lameness_tpu.ml import ensemble as jens
from lameness_tpu.xai import llm as jllm
from lameness_tpu.xai import shap_service as jshap
from lameness_tpu.xai import shapley as jsh
from lameness_tpu_torch.core import config as tconfig
from lameness_tpu_torch.ml import ensemble as tens
from lameness_tpu_torch.xai import llm as tllm
from lameness_tpu_torch.xai import shap_service as tshap
from lameness_tpu_torch.xai import shapley as tsh
from test_torch_hitl import assert_close

FUSION = {
    "final_probability": 0.82, "confidence": 0.75,
    "decision_mode": "automated", "model_agreement": 0.9, "unanimous": True,
    "recommendation": "High lameness probability - consider veterinary "
                      "examination",
    "pipeline_contributions": {
        "ml": {"probability": 0.8, "uncertainty": 0.1, "weight": 0.15},
        "tcn": {"probability": 0.85, "uncertainty": 0.05, "weight": 0.12},
        "human": {"probability": 0.7, "uncertainty": 0.2, "weight": 0.35,
                  "num_raters": 3}},
    "tleap_features": {"back_arch_score": 0.4, "head_bob_score": 0.6},
}
SHAP = {"top_features": [
    {"feature": "tleap_head_bob", "shap_value": 0.21, "feature_value": 0.6},
    {"feature": "tcn_probability", "shap_value": -0.05,
     "feature_value": 0.3}]}


def test_shapley_matches_jax():
    rng = np.random.default_rng(0)

    def predict(rows):
        return np.tanh(rows[:, 0] * rows[:, 1]) + rows[:, 2] ** 2 \
            - 0.3 * rows[:, 3]
    bg = rng.standard_normal((16, 4))
    for _ in range(5):
        x = rng.standard_normal(4)
        np.testing.assert_array_equal(tsh.exact_shapley(predict, x, bg),
                                      jsh.exact_shapley(predict, x, bg))
        names = ["a", "b", "c", "d"]
        assert_close(tsh.shap_report(predict, x, bg, names, "v"),
                     jsh.shap_report(predict, x, bg, names, "v"), tol=0)
        assert_close(tsh.what_if(predict, x, 2, [-1.0, 0.0, 2.0]),
                     jsh.what_if(predict, x, 2, [-1.0, 0.0, 2.0]), tol=0)
    assert_close(tsh.global_importance(predict, bg[:5], bg, list("abcd")),
                 jsh.global_importance(predict, bg[:5], bg, list("abcd")),
                 tol=0)
    # past the exact limit the permutation sampler (seeded) takes over
    wide = rng.standard_normal((4, 14))
    x = rng.standard_normal(14)
    np.testing.assert_array_equal(
        tsh.shap_report(lambda r: r.sum(1), x, wide, list("abcdefghijklmn"),
                        "w")["shap_values"]["a"],
        jsh.shap_report(lambda r: r.sum(1), x, wide, list("abcdefghijklmn"),
                        "w")["shap_values"]["a"])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("xai")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((80, 6))
    y = (x[:, 0] - 0.5 * x[:, 2] + rng.normal(0, 0.4, 80) > 0).astype(int)
    params = {s: {"n_estimators": 6, "max_depth": 3}
              for s in jens.MODEL_SLOTS}
    jens.GBDTEnsemble(d / "models", params=params).fit(x, y, cv_folds=2)
    return d / "models", x


def _ml_files(dirs, x):
    names = [f"f{i}" for i in range(x.shape[1])]
    for i in range(6):
        jschemas.write_result(dirs.results_for("ml") / f"bg{i}_ml.json",
                              {"features": list(map(float, x[i])),
                               "feature_names": names})
    jschemas.write_result(dirs.results_for("ml") / "tgt_ml.json",
                          {"features": list(map(float, x[40])),
                           "feature_names": names})


def test_shap_service_matches_jax(models, tmp_path):
    mdir, x = models
    jcfg = jconfig.Config.load(data_root=str(tmp_path / "jax"))
    tcfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(tmp_path / "port")))
    for c in (jcfg, tcfg):
        c.dirs.ensure()
        _ml_files(c.dirs, x)
    js = jshap.ShapService(jcfg.dirs, jens.GBDTEnsemble(mdir))
    ts = tshap.ShapService(tcfg.dirs, tens.GBDTEnsemble(mdir))
    want = js.process_analysis({"video_id": "tgt"})
    got = ts.process_analysis({"video_id": "tgt"})
    assert got["status"] == "computed"
    assert_close(got, want, tol=1e-9)
    assert_close(json.loads((tcfg.dirs.results / "shap" /
                             "tgt_shap.json").read_text()), want, tol=1e-9)
    # no ML file, no video id: nothing; no models: the no_models report
    assert ts.process_analysis({"video_id": "ghost"}) is None
    assert ts.process_analysis({}) is None
    empty = tshap.ShapService(tcfg.dirs, tens.GBDTEnsemble(tmp_path / "no"))
    assert empty.process_analysis({"video_id": "tgt"}) == \
        jshap.ShapService(jcfg.dirs, jens.GBDTEnsemble(tmp_path / "no")
                          ).process_analysis({"video_id": "tgt"})


def test_llm_template_matches_jax(tmp_path):
    for fusion in (FUSION, {"final_probability": 0.3, "confidence": 0.8,
                            "decision_mode": "automated",
                            "pipeline_contributions": {}}, {}):
        for shap in (SHAP, None):
            assert tllm.build_prompt(fusion, shap, {"quality": 0.9}) == \
                jllm.build_prompt(fusion, shap, {"quality": 0.9})
            assert tllm.local_explanation(fusion, shap) == \
                jllm.local_explanation(fusion, shap)
    jcfg = jconfig.Config.load(data_root=str(tmp_path / "jax"))
    tcfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(tmp_path / "port")))
    for c in (jcfg, tcfg):
        c.dirs.ensure()
        (c.dirs.results / "shap").mkdir(parents=True, exist_ok=True)
        (c.dirs.results / "shap" / "v1_shap.json").write_text(
            json.dumps(SHAP))
    msg = {"video_id": "v1", "fusion_result": FUSION}
    want = jllm.LLMExplanationService(jcfg.dirs).handle_analysis_complete(msg)
    got = tllm.LLMExplanationService(tcfg.dirs).handle_analysis_complete(msg)
    assert got == want and got["provider"] == "local_template"
    assert json.loads((tcfg.dirs.results / "explanations" /
                       "v1_explanation.json").read_text()) == want


class _Ollama(BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).bodies.append((self.path, self.headers["Content-Type"],
                                  json.loads(body)))
        out = json.dumps({"response": "stub explanation"}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


def test_ollama_request_matches_jax(tmp_path):
    pytest.importorskip("httpx")             # the JAX side posts with it
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Ollama)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        jcfg = jconfig.Config.load(data_root=str(tmp_path / "jax"))
        tcfg = tconfig.Config(dirs=tconfig.DataDirs(
            root=str(tmp_path / "port")))
        for c in (jcfg, tcfg):
            c.dirs.ensure()
        want = jllm.LLMExplanationService(jcfg.dirs, ollama_url=url).explain(
            "v2", FUSION, SHAP)
        got = tllm.LLMExplanationService(tcfg.dirs, ollama_url=url).explain(
            "v2", FUSION, SHAP)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got == want
    assert got["provider"] == "ollama"
    assert got["explanation"] == "stub explanation"
    (jpath, _, jbody), (tpath, ttype, tbody) = _Ollama.bodies[-2:]
    assert tpath == jpath == "/api/generate"
    assert ttype == "application/json"
    assert tbody == jbody
    assert tbody["model"] == "llama3" and tbody["stream"] is False
    # no server: the template, as in JAX
    dead = tllm.LLMExplanationService(tcfg.dirs, ollama_url=url)
    assert dead.explain("v3", FUSION)["provider"] == "local_template"
