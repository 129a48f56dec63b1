"""The port's admin API (``serve/api.py`` over ``serve/http.py``) and its
SPA against the JAX package's, both live on localhost.

Two servers are seeded identically (users, result files, an ensemble
written by the JAX package's ``fit``/``save`` with SHAP and LLM services
over it, rater reliability, a vector store, cows) and take one scripted
request session that covers every route group: auth, videos, upload,
analysis, HITL pairwise/triplet, hierarchy, raters, ML config, SHAP and
what-if, users, cows and Re-ID, health and system, the tutorial, the static
SPA.  Status codes and JSON bodies must agree key by key once ids, tokens,
timestamps and each side's data root are normalised (floats within 1e-9);
a few volatile bodies (the host's disk and memory, the unseeded active
pair) are compared by their keys.  The port's own deviations are checked
on their own: ``.y4m`` uploads and their content type, and the frame
endpoint's PNG; and the annotated clip, JAX's ``<id>_annotated.mp4``
served as ``video/mp4``.  Also
the WS broadcast, every static file byte for byte, and two SPA flows (the
login, every page executing) through tests/support_browser.py against
the port's server.
"""
import itertools
import json
import random
import re
import struct
import uuid
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

httpx = pytest.importorskip("httpx")

from lameness_tpu.core import config as jconfig
from lameness_tpu.hitl import reliability as jrel
from lameness_tpu.io import bus as jbus
from lameness_tpu.io import db as jdb
from lameness_tpu.io import vecstore as jvec
from lameness_tpu.ml import ensemble as jens
from lameness_tpu.serve import api as japi
from lameness_tpu.utils import timing as jtiming
from lameness_tpu.xai import llm as jllm
from lameness_tpu.xai import shap_service as jshap
from lameness_tpu_torch.core import config as tconfig
from lameness_tpu_torch.hitl import reliability as trel
from lameness_tpu_torch.io import bus as tbus
from lameness_tpu_torch.io import db as tdb
from lameness_tpu_torch.io import vecstore as tvec
from lameness_tpu_torch.ml import ensemble as tens
from lameness_tpu_torch.serve import api as tapi
from lameness_tpu_torch.utils import timing as ttiming
from lameness_tpu_torch.video.decode import VideoReader, write_video
from lameness_tpu_torch.xai import llm as tllm
from lameness_tpu_torch.xai import shap_service as tshap
from test_api import _ws_connect, _ws_read_text, _ws_wait

ROOT = Path(__file__).resolve().parents[1]
JSTATIC = ROOT / "lameness_tpu" / "serve" / "static"
TSTATIC = ROOT / "lameness_tpu_torch" / "serve" / "static"
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
_TS = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(\+00:00|Z)?")
# keys whose values are the wall clock, a token or a process measure
_VOLATILE = re.compile(r"(_at$|_time$|^time$|timestamp|^date$|_date$|"
                       r"token|^uptime|^expires|^last_|^first_seen$|"
                       r"seconds$|^elapsed|latency|_ms$|^started$)")
NAMES = ["f0", "f1", "f2", "f3", "f4", "f5"]


def _frames(n=6, h=36, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("apimodels")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((80, 6))
    y = (x[:, 0] - 0.5 * x[:, 2] + rng.normal(0, 0.4, 80) > 0).astype(int)
    params = {s: {"n_estimators": 6, "max_depth": 3}
              for s in jens.MODEL_SLOTS}
    jens.GBDTEnsemble(d / "models", params=params).fit(x, y, cv_folds=2)
    return d / "models", x


def _seed_results(dirs, x):
    """The same result files under each side's root."""
    from lameness_tpu_torch.io import schemas
    for i in range(4):
        schemas.write_result(dirs.results_for("ml") / f"bg{i}_ml.json",
                             {"features": list(map(float, x[i])),
                              "feature_names": NAMES,
                              "predictions": {},
                              "pipeline_results_available": {}})
    schemas.write_result(dirs.results_for("ml") / "vA_ml.json",
                         {"video_id": "vA",
                          "features": list(map(float, x[50])),
                          "feature_names": NAMES, "predictions": {
                              "ensemble": {"probability": 0.61}},
                          "pipeline_results_available": {"tcn": True}})
    for kind, payload in {
        "fusion": {"video_id": "vA", "cow_id": "COW-0001",
                   "fusion_result": {
                       "final_probability": 0.72, "final_prediction": 1,
                       "confidence": 0.5, "decision_mode": "automated",
                       "pipeline_contributions": {
                           "tcn": {"probability": 0.7, "uncertainty": 0.1,
                                   "weight": 0.12}}}},
        "tcn": {"video_id": "vA", "severity_score": 0.7, "probability": 0.7,
                "uncertainty": 0.08},
        "transformer": {"video_id": "vA", "severity_score": 0.6,
                        "probability": 0.6, "uncertainty": 0.1},
        "yolo": {"video_id": "vA", "detections": [
            {"frame": 0, "time": 0.0, "detections": [
                {"frame": 0, "bbox": [4, 4, 40, 30], "confidence": 0.9,
                 "class": "cow", "class_id": 19}]}]},
        "tleap": {"video_id": "vA", "pose_sequences": [
            {"frame": 0, "bbox": [4, 4, 40, 30], "keypoints": [
                {"name": "withers", "x": 20, "y": 10, "confidence": 0.9},
                {"name": "neck", "x": 30, "y": 12, "confidence": 0.9}]}],
            "locomotion_features": {"back_arch_score": 0.4}},
        "dinov3": {"video_id": "vA", "embedding_norm": 1.0,
                   "similar_cases": []},
    }.items():
        schemas.write_result(dirs.results_for(kind) / f"vA_{kind}.json",
                             payload)


def _side(kind, root, models_dir, x):
    m = (jconfig, jdb, jbus, jrel, jvec, jens, jshap, jllm, japi) \
        if kind == "jax" else \
        (tconfig, tdb, tbus, trel, tvec, tens, tshap, tllm, tapi)
    config, db, bus_mod, rel_mod, vec, ens, shap, llm, api = m
    cfg = config.Config.load(data_root=str(root))
    cfg.dirs.ensure()
    _seed_results(cfg.dirs, x)
    bus = bus_mod.MessageBus()
    rel = rel_mod.RaterReliabilityService(cfg.dirs.rater_reliability,
                                          bus=bus, subjects=cfg.subjects)
    bus.subscribe_sync(cfg.subjects.hitl_comparison_submitted,
                       rel.handle_comparison_submitted)
    rel.add_gold_task("vA", 1)
    store = vec.VectorStore() if kind == "jax" else \
        vec.VectorStore(device="cpu")
    store.create_collection("cow_embeddings", 4)
    for i, v in enumerate(np.random.default_rng(2).standard_normal((5, 4))):
        store.upsert("cow_embeddings", f"p{i}", v.tolist(),
                     {"video_id": f"v{i}", "cow_id": f"COW-000{i % 2}"})
    ensemble = ens.GBDTEnsemble(models_dir)
    ctx = api.AdminContext(
        cfg, db.Database(root / "api.db"), bus, reliability=rel,
        ensemble=ensemble, shap_service=shap.ShapService(cfg.dirs, ensemble),
        llm_service=llm.LLMExplanationService(cfg.dirs), store=store)
    if kind == "port":
        ctx.device = "cpu"       # the frame and annotation routes' device
    ctx.seed_users(password="testpw")
    for k in range(3):
        ctx.db.record_sighting(f"COW-000{k % 2}", "vA", k, 0.9, 0, 50, 0.8)
    ctx.db.get_or_create_cow("COW-0001")
    ctx.db.add_lameness_record("COW-0001", "vA", {
        "final_probability": 0.72, "final_prediction": 1, "confidence": 0.5},
        {"tcn": {"probability": 0.7}})
    srv = api.make_server(ctx)
    srv.start()
    return {"base": f"http://127.0.0.1:{srv.port}", "ctx": ctx, "srv": srv,
            "root": str(root), "kind": kind}


# each side draws its ids from its own counter, so both make the same ids
# in the same order (routes that sort by id then agree)
_ACTIVE = ["jax"]
_COUNTERS = {}


def _uuid4():
    return uuid.UUID(int=next(_COUNTERS[_ACTIVE[0]]))


@pytest.fixture(scope="module")
def sides(tmp_path_factory, models):
    mdir, x = models
    tmp = tmp_path_factory.mktemp("api")
    # the health routes report the process-wide stage timers, which tests
    # run earlier in this process may have filled on one side only
    jtiming.TIMERS.reset()
    ttiming.TIMERS.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", _uuid4)
        out = {}
        for k in ("jax", "port"):
            _ACTIVE[0] = k
            _COUNTERS[k] = itertools.count(1)
            out[k] = _side(k, tmp / k, mdir, x)
        yield out
    for s in out.values():
        s["srv"].stop()


def _norm(obj, root, names=None):
    """Ids the session made (videos, users) by their names, other uuids,
    timestamps and the data root by placeholders, volatile keys dropped,
    floats to 9 places."""
    names = names or {}
    if isinstance(obj, dict):
        return {_norm(k, root, names): _norm(v, root, names)
                for k, v in obj.items() if not _VOLATILE.search(str(k))}
    if isinstance(obj, list):
        return [_norm(v, root, names) for v in obj]
    if isinstance(obj, str):
        s = obj.replace(root, "<root>")
        for uid, name in names.items():
            s = s.replace(uid, name)
        s = _UUID.sub("<uuid>", s)
        return _TS.sub("<ts>", s)
    if isinstance(obj, float):
        return round(obj, 9)
    return obj


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__


class Session:
    """Runs the script against one server and records what it saw."""

    def __init__(self, side):
        self.side = side["kind"]
        self.base = side["base"]
        self.root = side["root"]
        self.ctx = side["ctx"]
        self.http = httpx.Client(base_url=self.base, timeout=60)
        self.seen = []
        self.tokens = {}
        self.ids = {}

    def call(self, method, path, mode="full", user="admin", **kw):
        random.seed(0)                 # routes that sample with `random`
        _ACTIVE[0] = self.side
        headers = kw.pop("headers", {})
        if user and user in self.tokens:
            headers["Authorization"] = f"Bearer {self.tokens[user]}"
        r = self.http.request(method, path, headers=headers, **kw)
        ctype = r.headers.get("content-type", "")
        if "json" in ctype:
            body = r.json()
        else:
            body = {"bytes": len(r.content), "ctype": ctype}
        if mode == "full":
            rec = _norm(body, self.root,
                        {v: f"<{k}>" for k, v in self.ids.items()
                         if isinstance(v, str)})
        elif mode == "keys":
            rec = _keys(body)
        else:
            rec = None
        self.seen.append((method, _UUID.sub("<uuid>", path), r.status_code,
                          rec))
        return r


def _script(s: Session):
    c = s.call
    # ---------------------------------------------------------------- auth
    for u in ("admin", "researcher", "rater"):
        r = c("POST", "/api/auth/login", user=None,
              json={"username": u, "password": "testpw"})
        s.tokens[u] = r.json()["access_token"]
    c("POST", "/api/auth/login", user=None,
      json={"username": "admin", "password": "wrong"})
    c("GET", "/api/auth/me")
    c("GET", "/api/auth/me", user=None)
    r = c("POST", "/api/auth/register", user=None,
          json={"email": "r2@x", "username": "r2", "password": "pw"})
    s.ids["r2"] = r.json()["id"]
    c("POST", "/api/auth/register", user=None,
      json={"email": "e@x", "username": "evil", "password": "pw",
            "role": "admin"})
    r = c("POST", "/api/auth/login", user=None,
          json={"username": "r2", "password": "pw"})
    s.tokens["r2"] = r.json()["access_token"]
    c("POST", "/api/auth/refresh", mode="keys")
    c("GET", "/api/auth/users")
    c("GET", "/api/auth/users", user="rater")
    r = c("POST", "/api/auth/users", json={
        "email": "r3@x", "username": "r3", "password": "pw",
        "role": "rater", "rater_tier": "gold"})
    s.ids["r3"] = r.json().get("id")
    c("GET", f"/api/auth/users/{s.ids['r3']}")
    c("PATCH", f"/api/auth/users/{s.ids['r2']}",
      json={"rater_tier": "silver"})
    c("PATCH", f"/api/auth/users/{s.ids['r2']}", json={"rater_tier": "x"})
    c("PUT", f"/api/auth/users/{s.ids['r3']}/tier", json={"tier": "bronze"})
    c("PUT", f"/api/auth/users/{s.ids['r3']}/role",
      json={"role": "researcher"})
    c("PUT", f"/api/auth/users/{s.ids['r3']}/status",
      json={"is_active": False})
    c("PUT", "/api/auth/password", user="r2",
      json={"current_password": "pw", "new_password": "pw2"})
    c("DELETE", f"/api/auth/users/{s.ids['r3']}")
    # -------------------------------------------------------------- videos
    y4m = write_video(Path(s.root) / "up", _frames(), 10,
                      device="cpu").read_bytes()
    # named .mp4: JAX's upload takes no .y4m (the port's does: below)
    for name in ("walk-a.mp4", "walk-b.mp4", "walk-c.mp4"):
        r = c("POST", f"/api/videos/upload?filename={name}", content=y4m)
        s.ids[name] = r.json()["video_id"]
    c("POST", "/api/videos/upload?filename=notes.txt", content=b"x")
    va, vb, vc = (s.ids[n] for n in ("walk-a.mp4", "walk-b.mp4",
                                     "walk-c.mp4"))
    c("GET", "/api/videos")
    c("GET", "/api/videos?status=uploaded&skip=1&limit=1")
    c("GET", f"/api/videos/{va}")
    c("GET", "/api/videos/nope")
    c("GET", f"/api/videos/{va}/stream", headers={"Range": "bytes=0-99"})
    c("GET", f"/api/videos/{va}/stream", headers={"Range": "bytes=-10"})
    c("GET", f"/api/videos/{va}/stream-url")
    c("POST", "/api/videos/upload-url", json={"filename": "z.mp4"})
    c("POST", f"/api/videos/{va}/confirm-upload")
    c("POST", "/api/videos/confirm-upload", json={"video_id": va})
    c("POST", f"/api/videos/{va}/label", json={"label": 1})
    c("POST", f"/api/videos/{vb}/label", json={"label": 0})
    c("POST", f"/api/videos/{vc}/label", json={"label": 3})
    c("GET", "/api/videos/storage-config")
    c("POST", "/api/videos/migrate-to-db")
    c("GET", "/api/videos/vA/detections")
    c("GET", "/api/videos/vA/pose")
    c("GET", "/api/videos/nope/detections")
    c("GET", f"/api/videos/{va}/annotation-status")
    # ------------------------------------------------------------ analysis
    for p in ("/api/analysis/vA", "/api/analysis/vA/fusion",
              "/api/analysis/vA/tcn", "/api/analysis/vA/nope",
              "/api/analysis/vA/all", "/api/analysis/vA/summary",
              "/api/analysis/vA/export", "/api/analysis/vA/explanation",
              "/api/analysis/vA/explanation/get",
              "/api/analysis/vA/graph_transformer",
              "/api/analysis/similarity/map", "/api/analysis/nope"):
        c("GET", p)
    c("POST", "/api/analysis/vA/explanation/generate")
    c("GET", "/api/analysis/vA/explanation/get")
    c("POST", "/api/analysis/batch", json={"video_ids": ["vA"]})
    # -------------------------------------------------- HITL pairwise/elo
    for i, (a, b, w) in enumerate([(va, vb, 1), (vb, vc, 2), (va, vc, 1),
                                   ("vA", va, 0)]):
        for u in ("rater", "r2"):
            c("POST", "/api/training/pairwise", user=u, json={
                "video_id_1": a, "video_id_2": b, "winner": w,
                "degree": 1 + i % 3, "confidence": "confident"})
            c("POST", "/api/elo/comparison", user=u, json={
                "video_id_1": a, "video_id_2": b, "winner": w,
                "degree": 1 + i % 3})
    c("GET", "/api/elo/hierarchy")
    c("GET", "/api/elo/stats")
    c("GET", f"/api/elo/history/{va}")
    c("GET", f"/api/elo/video/{va}/history")
    c("GET", "/api/elo/next-pair", mode="keys")
    r = c("POST", "/api/elo/snapshot", json={"name": "s1"})
    s.ids["snap"] = (r.json() or {}).get("id") or \
        (r.json() or {}).get("snapshot_id")
    c("GET", "/api/elo/snapshots")
    c("GET", f"/api/elo/snapshot/{s.ids['snap']}")
    c("POST", "/api/elo/recalculate")
    c("GET", "/api/elo/hierarchy")
    c("GET", "/api/training/pairwise/ranking")
    c("GET", "/api/training/pairwise/stats")
    c("GET", "/api/training/pairwise/next", user="rater", mode="keys")
    c("GET", "/api/training/triplet/next", user="rater", mode="keys")
    for u in ("rater", "r2"):
        c("POST", "/api/training/triplet/submit", user=u, json={
            "reference_id": va, "comparison_a_id": vb,
            "comparison_b_id": vc, "selected_answer": "A",
            "task_type": "similarity", "confidence": "certain"})
    c("POST", "/api/training/triplet", user="rater", json={
        "reference": vb, "option_a": va, "option_b": vc, "choice": "b",
        "task_type": "dissimilarity"})
    c("POST", "/api/training/triplet/submit", user="rater",
      json={"reference_id": va})
    c("GET", "/api/training/triplet/stats")
    c("GET", "/api/training/stats")
    c("GET", "/api/training/label-queue")
    c("GET", "/api/training/status")
    c("GET", "/api/training/models")
    c("GET", "/api/training/queue")
    c("GET", "/api/training/learn/progress", user="rater")
    c("PUT", "/api/training/learn/progress", user="rater",
      json={"level": 2, "xp": 40})
    c("GET", "/api/training/learn/leaderboard")
    c("GET", "/api/training/learn/examples", user="rater")
    c("POST", f"/api/training/videos/{va}/label", json={"label": 1})
    # --------------------------------------------------------- ML config
    c("GET", "/api/ml-config")
    cfg = {"xgboost": {"max_depth": 4},
           "ensemble": {"weights": {"catboost": 0.5, "xgboost": 0.3,
                                    "lightgbm": 0.2}}}
    c("PUT", "/api/ml-config", json=cfg)
    c("PUT", "/api/ml-config", json={"nope": {}})
    c("PUT", "/api/ml-config", user="rater", json=cfg)
    c("GET", "/api/ml-config/schema")
    c("GET", "/api/ml-config/parameter-descriptions")
    c("GET", "/api/ml-config/models/status")
    c("GET", "/api/ml-config/xgboost")
    c("PUT", "/api/ml-config/lightgbm", json={"num_leaves": 15})
    c("PUT", "/api/ml-config/lightgbm", json={"num_leaves": -3})
    c("GET", "/api/ml-config/nope")
    c("POST", "/api/ml-config/reset")
    c("GET", "/api/models/parameters")
    c("GET", "/api/models/parameters/defaults")
    c("POST", "/api/models/parameters", json={"tcn": {"mc_samples": 12}})
    c("GET", "/api/models/comparison")
    # -------------------------------------------------------------- SHAP
    c("GET", "/api/shap/vA/local")
    c("GET", "/api/shap/global")
    c("GET", "/api/shap/vA/force-plot")
    c("POST", "/api/shap/vA/what-if", json={"modifications": {"f0": 1.5}})
    c("POST", "/api/shap/vA/what-if", json={"feature_index": 2,
                                             "values": [-1.0, 0.0, 1.0]})
    c("POST", "/api/shap/what-if", json={"video_id": "vA",
                                         "modifications": {"f1": 0.1}})
    c("GET", "/api/shap/nope/local")
    # -------------------------------------------------------- cows/Re-ID
    for p in ("/api/cows", "/api/cows/COW-0001",
              "/api/cows/COW-0001/lameness-history",
              "/api/cows/COW-0001/videos", "/api/cows/COW-0001/prediction",
              "/api/cows/COW-0001/lameness", "/api/cows/summary/stats",
              "/api/cows/stats/summary", "/api/cows/NOPE"):
        c("GET", p)
    c("PATCH", "/api/cows/COW-0001", json={"tag_number": "T-17",
                                           "notes": "limps"})
    rec = s.http.get("/api/cows/COW-0001/lameness").json()
    rows = rec.get("records") if isinstance(rec, dict) else rec
    if rows:
        rid = rows[0].get("id")
        c("POST", f"/api/cows/COW-0001/lameness/{rid}/validate",
          json={"is_lame": True})
        c("GET", f"/api/cows/COW-0001/lameness/{rid}/validate")
    # ---------------------------------------------------- health/system
    c("POST", "/api/pipeline/heartbeat", json={
        "service_name": "fused-engine", "status": "healthy",
        "active_jobs": 1, "success_count": 3})
    c("POST", "/api/pipeline/heartbeat", json={
        "service_name": "fusion-service", "status": "degraded",
        "error_count": 1, "last_error": "x"})
    c("GET", "/api/pipeline/status")
    c("GET", "/api/pipeline/queue")
    c("GET", "/api/pipeline/logs/fused-engine")
    c("GET", "/api/pipeline/fused-engine/logs")
    c("GET", "/api/pipeline/fused-engine/status")
    c("POST", f"/api/pipeline/retrigger/yolo/{va}")
    c("POST", f"/api/pipeline/fusion/trigger/{va}")
    c("POST", "/api/pipeline/batch/reprocess", json={"video_ids": [va]})
    c("GET", "/api/health/overview", mode="keys")
    c("GET", "/api/health/throughput", mode="keys")
    for p in ("/api/health/disk", "/api/health/nats", "/api/health/qdrant",
              "/api/health/postgres", "/api/health/docker"):
        c("GET", p, mode="keys")
    c("GET", "/health")
    c("GET", "/api/no/such/route")
    # ---------------------------------------------------------- tutorial
    r = c("POST", "/api/tutorial/tasks", json={
        "video_id_1": va, "video_id_2": vb, "correct_winner": 1,
        "correct_degree": 2, "difficulty": "easy", "description": "d"})
    tid = (r.json() or {}).get("id")
    c("GET", "/api/tutorial/tasks")
    c("PUT", f"/api/tutorial/tasks/{tid}", json={"difficulty": "hard"})
    c("GET", "/api/tutorial/examples")
    c("GET", "/api/tutorial/stats")
    c("POST", "/api/tutorial/auto-generate", mode="keys")
    c("POST", "/api/tutorial/examples/auto-generate", mode="keys")
    c("DELETE", f"/api/tutorial/tasks/{tid}")
    c("POST", "/api/training/start/ml", mode="keys")
    c("POST", "/api/training/ml/start", mode="keys")
    # -------------------------------------------------------------- SPA
    c("GET", "/", mode="status")
    c("GET", "/static/app.js", mode="status")
    c("GET", "/static/pages/dashboard.js", mode="status")
    c("GET", "/static/nope.js")
    c("GET", "/static/..%2Fapi.py")
    c("POST", "/api/auth/logout")


def test_same_session_as_jax(sides):
    seen = {}
    for k in ("jax", "port"):
        s = Session(sides[k])
        _script(s)
        seen[k] = s.seen
    assert len(seen["port"]) == len(seen["jax"]) > 150
    diffs = [(got, want) for want, got in zip(seen["jax"], seen["port"])
             if got != want]
    assert diffs == []
    groups = {p.split("/")[2] if p.startswith("/api/") else p.split("/")[1]
              for _, p, _, _ in seen["port"]}
    for g in ("auth", "videos", "analysis", "training", "elo", "ml-config",
              "models", "shap", "cows", "pipeline", "health", "tutorial",
              "static"):
        assert g in groups, g


def test_port_deviations_for_y4m(sides):
    """A ``.y4m`` upload, which only the port takes: the stream's content
    type, the frame endpoint's PNG (JAX's answers a JPEG); and its
    annotated clip, ``<id>_annotated.mp4`` as in JAX, which the
    annotation-status and annotated routes find and stream as
    ``video/mp4``."""
    port = Session(sides["port"])
    jax = Session(sides["jax"])
    for s in (port, jax):
        s.tokens["admin"] = s.http.post(
            "/api/auth/login", json={"username": "admin",
                                     "password": "testpw"}
        ).json()["access_token"]
    frames = _frames(n=8, h=48, w=64, seed=3)
    up = write_video(Path(sides["port"]["root"]) / "dev", frames, 10,
                     device="cpu").read_bytes()
    vp = port.call("POST", "/api/videos/upload?filename=d.y4m",
                   content=up).json()["video_id"]
    assert jax.call("POST", "/api/videos/upload?filename=d.y4m",
                    content=up).status_code == 422
    vj = jax.call("POST", "/api/videos/upload?filename=d.mp4",
                  content=up).json()["video_id"]
    r = port.http.get(f"/api/videos/{vp}/stream")
    assert r.status_code == 200 and r.content == up
    assert r.headers["content-type"] == tapi.Y4M_TYPE
    r = port.http.get(f"/api/videos/{vp}/frame?frame=5")
    assert r.status_code == 200 and r.headers["content-type"] == "image/png"
    with VideoReader(Path(sides["port"]["root"]) / "videos" / f"{vp}.y4m",
                     device="cpu") as vr:
        want = vr.read_selected([5])[5]
    np.testing.assert_array_equal(_png_decode(r.content), want)
    assert port.http.get(f"/api/videos/{vp}/frame?frame=99").status_code \
        == jax.http.get(f"/api/videos/{vj}/frame?frame=99").status_code \
        == 404
    assert jax.http.get(f"/api/videos/{vj}/frame?frame=5").status_code == 200
    # annotation: the same keys, frame count and file name
    rp = port.call("POST", f"/api/videos/{vp}/annotate")
    rj = jax.call("POST", f"/api/videos/{vj}/annotate")
    assert rp.status_code == rj.status_code == 200
    assert set(rp.json()) == set(rj.json())
    assert rp.json()["frames"] == rj.json()["frames"] == 8
    assert rp.json()["output"].endswith(f"{vp}_annotated.mp4")
    assert rj.json()["output"].endswith(f"{vj}_annotated.mp4")
    st = port.http.get(f"/api/videos/{vp}/annotation-status").json()
    assert st["status"] == "completed"
    r = port.http.get(f"/api/videos/{vp}/annotated")
    assert r.status_code == 200 and r.headers["content-type"] == "video/mp4"
    assert r.content == Path(rp.json()["output"]).read_bytes()
    with VideoReader(Path(rp.json()["output"]), device="cpu") as vr:
        assert vr.info["total_frames"] == 8
    r = port.http.get(f"/api/videos/{vp}/annotated",
                      headers={"Range": "bytes=0-7"})
    assert r.status_code == 206 and r.content[4:8] == b"ftyp"
    assert port.http.get(f"/api/videos/{vp}").json()["has_annotated"]
    r = port.call("DELETE", f"/api/videos/{vp}/annotation")
    assert r.json() == {"deleted": True}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds what the routes do where there is no card")
def test_routes_without_a_device_need_the_card(sides):
    """A context built without a driver decodes and draws on the card
    (``device`` None): with no card, the frame and annotate routes answer
    500 and name it, rather than carrying on on the CPU."""
    port = Session(sides["port"])
    port.tokens["admin"] = port.http.post(
        "/api/auth/login", json={"username": "admin", "password": "testpw"}
    ).json()["access_token"]
    up = write_video(Path(sides["port"]["root"]) / "nodev", _frames(n=4),
                     10, device="cpu").read_bytes()
    vid = port.call("POST", "/api/videos/upload?filename=n.y4m",
                    content=up).json()["video_id"]
    ctx = sides["port"]["ctx"]
    renderer = getattr(ctx, "_renderer", None)
    ctx.device, ctx._renderer = None, None
    try:
        for method, path in (("GET", f"/api/videos/{vid}/frame?frame=1"),
                             ("POST", f"/api/videos/{vid}/annotate")):
            r = port.call(method, path)
            assert r.status_code == 500, path
            assert "no CUDA device" in r.json()["detail"], path
    finally:
        ctx.device, ctx._renderer = "cpu", renderer


def _png_decode(data: bytes) -> np.ndarray:
    """The frame endpoint's PNG (8-bit RGB, filter 0) back to pixels."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", chunk[:8])
            assert chunk[8:10] == b"\x08\x02"
        elif kind == b"IDAT":
            idat += chunk
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_ws_broadcast_matches_jax(sides):
    msgs = {}
    for k in ("jax", "port"):
        base, ctx = sides[k]["base"], sides[k]["ctx"]
        sock = _ws_connect(base, "pipeline")
        _ws_wait(ctx, "pipeline")
        httpx.post(f"{base}/api/pipeline/heartbeat", json={
            "service_name": "graph-heads", "status": "healthy",
            "active_jobs": 0})
        sock.settimeout(5)
        msgs[k] = _norm(json.loads(_ws_read_text(sock)), sides[k]["root"])
        sock.close()
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"]["type"] == "pipeline_status"


def test_static_files_equal_jax():
    want = sorted(p.relative_to(JSTATIC) for p in JSTATIC.rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(TSTATIC) for p in TSTATIC.rglob("*")
                 if p.is_file())
    assert got == want and len(got) == 21
    for rel in got:
        assert (TSTATIC / rel).read_bytes() == (JSTATIC / rel).read_bytes()


def _browser(sides, hash_, login=True):
    from tests.support_browser import Browser
    b = Browser(sides["port"]["base"], module_root=TSTATIC)
    if login:
        b.login("admin", "testpw")
    b.location["hash"] = hash_
    return b


def test_spa_login_flow_on_port(sides):
    b = _browser(sides, "#dashboard", login=False)
    b.boot()
    assert b.by_id("login") is not None
    b.by_id("u").props["value"] = "admin"
    b.by_id("pw").props["value"] = "testpw"
    b.by_id("go").click()
    assert b.storage.get("token")
    assert json.loads(b.storage["user"])["username"] == "admin"
    assert "Sign in" not in b.page_text()


def test_spa_every_page_executes_on_port(sides):
    from lameness_tpu.utils.esinterp import _call
    from test_spa_execution import PAGES
    b = _browser(sides, "#cows")
    mod = b.boot()
    failures = []
    for p in PAGES:
        _call(mod["nav"], [p])
        main = b.by_id("main")
        bad = [e for e in main.query_all(".bad")
               if "panel" in str(e.attrs.get("class", ""))]
        if bad:
            failures.append((p, bad[0].text.strip()[:160]))
        elif len(main.text.strip()) < 10:
            failures.append((p, main.text.strip()))
    assert failures == []
