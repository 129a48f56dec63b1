"""Admin REST API — the reference backend's 12-router surface (port of
``lameness_tpu/serve/api.py``, copied; it serves its own copy of the SPA,
``serve/static/``, byte for byte JAX's).

The port's intermediates are ``.y4m`` (``video/decode.py``), so: uploads
may also be ``.y4m``; the stream, frame, re-trigger and annotation routes
look for ``<id>_cropped.y4m``, ``<id>_canonical.y4m`` and
``<id>_annotated.y4m``; a ``.y4m`` file streams as ``video/x-yuv4mpeg``;
and the frame endpoint answers a PNG (the port has no JPEG encoder: no
OpenCV), decoded by the port's ``VideoReader`` on the context's device (the
driver's; the card without a driver).  Every other route, status code and response key is
JAX's.

Rebuilds ``services/admin-interface/backend`` (SURVEY.md §2.2) over the
stdlib HTTP framework: auth (HMAC tokens, scrypt hashes, RBAC
admin/researcher/rater), videos, analysis, training (pairwise/triplet +
"Lameness Duolingo"), models, shap, pipeline (heartbeats, re-trigger),
health, ml-config, elo (active sampling, hierarchy, steepness), tutorial
(gold tasks), cows — plus the 4 WS broadcast channels.

Route paths mirror the reference mounting (``backend/app/main.py:66-103``):
``/api/{auth,videos,analysis,training,models,shap,pipeline,health,
ml-config,elo,tutorial,cows}`` and ``/api/ws/{pipeline,health,queue,rater}``.
"""
from __future__ import annotations

import json
import random
import re
import shutil
import time
import uuid
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..core.config import Config
from ..hitl import elo as elo_mod
from ..io.db import Database
from ..video.image import encode_png
from .http import (AdminHTTPServer, HTTPError, Request, Router, TokenCodec,
                   WebSocketManager, hash_password, verify_password)

# the upload containers (JAX's, and the port's own .y4m)
VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".y4m")
Y4M_TYPE = "video/x-yuv4mpeg"

PIPELINES = ("yolo", "sam3", "dinov3", "tleap", "tcn", "transformer",
             "gnn", "graph_transformer", "ml", "tracking", "fusion")

# Full editable hyperparameter surface mirroring the reference's pydantic
# config models (routers/ml_config.py:28-135); our GBDT slots keep
# n_estimators/max_depth naming across all three models.
DEFAULT_ML_CONFIG = {
    "catboost": {"n_estimators": 100, "learning_rate": 0.1, "max_depth": 6,
                 "l2_leaf_reg": 3.0, "random_strength": 1.0,
                 "bagging_temperature": 1.0, "border_count": 254,
                 "grow_policy": "SymmetricTree", "bootstrap_type": "MVS",
                 "random_seed": 42},
    "xgboost": {"n_estimators": 100, "learning_rate": 0.1, "max_depth": 6,
                "min_child_weight": 1.0, "gamma": 0.0, "subsample": 1.0,
                "colsample_bytree": 1.0, "colsample_bylevel": 1.0,
                "reg_alpha": 0.0, "reg_lambda": 1.0,
                "scale_pos_weight": 1.0, "booster": "gbtree",
                "tree_method": "hist", "random_state": 42},
    "lightgbm": {"n_estimators": 100, "learning_rate": 0.1, "max_depth": 6,
                 "num_leaves": 31, "min_child_samples": 20,
                 "min_child_weight": 0.001, "subsample": 1.0,
                 "colsample_bytree": 1.0, "reg_alpha": 0.0,
                 "reg_lambda": 0.0, "min_split_gain": 0.0,
                 "boosting_type": "gbdt", "objective": "binary",
                 "random_state": 42},
    "ensemble": {"weights": {"catboost": 0.35, "xgboost": 0.35,
                             "lightgbm": 0.30},
                 "voting_method": "soft", "threshold": 0.5},
    "training": {"cv_folds": 5, "min_new_videos": 10, "min_samples": 10,
                 "test_size": 0.2, "stratify": True, "shuffle": True},
}


def _p(typ, lo, hi, desc, category, options=None):
    d = {"type": typ, "min": lo, "max": hi, "description": desc,
         "category": category}
    if options:
        d["options"] = options
    return d


# routers/ml_config.py:440-710 parameter-descriptions: name/category/range
ML_CONFIG_SCHEMA = {
    "catboost.n_estimators": _p("int", 10, 10000,
                                "Number of boosting iterations", "Training"),
    "catboost.learning_rate": _p("float", 0.001, 1.0,
                                 "Gradient step size", "Training"),
    "catboost.max_depth": _p("int", 1, 16, "Tree depth", "Tree Structure"),
    "catboost.l2_leaf_reg": _p("float", 0.0, 100.0,
                               "L2 regularization coefficient",
                               "Regularization"),
    "catboost.random_strength": _p("float", 0.0, 10.0,
                                   "Randomness for scoring splits",
                                   "Regularization"),
    "catboost.bagging_temperature": _p("float", 0.0, 10.0,
                                       "Bayesian bootstrap intensity",
                                       "Regularization"),
    "catboost.border_count": _p("int", 1, 255,
                                "Splits for numerical features",
                                "Tree Structure"),
    "catboost.grow_policy": _p("str", None, None, "Tree growing policy",
                               "Tree Structure",
                               ["SymmetricTree", "Depthwise", "Lossguide"]),
    "catboost.bootstrap_type": _p("str", None, None,
                                  "Bootstrap sampling method",
                                  "Regularization",
                                  ["Bayesian", "Bernoulli", "MVS", "No"]),
    "catboost.random_seed": _p("int", 0, 2 ** 31 - 1, "Random seed",
                               "Training"),
    "xgboost.n_estimators": _p("int", 10, 10000, "Number of boosting rounds",
                               "Training"),
    "xgboost.learning_rate": _p("float", 0.001, 1.0, "Learning rate (eta)",
                                "Training"),
    "xgboost.max_depth": _p("int", 1, 20, "Maximum tree depth",
                            "Tree Structure"),
    "xgboost.min_child_weight": _p("float", 0.0, 100.0,
                                   "Min sum of instance weight in child",
                                   "Tree Structure"),
    "xgboost.gamma": _p("float", 0.0, 10.0, "Min loss reduction for split",
                        "Regularization"),
    "xgboost.subsample": _p("float", 0.1, 1.0,
                            "Subsample ratio of training data", "Sampling"),
    "xgboost.colsample_bytree": _p("float", 0.1, 1.0,
                                   "Column subsample per tree", "Sampling"),
    "xgboost.colsample_bylevel": _p("float", 0.1, 1.0,
                                    "Column subsample per level", "Sampling"),
    "xgboost.reg_alpha": _p("float", 0.0, 100.0, "L1 regularization",
                            "Regularization"),
    "xgboost.reg_lambda": _p("float", 0.0, 100.0, "L2 regularization",
                             "Regularization"),
    "xgboost.scale_pos_weight": _p("float", 0.1, 100.0,
                                   "Positive/negative weight balance",
                                   "Training"),
    "xgboost.booster": _p("str", None, None, "Booster type", "Training",
                          ["gbtree", "gblinear", "dart"]),
    "xgboost.tree_method": _p("str", None, None, "Tree method", "Training",
                              ["auto", "exact", "approx", "hist"]),
    "xgboost.random_state": _p("int", 0, 2 ** 31 - 1, "Random seed",
                               "Training"),
    "lightgbm.n_estimators": _p("int", 10, 10000,
                                "Number of boosting iterations", "Training"),
    "lightgbm.learning_rate": _p("float", 0.001, 1.0, "Learning rate",
                                 "Training"),
    "lightgbm.max_depth": _p("int", -1, 20, "Max tree depth (-1 = none)",
                             "Tree Structure"),
    "lightgbm.num_leaves": _p("int", 2, 131072, "Maximum number of leaves",
                              "Tree Structure"),
    "lightgbm.min_child_samples": _p("int", 1, 1000, "Min samples in leaf",
                                     "Tree Structure"),
    "lightgbm.min_child_weight": _p("float", 0.0, 100.0,
                                    "Min sum of hessian in leaf",
                                    "Tree Structure"),
    "lightgbm.subsample": _p("float", 0.1, 1.0,
                             "Subsample ratio of training data", "Sampling"),
    "lightgbm.colsample_bytree": _p("float", 0.1, 1.0,
                                    "Column subsample per tree", "Sampling"),
    "lightgbm.reg_alpha": _p("float", 0.0, 100.0, "L1 regularization",
                             "Regularization"),
    "lightgbm.reg_lambda": _p("float", 0.0, 100.0, "L2 regularization",
                              "Regularization"),
    "lightgbm.min_split_gain": _p("float", 0.0, 10.0,
                                  "Min gain to make a split",
                                  "Regularization"),
    "lightgbm.boosting_type": _p("str", None, None, "Boosting type",
                                 "Training", ["gbdt", "dart", "goss", "rf"]),
    "lightgbm.objective": _p("str", None, None, "Objective function",
                             "Training", ["binary"]),
    "lightgbm.random_state": _p("int", 0, 2 ** 31 - 1, "Random seed",
                                "Training"),
    "ensemble.weights": {"type": "dict",
                         "description": "Per-model ensemble weights",
                         "category": "Ensemble"},
    "ensemble.voting_method": _p("str", None, None,
                                 "soft (probability) or hard (class) voting",
                                 "Ensemble", ["soft", "hard"]),
    "ensemble.threshold": _p("float", 0.0, 1.0,
                             "Classification threshold", "Ensemble"),
    "training.cv_folds": _p("int", 2, 20, "Stratified CV folds", "Training"),
    "training.min_new_videos": _p("int", 1, 1000,
                                  "New labeled videos before auto-retrain",
                                  "Training"),
    "training.min_samples": _p("int", 2, 1000,
                               "Minimum samples to start training",
                               "Training"),
    "training.test_size": _p("float", 0.1, 0.5, "Test set ratio",
                             "Training"),
    "training.stratify": _p("bool", None, None, "Use stratified splits",
                            "Training"),
    "training.shuffle": _p("bool", None, None,
                           "Shuffle data before splitting", "Training"),
}


class AdminContext:
    """Shared state behind the API."""

    def __init__(self, config: Config, db: Database, bus,
                 reliability=None, ensemble=None, shap_service=None,
                 llm_service=None, driver=None, store=None):
        self.config = config
        self.dirs = config.dirs
        self.db = db
        self.bus = bus
        self.reliability = reliability
        self.ensemble = ensemble
        self.shap_service = shap_service
        self.llm_service = llm_service
        self.driver = driver
        self.store = store
        # where the frame and annotation routes decode and draw: the
        # driver's device; None is the card
        self.device = driver.device if driver is not None else None
        self.tokens = TokenCodec()
        self.ws = WebSocketManager()
        self.start_time = time.time()
        self.ml_config_path = self.dirs.root and \
            Path(self.dirs.root) / "ml_config.json"

    # -- helpers -------------------------------------------------------------
    def read_result(self, pipeline: str, video_id: str) -> Optional[Dict]:
        f = self.dirs.results_for(pipeline) / f"{video_id}_{pipeline}.json"
        if f.exists():
            try:
                return json.load(open(f))
            except Exception:
                return None
        return None

    def ml_config(self) -> Dict[str, Any]:
        if self.ml_config_path and Path(self.ml_config_path).exists():
            try:
                return json.load(open(self.ml_config_path))
            except Exception:
                pass
        return json.loads(json.dumps(DEFAULT_ML_CONFIG))

    def save_ml_config(self, cfg: Dict[str, Any]) -> None:
        # atomic: the training service reads this file mid-save
        from ..io import schemas
        schemas.write_result(Path(self.ml_config_path), cfg)

    def seed_users(self, password: str | None = None) -> None:
        """Default admin/researcher/rater accounts (backend main.py:117-190).

        Unlike the reference's fixed '<user>123' passwords, each missing
        account gets a random password printed ONCE at creation (pass an
        explicit ``password`` only in tests). Existing users are never
        touched.
        """
        import secrets
        for username, role in (("admin", "admin"), ("researcher", "researcher"),
                               ("rater", "rater")):
            if self.db.one("SELECT id FROM users WHERE username=?",
                           (username,)) is None:
                pw = password or secrets.token_urlsafe(12)
                self.db.insert("users", {
                    "email": f"{username}@lameness.local",
                    "username": username,
                    "password_hash": hash_password(pw),
                    "role": role, "is_active": 1,
                    "created_at": datetime.now(timezone.utc).isoformat()})
                if password is None:
                    print(f"seeded user '{username}' (role={role}) with "
                          f"initial password: {pw}", flush=True)


def _now():
    return datetime.now(timezone.utc).isoformat()


def _qint(req: Request, key: str, default: int) -> int:
    """Integer query param with FastAPI-style validation: a non-integer
    value is a client error (the reference returns 422 from pydantic
    validation), not a 500 from a bare int() ValueError."""
    raw = req.query.get(key, default)
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise HTTPError(422, f"query param {key!r} must be an integer, "
                             f"got {raw!r}")


def build_admin_api(ctx: AdminContext) -> Router:
    r = Router()
    db = ctx.db
    dirs = ctx.dirs

    # ============================ auth ====================================
    @r.post("/api/auth/register")
    def register(req: Request):
        b = req.body or {}
        for k in ("email", "username", "password"):
            if not b.get(k):
                raise HTTPError(422, f"missing {k}")
        if db.one("SELECT id FROM users WHERE username=? OR email=?",
                  (b["username"], b["email"])):
            raise HTTPError(409, "user exists")
        # self-registration is rater-only (routers/auth.py restricts the
        # role likewise); privileged roles only via admin PATCH /users/{id}
        if b.get("role", "rater") != "rater":
            raise HTTPError(403, "self-registration is rater-only")
        uid = db.insert("users", {
            "email": b["email"], "username": b["username"],
            "password_hash": hash_password(b["password"]),
            "role": "rater", "is_active": 1})
        return {"id": uid, "username": b["username"], "role": "rater"}

    def _issue(user):
        token = ctx.tokens.encode({"sub": user["id"],
                                   "username": user["username"],
                                   "role": user["role"]})
        db.update("users", user["id"], {"last_login": _now()})
        return {"access_token": token, "token_type": "bearer",
                "user": {"id": user["id"], "username": user["username"],
                         "role": user["role"],
                         "rater_tier": user.get("rater_tier")}}

    @r.post("/api/auth/login")
    def login(req: Request):
        b = req.body or {}
        user = db.one("SELECT * FROM users WHERE username=?",
                      (b.get("username", ""),))
        if not user or not user["is_active"] or \
                not verify_password(b.get("password", ""),
                                    user["password_hash"]):
            raise HTTPError(401, "invalid credentials")
        return _issue(user)

    @r.post("/api/auth/logout", auth=True)
    def logout(req: Request):
        # reference returns {message} (auth.py logout)
        return {"status": "logged_out",
                "message": "Successfully logged out"}

    @r.post("/api/auth/refresh", auth=True)
    def refresh(req: Request):
        user = db.one("SELECT * FROM users WHERE id=?", (req.user["sub"],))
        if not user:
            raise HTTPError(401, "unknown user")
        return _issue(user)

    @r.get("/api/auth/me", auth=True)
    def me(req: Request):
        user = db.one("SELECT id, email, username, role, rater_tier, "
                      "is_active, created_at, last_login FROM users "
                      "WHERE id=?", (req.user["sub"],))
        if not user:
            raise HTTPError(404, "user not found")
        return user

    @r.get("/api/auth/users", roles=["admin"])
    def list_users(req: Request):
        return db.query("SELECT id, email, username, role, rater_tier, "
                        "is_active, created_at, last_login FROM users")

    @r.patch("/api/auth/users/{user_id}", roles=["admin"])
    def patch_user(req: Request):
        allowed = {k: v for k, v in (req.body or {}).items()
                   if k in ("role", "is_active", "rater_tier")}
        if not allowed:
            raise HTTPError(422, "nothing to update")
        if "role" in allowed and allowed["role"] not in (
                "admin", "researcher", "rater"):
            raise HTTPError(422, "invalid role")
        if allowed.get("rater_tier") is not None and \
                allowed["rater_tier"] not in ("gold", "silver", "bronze"):
            # an unknown tier would silently weigh as silver in
            # _rater_weight — same gate as the create path
            raise HTTPError(422, "invalid rater_tier")
        db.update("users", req.params["user_id"], allowed)
        return db.one("SELECT id, username, role, rater_tier, is_active "
                      "FROM users WHERE id=?", (req.params["user_id"],))

    # ============================ videos ==================================
    @r.post("/api/videos/upload")
    def upload_video(req: Request):
        """Local upload path (routers/videos.py:293): raw bytes body with
        ?filename=; ingests through the driver when present."""
        filename = req.query.get("filename", "upload.mp4")
        ext = Path(filename).suffix.lower()
        if ext not in VIDEO_SUFFIXES:
            raise HTTPError(422, f"unsupported extension {ext}")
        video_id = str(uuid.uuid4())
        dest = dirs.videos / f"{video_id}{ext}"
        dest.parent.mkdir(parents=True, exist_ok=True)
        with open(dest, "wb") as f:
            f.write(req.raw or b"")
        db.insert("videos", {
            "id": video_id, "filename": dest.name,
            "original_filename": filename,
            "file_size": len(req.raw or b""), "file_path": str(dest),
            "status": "uploaded", "uploaded_at": _now()})
        ctx.bus.publish_sync(ctx.config.subjects.video_uploaded, {
            "video_id": video_id, "filename": filename, "path": str(dest),
            "uploaded_at": _now()})
        return {"video_id": video_id, "filename": filename}

    def _video_item(row: dict) -> dict:
        """Reference list-item shape (routers/videos.py list_videos) as a
        SUPERSET of our row (internal clients keep `id` etc.)."""
        out = dict(row)
        out.update({
            "video_id": row["id"],
            "storage": row.get("storage_backend") or "local",
            "s3_key": row.get("s3_key"),
            "has_label": row.get("label") is not None,
            "has_analysis": bool(row.get("has_analysis")),
            "has_annotated": bool(row.get("has_annotated")),
        })
        return out

    @r.get("/api/videos")
    def list_videos(req: Request):
        """{videos, total, skip, limit} envelope
        (routers/videos.py::list_videos response shape)."""
        where = ""
        params: tuple = ()
        clauses = []
        if "status" in req.query:
            clauses.append("status=?")
            params += (req.query["status"],)
        if "label" in req.query:
            clauses.append("label=?")
            params += (_qint(req, "label", 0),)
        if clauses:
            where = " WHERE " + " AND ".join(clauses)
        total = db.one("SELECT COUNT(*) AS n FROM videos" + where,
                       params)["n"]
        skip = _qint(req, "skip", 0)
        limit = _qint(req, "limit", 100)
        rows = db.query("SELECT * FROM videos" + where +
                        " ORDER BY uploaded_at DESC LIMIT ? OFFSET ?",
                        params + (limit, skip))
        return {"videos": [_video_item(v) for v in rows],
                "total": total, "skip": skip, "limit": limit}

    @r.get("/api/videos/{video_id}")
    def get_video(req: Request):
        """Reference detail shape (routers/videos.py::get_video): adds
        video_id / stream_url / storage / metadata{...} over our row."""
        vid = req.params["video_id"]
        row = db.one("SELECT * FROM videos WHERE id=?", (vid,))
        if not row:
            raise HTTPError(404, "video not found")
        out = _video_item(row)
        fusion = dirs.results_for("fusion") / f"{vid}_fusion.json"
        out["has_analysis"] = out["has_analysis"] or fusion.exists()
        annotated = Path(dirs.root) / "annotated" / f"{vid}_annotated.y4m"
        out["has_annotated"] = out["has_annotated"] or annotated.exists()
        out["stream_url"] = f"/api/videos/{vid}/stream" \
            if row.get("file_path") else None
        out["processed_at"] = row.get("processed_at")
        out["metadata"] = {
            "fps": row.get("fps"), "frame_count": row.get("frame_count"),
            "width": row.get("width"), "height": row.get("height"),
            "duration": row.get("duration")}
        return out

    def _stream_file(req: Request, f: Path, ctype: str = "video/mp4"):
        """Whole-file or RFC 7233 single-range response — browsers need
        206 + Content-Range for video seeking (the reference's
        FileResponse honors ranges).  A ``.y4m`` file is ``Y4M_TYPE``."""
        if f.suffix.lower() == ".y4m":
            ctype = Y4M_TYPE
        size = f.stat().st_size
        rng = req.headers.get("Range") or req.headers.get("range")
        m = re.match(r"bytes=(\d*)-(\d*)$", rng.strip()) if rng else None
        if not m:
            return (200, f.read_bytes(), ctype,
                    {"Accept-Ranges": "bytes"})
        start = int(m.group(1)) if m.group(1) else None
        end = int(m.group(2)) if m.group(2) else None
        if start is None:                  # suffix range: last N bytes
            start = max(0, size - (end or 0))
            end = size - 1
        else:
            end = min(end if end is not None else size - 1, size - 1)
        if start > end or start >= size:
            return (416, b"", ctype, {"Content-Range": f"bytes */{size}"})
        with open(f, "rb") as fh:
            fh.seek(start)
            chunk = fh.read(end - start + 1)
        return (206, chunk, ctype,
                {"Accept-Ranges": "bytes",
                 "Content-Range": f"bytes {start}-{end}/{size}"})

    @r.get("/api/videos/{video_id}/stream")
    def stream_video(req: Request):
        vid = req.params["video_id"]
        matches = list(dirs.videos.glob(f"{vid}.*")) + \
            list(dirs.processed.glob(f"{vid}_cropped.y4m")) + \
            list(dirs.canonical.glob(f"{vid}_canonical.y4m"))
        if not matches:
            raise HTTPError(404, "video file not found")
        return _stream_file(req, matches[0])

    @r.get("/api/videos/{video_id}/detections")
    def video_detections(req: Request):
        res = ctx.read_result("yolo", req.params["video_id"])
        if res is None:
            raise HTTPError(404, "no detections")
        return res

    @r.get("/api/videos/{video_id}/pose")
    def video_pose(req: Request):
        res = ctx.read_result("tleap", req.params["video_id"])
        if res is None:
            raise HTTPError(404, "no pose results")
        return res

    @r.get("/api/videos/{video_id}/frame")
    def extract_frame(req: Request):
        """Frame extraction endpoint (routers/videos.py:507): the frame
        at the requested index, as a PNG."""
        from ..core.device import resolve_device
        from ..video.decode import VideoReader
        vid = req.params["video_id"]
        frame_idx = _qint(req, "frame", 0)
        matches = (list(dirs.processed.glob(f"{vid}_cropped.y4m"))
                   + list(dirs.videos.glob(f"{vid}.*")))
        if not matches:
            raise HTTPError(404, "video file not found")
        device = resolve_device(ctx.device)   # no card raises, not a 404
        try:
            with VideoReader(matches[0], device=device) as vr:
                frame = vr.read_selected([frame_idx]).get(frame_idx)
        except (OSError, RuntimeError, ValueError):   # unreadable
            frame = None
        if frame is None:
            raise HTTPError(404, f"frame {frame_idx} not readable")
        return (200, encode_png(frame), "image/png")

    @r.post("/api/videos/{video_id}/annotate", auth=True)
    def annotate_video(req: Request):
        """Trigger annotated-video rendering (routers/videos.py:545)."""
        from .annotation import AnnotationRenderer
        renderer = getattr(ctx, "_renderer", None)
        if renderer is None:
            renderer = AnnotationRenderer(dirs, device=ctx.device)
            ctx._renderer = renderer
        out = renderer.render(req.params["video_id"])
        status = renderer.status.get(req.params["video_id"], {})
        if out is None:
            raise HTTPError(404, status.get("error", "render failed"))
        if db.one("SELECT id FROM videos WHERE id=?",
                  (req.params["video_id"],)):
            db.update("videos", req.params["video_id"], {"has_annotated": 1})
        return status

    @r.get("/api/videos/{video_id}/annotated")
    def stream_annotated(req: Request):
        f = Path(dirs.root) / "annotated" / \
            f"{req.params['video_id']}_annotated.y4m"
        if not f.exists():
            raise HTTPError(404, "not rendered yet")
        return _stream_file(req, f)

    @r.post("/api/videos/{video_id}/label", auth=True)
    def label_video(req: Request):
        b = req.body or {}
        label = b.get("label")
        if label not in (0, 1):
            raise HTTPError(422, "label must be 0 or 1")
        vid = req.params["video_id"]
        if db.one("SELECT id FROM videos WHERE id=?", (vid,)):
            db.update("videos", vid, {
                "label": label,
                "label_confidence": b.get("confidence", "certain")})
        from ..io import schemas
        schemas.write_result(      # atomic: training scans these live
            dirs.training / "labels" / f"{vid}_label.json",
            {"label": label, "confidence": b.get("confidence", "certain"),
             "labeled_at": _now()})
        ctx.bus.publish_sync(ctx.config.subjects.training_data_added, {
            "video_id": vid, "label": label})
        # reference shape (training.py label_video: {status, video_id,
        # label})
        return {"status": "labeled", "video_id": vid, "label": label}

    @r.post("/api/videos/upload-url")
    def upload_url(req: Request):
        """S3-presign flow (routers/videos.py:124-291).  With local storage
        the 'presigned URL' is the local upload endpoint; with boto3 + a
        bucket configured it would presign — keeping the 3-call contract."""
        b = req.body or {}
        filename = b.get("filename", "upload.mp4")
        video_id = str(uuid.uuid4())
        # reference presign shape (videos.py: {video_id, upload_url,
        # s3_key, upload_fields, expires_in}); local backend keeps the
        # 3-call contract with empty POST fields
        return {"video_id": video_id,
                "upload_url": f"/api/videos/upload?filename={filename}"
                              f"&video_id={video_id}",
                "s3_key": f"videos/{video_id}/{filename}",
                "upload_fields": {},
                "storage_backend": "local",
                "expires_in": 3600}

    @r.post("/api/videos/{video_id}/confirm-upload")
    def confirm_upload(req: Request):
        matches = list(dirs.videos.glob(f"{req.params['video_id']}.*"))
        if not matches:
            raise HTTPError(404, "upload not found")
        return {"video_id": req.params["video_id"], "status": "confirmed",
                "file_size": matches[0].stat().st_size}

    @r.get("/api/videos/{video_id}/stream-url")
    def stream_url(req: Request):
        """routers/videos.py::get_stream_url local-backend shape
        (+ legacy url/storage_backend keys for our own clients)."""
        vid = req.params["video_id"]
        return {"video_id": vid,
                "stream_url": f"/api/videos/{vid}/stream",
                "source": "local",
                "url": f"/api/videos/{vid}/stream",
                "storage_backend": "local"}

    @r.post("/api/videos/migrate-to-db", roles=["admin"])
    def migrate_to_db(req: Request):
        """Backfill DB rows for video files on disk (routers/videos.py:783)."""
        added = 0
        for f in dirs.videos.iterdir():
            if f.suffix.lower() not in VIDEO_SUFFIXES:
                continue
            vid = f.stem
            if db.one("SELECT id FROM videos WHERE id=?", (vid,)):
                continue
            db.insert("videos", {"id": vid, "filename": f.name,
                                 "file_size": f.stat().st_size,
                                 "file_path": str(f), "status": "uploaded",
                                 "uploaded_at": _now()})
            added += 1
        return {"migrated": added}

    # ============================ analysis ================================
    @r.get("/api/analysis/{video_id}")
    def analysis_all(req: Request):
        """Reference shape (routers/analysis.py::get_analysis):
        {video_id, fusion, pipelines} — plus each pipeline's raw result
        at top level for our own legacy clients (names never collide
        with the envelope keys)."""
        vid = req.params["video_id"]
        out = {}
        for p in PIPELINES:
            res = ctx.read_result(p, vid)
            if res is not None:
                out[p] = res
        if not out:
            raise HTTPError(404, "no analysis results")
        fusion = out.get("fusion") or {}
        out["video_id"] = vid
        out["fusion"] = fusion.get("fusion_result", fusion)
        out["pipelines"] = {p: out[p] for p in PIPELINES if p in out
                            and p != "fusion"}
        return out

    def _graph_transformer_envelope(vid, data):
        """analysis.py:118-140 defaulted Graphormer envelope over the raw
        result file (shared by the canonical and reference-alias routes)."""
        out = dict(data)
        out.update({
            "video_id": vid, "pipeline": "graph_transformer",
            "model": data.get("model", "CowLamenessGraphormer"),
            "graph_prediction": data.get("graph_prediction", 0.5),
            "node_prediction": data.get("node_prediction", 0.5),
            "uncertainty": data.get("uncertainty", 0.0),
            "prediction": data.get("prediction", 0),
            "confidence": data.get("confidence", 0.5),
            "graph_info": data.get("graph_info", {}),
            "attention_info": data.get("attention_info", {})})
        return out

    @r.get("/api/analysis/{video_id}/{pipeline}")
    def analysis_one(req: Request):
        p = req.params["pipeline"]
        if p not in PIPELINES:
            raise HTTPError(422, f"unknown pipeline {p}")
        vid = req.params["video_id"]
        res = ctx.read_result(p, vid)
        if res is None:
            raise HTTPError(404, "no result")
        if p == "graph_transformer":
            res = _graph_transformer_envelope(vid, res)
        return res

    @r.get("/api/analysis/{video_id}/explanation/get")
    def get_explanation(req: Request):
        vid = req.params["video_id"]
        f = dirs.results / "explanations" / f"{vid}_explanation.json"
        if not f.exists():
            raise HTTPError(404, "no explanation")
        return json.load(open(f))

    @r.post("/api/analysis/{video_id}/explanation/generate")
    def gen_explanation(req: Request):
        vid = req.params["video_id"]
        fusion = ctx.read_result("fusion", vid)
        if fusion is None:
            raise HTTPError(404, "no fusion result to explain")
        shap_file = dirs.results / "shap" / f"{vid}_shap.json"
        shap_data = json.load(open(shap_file)) if shap_file.exists() else None
        if ctx.llm_service is None:
            # reference semantics (analysis.py:299-313): the request is an
            # ack — generation is the llm service's job, triggered on the
            # bus on its own subject (analysis.complete subscribers treat
            # messages as FINISHED analyses; a request must not look like
            # one)
            ctx.bus.publish_sync(ctx.config.subjects.explanation_requested,
                                 {"video_id": vid})
            return {"video_id": vid, "status": "requested",
                    "message": "Explanation generation requested. "
                               "Check back shortly."}
        out = ctx.llm_service.explain(vid, fusion.get("fusion_result", {}),
                                      shap_data)
        out.setdefault("video_id", vid)
        out.setdefault("status", "generated")
        out.setdefault("message", "explanation generated inline")
        return out

    # ============================ training ================================
    @r.get("/api/training/stats")
    def training_stats(req: Request):
        labels_dir = dirs.training / "labels"
        labeled = list(labels_dir.glob("*_label.json")) \
            if labels_dir.exists() else []
        lame = sound = 0
        for f in labeled:
            try:
                lab = json.load(open(f)).get("label")
                lame += lab == 1
                sound += lab == 0
            except Exception:
                pass
        comps = db.query("SELECT COUNT(*) n FROM pairwise_comparisons")
        return {"total_labeled": len(labeled), "lame": lame, "sound": sound,
                # reference key spellings (routers/training.py:138-146)
                "total_labels": len(labeled), "sound_count": sound,
                "lame_count": lame,
                "balance_ratio": sound / lame if lame else None,
                "ready_for_training": len(labeled) >= 10 and sound > 0
                and lame > 0,
                "pairwise_comparisons": comps[0]["n"],
                "min_new_videos": ctx.config.ml.min_new_videos}

    def _label_queue() -> Dict[str, Any]:
        """Active-learning queue: unlabeled videos with fusion results,
        most uncertain (|p-0.5| smallest) first (routers/training.py:80-114)."""
        labels_dir = dirs.training / "labels"
        out = []
        fdir = dirs.results_for("fusion")
        if fdir.exists():
            for f in fdir.glob("*_fusion.json"):
                vid = f.stem[:-len("_fusion")]
                if (labels_dir / f"{vid}_label.json").exists():
                    continue
                try:
                    fr = json.load(open(f)).get("fusion_result", {})
                except Exception:
                    continue
                p = fr.get("final_probability", 0.5)
                out.append({"video_id": vid, "predicted_probability": p,
                            "uncertainty": abs(0.5 - (p or 0.5))})
        out.sort(key=lambda v: v["uncertainty"])
        return {"videos": out[:50], "total": len(out)}

    @r.get("/api/training/label-queue")
    def training_label_queue(req: Request):
        return _label_queue()

    @r.get("/api/training/status")
    def training_status(req: Request):
        """Reference default shape merged under any saved status file
        (routers/training.py:148-167)."""
        out = {"status": "idle", "last_trained": None, "samples_used": 0,
               "metrics": {}, "models": []}
        p = dirs.training / "training_status.json"
        if p.exists():
            try:
                out.update(json.load(open(p)))
            except Exception:
                pass
        return out

    @r.post("/api/training/start/ml", roles=["admin", "researcher"])
    def start_ml_training(req: Request):
        ctx.bus.publish_sync(ctx.config.subjects.training_ml_requested,
                             {"requested_by": req.user["username"],
                              "requested_at": _now()})
        return {"status": "requested"}

    @r.post("/api/training/start/yolo", roles=["admin", "researcher"])
    def start_yolo_training(req: Request):
        ctx.bus.publish_sync(ctx.config.subjects.training_yolo_requested,
                             {"requested_by": req.user["username"],
                              "requested_at": _now()})
        return {"status": "requested"}

    def _pair_progress(username: str = None):
        """(total_pairs, completed_pairs, user_completed) over the known
        video set — the reference's next-pair/stats bookkeeping
        (routers/elo_ranking.py get_next_pair)."""
        n_vids = db.one("SELECT COUNT(*) n FROM videos")["n"]
        total = n_vids * (n_vids - 1) // 2
        uniq = db.one(
            "SELECT COUNT(DISTINCT CASE WHEN video_id_1 < video_id_2 "
            "THEN video_id_1 || '|' || video_id_2 "
            "ELSE video_id_2 || '|' || video_id_1 END) n "
            "FROM pairwise_comparisons")["n"]
        user_done = None
        if username:
            user_done = db.one(
                "SELECT COUNT(DISTINCT CASE WHEN video_id_1 < video_id_2 "
                "THEN video_id_1 || '|' || video_id_2 "
                "ELSE video_id_2 || '|' || video_id_1 END) n "
                "FROM pairwise_comparisons pc JOIN users u "
                "ON pc.rater_id = u.id WHERE u.username=?",
                (username,))["n"]
        return total, uniq, user_done

    # -- pairwise (routers/training.py:242-457 via elo router submit) -------
    @r.get("/api/training/pairwise/next", auth=True)
    def pairwise_next(req: Request):
        ratings = {row["video_id"]: row["elo_rating"] for row in
                   db.query("SELECT * FROM video_elo_ratings")}
        unc = {row["video_id"]: row["elo_uncertainty"] for row in
               db.query("SELECT * FROM video_elo_ratings")}
        vids = [v["id"] for v in db.query(
            "SELECT id FROM videos ORDER BY uploaded_at DESC LIMIT 200")]
        for v in vids:
            ratings.setdefault(v, elo_mod.INITIAL_ELO)
            unc.setdefault(v, elo_mod.INITIAL_UNCERTAINTY)
        if len(ratings) < 2:
            raise HTTPError(404, "not enough videos for a pair")
        a, b = elo_mod.active_next_pair(ratings, unc,
                                        np.random.default_rng())
        total, done, user_done = _pair_progress(req.user["username"])
        return {"video_id_1": a, "video_id_2": b,
                "strategy": "active_sampling_70_30",
                # reference get_next_pair progress keys
                "total_pairs": total, "completed_pairs": done,
                "pending_pairs": max(0, total - done),
                "global_completed": done, "user_completed": user_done,
                "user_id": str(req.user["sub"])}

    @r.get("/api/training/pairwise/ranking")
    def pairwise_ranking(req: Request):
        """{ranking, total_videos, total_comparisons} envelope
        (routers/training.py pairwise ranking shape)."""
        rows = db.query("SELECT video_id, elo_rating, elo_uncertainty, "
                        "wins, losses, ties, total_comparisons, "
                        "normalized_score, rank_position "
                        "FROM video_elo_ratings ORDER BY elo_rating DESC")
        comps = db.one("SELECT COUNT(*) n FROM pairwise_comparisons")["n"]
        return {"ranking": rows, "total_videos": len(rows),
                "total_comparisons": comps}

    # -- triplets (routers/training.py:459-650) ------------------------------
    def _completed_triplets(username: str) -> set:
        p = dirs.training / "triplets" / "triplets.jsonl"
        done = set()
        if p.exists():
            for line in open(p):
                try:
                    rec = json.loads(line)
                    if rec.get("rater") == username:
                        done.add((rec["reference"],
                                  tuple(sorted((rec["option_a"],
                                                rec["option_b"])))))
                except Exception:
                    continue
        return done

    @r.get("/api/training/triplet/next", auth=True)
    def triplet_next(req: Request):
        """Full ref×(A,B) enumeration minus this rater's completed triplets,
        random task type, position swap (routers/training.py:459-539)."""
        vids = [v["id"] for v in db.query(
            "SELECT id FROM videos ORDER BY uploaded_at DESC LIMIT 60")]
        if len(vids) < 3:
            raise HTTPError(404, "not enough videos for a triplet")
        done = _completed_triplets(req.user["username"])
        candidates = []
        for ref in vids:
            others = [v for v in vids if v != ref]
            for i in range(len(others)):
                for j in range(i + 1, len(others)):
                    key = (ref, tuple(sorted((others[i], others[j]))))
                    if key not in done:
                        candidates.append((ref, others[i], others[j]))
        if not candidates:
            raise HTTPError(404, "all triplets completed")
        ref, a, b = candidates[random.randrange(len(candidates))]
        task_type = random.choice(["similarity", "dissimilarity"])
        pair = [a, b]
        random.shuffle(pair)
        total = len(candidates) + len(done)
        return {"reference": ref, "option_a": pair[0], "option_b": pair[1],
                "task_type": task_type,
                "remaining": len(candidates),
                # reference triplet progress keys (routers/training.py)
                "pending_tasks": len(candidates), "total_tasks": total}

    @r.post("/api/training/triplet/submit", auth=True)
    def triplet_submit(req: Request):
        """Accepts BOTH our field names (reference/option_a/option_b/
        choice) and the reference's TripletComparisonRequest
        (reference_id/comparison_a_id/comparison_b_id/selected_answer,
        training.py:450-456); returns the reference's {status,
        triplet_key, total_comparisons} (training.py:581-585)."""
        b = req.body or {}
        ref = b.get("reference") or b.get("reference_id")
        a = b.get("option_a") or b.get("comparison_a_id")
        opt_b = b.get("option_b") or b.get("comparison_b_id")
        choice = b.get("choice") or \
            str(b.get("selected_answer", "")).lower()
        if not ref or not a or not opt_b:
            raise HTTPError(422, "reference + two comparison ids required")
        out_dir = dirs.training / "triplets"
        out_dir.mkdir(parents=True, exist_ok=True)
        rec = {"reference": ref, "option_a": a, "option_b": opt_b,
               "choice": choice, "task_type": b.get("task_type"),
               "confidence": b.get("confidence", "medium"),
               "rater": req.user["username"], "submitted_at": _now()}
        with open(out_dir / "triplets.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        lo, hi = sorted((a, opt_b))
        key = f"{ref}_{lo}_{hi}"
        # exact-field count (like triplet_stats): substring matching over
        # raw lines overcounts when one video id is a prefix of another
        # or appears in a different field (rater, task_type)
        n = 0
        for line in open(out_dir / "triplets.jsonl"):
            try:
                r_ = json.loads(line)
                match = r_.get("reference") == ref and sorted(
                    (r_.get("option_a") or "",
                     r_.get("option_b") or "")) == [lo, hi]
            except Exception:      # malformed/foreign lines never 500
                continue
            if match:
                n += 1
        return {"status": "saved", "triplet_key": key,
                "total_comparisons": n}

    @r.get("/api/training/triplet/stats")
    def triplet_stats(req: Request):
        """Reference triplet-stats keys (routers/training.py): task-type
        split + completion rate over the enumeration."""
        p = dirs.training / "triplets" / "triplets.jsonl"
        recs = []
        if p.exists():
            for line in open(p):
                try:
                    recs.append(json.loads(line))
                except Exception:
                    continue
        n_vids = db.one("SELECT COUNT(*) n FROM videos")["n"]
        # every video as reference against each unordered pair of others
        total = n_vids * (n_vids - 1) * (n_vids - 2) // 2 \
            if n_vids >= 3 else 0
        uniq = {(r.get("reference"),
                 tuple(sorted((r.get("option_a"), r.get("option_b")))))
                for r in recs}
        sim = sum(1 for r in recs if r.get("task_type") == "similarity")
        return {"total_triplets": len(recs),
                "total_comparisons": len(recs),
                "total_tasks": total,
                "completed_tasks": len(uniq),
                "completion_rate": len(uniq) / total if total else 0.0,
                "similarity_tasks": sim,
                "dissimilarity_tasks": len(recs) - sim}

    # -- learn ("Lameness Duolingo", routers/training.py:652-814) -----------
    @r.get("/api/training/learn/progress", auth=True)
    def learn_progress(req: Request):
        user = req.user["username"]
        comps = db.query(
            "SELECT COUNT(*) n FROM pairwise_comparisons pc "
            "JOIN users u ON pc.rater_id = u.id WHERE u.username=?", (user,))
        stats = None
        if ctx.reliability:
            stats = ctx.reliability.rater_stats.get(user)
        saved: Dict[str, Any] = {}
        prog_f = Path(dirs.training) / "learn_progress" / \
            f"{req.user['sub']}.json"
        if prog_f.exists():
            try:
                saved = json.load(open(prog_f))
            except Exception:
                pass
        level = saved.get("current_level", min(10, comps[0]["n"] // 10 + 1))
        tier = stats.tier if stats else "bronze"
        return {"username": user, "comparisons": comps[0]["n"],
                "tier": tier,
                "gold_accuracy": stats.gold_task_accuracy if stats else None,
                "level": level,
                "modules_completed": saved.get("modules_completed", []),
                # quiz-game persistence (TrainingModule.tsx score model)
                "total_score": saved.get("total_score", 0),
                "streak": saved.get("streak", 0),
                "total_attempts": saved.get("total_attempts", 0),
                "correct_count": saved.get("correct_count", 0),
                # reference learn-progress keys (routers/training.py)
                "user_id": str(req.user["sub"]),
                "rater_tier": tier,
                "current_level": level,
                "updated_at": saved.get("updated_at")}

    @r.get("/api/training/learn/leaderboard")
    def leaderboard(req: Request):
        """{leaderboard, total_users} envelope (routers/training.py)."""
        rows = db.query(
            "SELECT u.username, COUNT(pc.id) n FROM users u "
            "LEFT JOIN pairwise_comparisons pc ON pc.rater_id = u.id "
            "GROUP BY u.username ORDER BY n DESC LIMIT 20")
        total = db.one("SELECT COUNT(*) n FROM users")["n"]
        return {"leaderboard": rows, "total_users": total}

    @r.get("/api/training/learn/examples", auth=True)
    def learn_examples(req: Request):
        """Worked examples for rater education (routers/training.py:652-814):
        gold tasks with known labels, plus the strongest fused predictions
        as lame/sound exemplars."""
        examples = []
        if ctx.reliability:
            for vid, label in list(ctx.reliability.gold_tasks.items())[:10]:
                examples.append({"video_id": vid, "source": "gold_task",
                                 "label": "lame" if label else "sound"})
        rows = db.query(
            "SELECT video_id, fusion_score FROM lameness_records "
            "WHERE fusion_score IS NOT NULL "
            "ORDER BY fusion_score DESC LIMIT 3")
        rows += db.query(
            "SELECT video_id, fusion_score FROM lameness_records "
            "WHERE fusion_score IS NOT NULL "
            "ORDER BY fusion_score ASC LIMIT 3")
        for row in rows:
            examples.append({
                "video_id": row["video_id"], "source": "fused_prediction",
                "label": "lame" if row["fusion_score"] >= 0.5 else "sound",
                "probability": row["fusion_score"]})
        return {"examples": examples, "count": len(examples),
                "total": len(examples)}

    # ============================ models ==================================
    @r.get("/api/models/parameters")
    def model_parameters(req: Request):
        ml = ctx.ml_config()
        return {
            # reference get_model_parameters keys (routers/models.py):
            # the GBDT families + ensemble at top level
            "catboost": ml.get("catboost", {}),
            "xgboost": ml.get("xgboost", {}),
            "lightgbm": ml.get("lightgbm", {}),
            "ensemble": ml.get("ensemble", {}),
            "tcn": {"channels": [64, 64, 64, 64], "kernel_size": 3,
                    "receptive_field": 61, "input_dim": 44},
            "transformer": {"d_model": 64, "num_layers": 4, "nhead": 4,
                            "ffn": 256, "input_dim": 44},
            "gnn": {"model": "EnhancedGraphGPS", "hidden_dim": 128,
                    "num_layers": 4, "num_heads": 8, "pe": "laplacian+rw"},
            "graph_transformer": {"model": "CowLamenessGraphormer",
                                  "hidden_dim": 128, "num_layers": 6,
                                  "num_heads": 8, "ffn": 512,
                                  "virtual_node": True},
            "ml": ctx.ml_config(),
            "yolo": {"variant": "yolov8n", "input": 640,
                     "conf_threshold": ctx.config.yolo.confidence_threshold},
            "sam": {"variant": ctx.config.sam.variant, "image_size": 1024},
            "dino": {"model": "dinov2-base", "dim": 768},
        }

    # ============================ shap ====================================
    @r.get("/api/analysis/similarity/map")
    def similarity_map(req: Request):
        """2-D PCA projection of the stored video embeddings — the data
        behind the SimilarityMap page."""
        if ctx.store is None:
            raise HTTPError(503, "vector store unavailable")
        coll = ctx.config.reid.collection_embeddings
        # public bulk-read surface: works for the in-process store AND the
        # Qdrant-wire remote store (scroll-backed export_collection)
        exported = ctx.store.export_collection(coll)
        if exported is None or len(exported["ids"]) < 2:
            raise HTTPError(404, "need at least two embedded videos")
        ids = exported["ids"]
        x = exported["vectors"] - exported["vectors"].mean(axis=0)
        # top-3 principal directions via SVD (x/y feed the 2-D scatter,
        # z the 3-D view — SimilarityMap.tsx viewMode '2d' | '3d')
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        k3 = min(3, vt.shape[0])
        coords = x @ vt[:k3].T
        if k3 < 3:
            coords = np.pad(coords, ((0, 0), (0, 3 - k3)))
        # lightweight k-means over the embedding space for the cluster
        # coloring/ellipsoids the reference page renders
        n = len(ids)
        k = min(5, max(1, n // 3))
        rng_km = np.random.default_rng(0)
        cent = x[rng_km.choice(n, size=k, replace=False)]
        assign = np.zeros(n, dtype=int)
        for _ in range(12):
            d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
            new_assign = d2.argmin(1)
            if (new_assign == assign).all() and _ > 0:
                break
            assign = new_assign
            for j in range(k):
                m = assign == j
                if m.any():
                    cent[j] = x[m].mean(0)
        elo = {r["video_id"]: r["elo_rating"]
               for r in db.query("SELECT video_id, elo_rating "
                                 "FROM video_elo_ratings")}
        return {"points": [
            {"video_id": ids[i], "x": float(coords[i, 0]),
             "y": float(coords[i, 1]), "z": float(coords[i, 2]),
             "cluster": int(assign[i]),
             "elo_rating": elo.get(ids[i]),
             "label": exported["payloads"].get(ids[i], {}).get("label")}
            for i in range(len(ids))]}

    def _shap_local(vid: str) -> Dict[str, Any]:
        """Saved SHAP result, else the reference's value-scaled fallback
        built from the ml result (routers/shap.py:15-58)."""
        f = dirs.results / "shap" / f"{vid}_shap.json"
        if f.exists():
            data = json.load(open(f))
            data.setdefault("video_id", vid)
            return data
        ml = ctx.read_result("ml", vid)
        if ml is None:
            raise HTTPError(404, "no shap or ml result")
        feats = ml.get("features", [])
        names = ml.get("feature_names",
                       [f"f{i}" for i in range(len(feats))])
        sv = []
        for feat, name in zip(feats, names):
            contribution = (float(feat) - 0.5) * 0.2
            sv.append({"feature": name, "value": float(feat),
                       "shap_value": contribution,
                       "contribution": abs(contribution)})
        sv.sort(key=lambda x: x["contribution"], reverse=True)
        pred = (ml.get("predictions", {}).get("ensemble", {})
                .get("probability", 0.5))
        return {"video_id": vid, "shap_values": sv,
                "base_value": 0.5, "prediction": pred}

    @r.get("/api/shap/{video_id}/local")
    def shap_local(req: Request):
        return _shap_local(req.params["video_id"])

    @r.get("/api/shap/global")
    def shap_global(req: Request):
        """Aggregate per-video SHAP files into global importance
        ({feature_importance, total_videos}, routers/shap.py:74-110);
        our files may store shap_values as {name: value} or as the
        reference's [{feature, shap_value}] list — accept both."""
        shap_dir = dirs.results / "shap"
        per_feature: Dict[str, list] = {}
        files = list(shap_dir.glob("*_shap.json")) \
            if shap_dir.exists() else []
        for f in files:
            try:
                sv = json.load(open(f)).get("shap_values", {})
            except Exception:
                continue
            items = sv.items() if isinstance(sv, dict) else \
                [(d.get("feature", "unknown"), d.get("shap_value", 0))
                 for d in sv]
            for name, val in items:
                per_feature.setdefault(name, []).append(abs(float(val)))
        imp = [{"feature": k, "importance": float(np.mean(v)),
                "std": float(np.std(v))} for k, v in per_feature.items()]
        imp.sort(key=lambda x: x["importance"], reverse=True)
        return {"feature_importance": imp, "total_videos": len(files)}

    @r.post("/api/shap/{video_id}/what-if")
    def shap_what_if(req: Request):
        """Accepts the reference body ({video_id, feature_changes:
        {name: value}}, shap.py:112-141) and our sweep form
        ({feature_index, values}).  Always answers with the reference's
        {video_id, original_prediction, modified_features, note}; with
        a live shap service the prediction is genuinely recomputed (the
        reference's handler left that as a TODO)."""
        b = req.body or {}
        vid = req.params["video_id"]
        ml = ctx.read_result("ml", vid)
        if ml is None:
            raise HTTPError(404, "no ml result")
        feats = np.asarray(ml.get("features", []), float)
        names = ml.get("feature_names",
                       [f"f{i}" for i in range(len(feats))])
        modified = feats.copy()
        for name, val in (b.get("feature_changes") or {}).items():
            if name in names:
                modified[names.index(name)] = float(val)
        orig_p = (ml.get("predictions", {}).get("ensemble", {})
                  .get("probability", 0.5))
        out = {"video_id": vid, "original_prediction": orig_p,
               "modified_features": dict(zip(names, modified.tolist()))}
        if ctx.shap_service is None:
            out["note"] = ("Prediction recalculation needs the shap "
                           "service; modified features echoed (reference "
                           "shap.py:136-141 behavior)")
            return out
        out["modified_prediction"] = float(
            np.asarray(ctx.shap_service._predict(modified[None])).ravel()[0])
        out["note"] = "prediction recomputed on the live ensemble"
        if "feature_index" in b or "values" in b:
            from ..xai.shapley import what_if
            idx = int(b.get("feature_index", 0))
            values = b.get("values") or list(np.linspace(0, 1, 5))
            out.update(what_if(ctx.shap_service._predict, feats, idx,
                               values))
        return out

    @r.get("/api/training/queue")
    def training_queue(req: Request):
        """The reference's active-learning labeling queue
        ({videos, total}, routers/training.py:80-114) plus our
        processing-job view (jobs/by_status) — keyspaces don't collide."""
        jobs = db.query("SELECT * FROM processing_jobs "
                        "ORDER BY created_at DESC LIMIT 100")
        by_status: Dict[str, int] = {}
        for j in jobs:
            by_status[j["status"]] = by_status.get(j["status"], 0) + 1
        out = _label_queue()
        out.update({"jobs": jobs, "by_status": by_status})
        return out

    @r.get("/api/shap/{video_id}/force-plot")
    def shap_force_plot(req: Request):
        """Force-plot data (routers/shap.py:61-72): {video_id,
        base_value, prediction, features} — plus our ordered
        contributions list for legacy clients."""
        vid = req.params["video_id"]
        data = _shap_local(vid)
        sv = data.get("shap_values", {})
        if isinstance(sv, dict):
            ordered = sorted(sv.items(), key=lambda kv: -abs(kv[1]))
            features = [{"feature": k, "value": v, "shap_value": v,
                         "contribution": abs(v)} for k, v in ordered]
        else:
            features = sv
            ordered = [(d.get("feature"), d.get("shap_value", 0))
                       for d in sv]
        return {"video_id": vid,
                "base_value": data.get("base_value"),
                "prediction": data.get("prediction"),
                "features": features,
                "contributions": [{"feature": k, "value": v}
                                  for k, v in ordered]}

    # ============================ pipeline ================================
    @r.post("/api/pipeline/heartbeat")
    def heartbeat(req: Request):
        b = req.body or {}
        name = b.get("service_name")
        if not name:
            raise HTTPError(422, "service_name required")
        db.upsert_heartbeat(name, b.get("status", "healthy"),
                            b.get("active_jobs", 0),
                            b.get("success_count", 0),
                            b.get("error_count", 0), b.get("last_error"))
        # reference push shape (websocket/handler.py:133-138 +
        # pipeline.py:454-458: type/service/status/details{active_jobs});
        # our pipeline_monitor refreshes on type.startsWith("pipeline")
        ctx.ws.broadcast("pipeline", {
            "type": "pipeline_status", "service": name,
            "status": b.get("status", "healthy"),
            "details": {"active_jobs": b.get("active_jobs", 0)}})
        # reference shape (pipeline.py heartbeat: {status, service})
        return {"status": "recorded", "service": name}

    SERVICE_DESCRIPTIONS = {
        "engine": "Fused device engine (detect/sam/dino/heads)",
        "video-ingestion": "Upload intake and S3 sync",
        "video-preprocessing": "Median-bbox crop",
        "clip-curation": "Walking-pass curation",
        "yolo-pipeline": "Cow detection",
        "sam3-pipeline": "Silhouette segmentation",
        "dinov3-pipeline": "Embedding + re-id",
        "tleap-pipeline": "Pose estimation",
        "tcn-pipeline": "Temporal severity head",
        "transformer-pipeline": "Gait transformer head",
        "gnn-pipeline": "GraphGPS head",
        "ml-pipeline": "GBDT ensemble",
        "fusion-service": "Late fusion",
    }

    def _service_status_row(row: dict) -> dict:
        """pipeline.py ServiceStatus model fields over our heartbeat
        row: + description and success_rate."""
        out = dict(row)
        out["description"] = SERVICE_DESCRIPTIONS.get(
            row["service_name"], row["service_name"])
        tried = (row.get("success_count") or 0) + (row.get("error_count")
                                                   or 0)
        out["success_rate"] = (row.get("success_count") or 0) / tried             if tried else 1.0
        return out

    @r.get("/api/pipeline/status")
    def pipeline_status(req: Request):
        return [_service_status_row(x) for x in
                db.query("SELECT * FROM service_heartbeats")]

    def _requeue(vid: str, subject: Optional[str] = None) -> None:
        """Re-publish a video into the pipeline (shared by retrigger,
        analysis batch and batch reprocess)."""
        ctx.bus.publish_sync(
            subject or ctx.config.subjects.video_preprocessed,
            {"video_id": vid,
             "processed_path": str(dirs.processed / f"{vid}_cropped.y4m"),
             "retriggered": True})

    @r.post("/api/pipeline/retrigger/{service}/{video_id}",
            roles=["admin", "researcher"])
    def retrigger(req: Request):
        service = req.params["service"]
        vid = req.params["video_id"]
        subj = {
            "yolo": ctx.config.subjects.video_preprocessed,
            "all": ctx.config.subjects.video_preprocessed,
            "ml": ctx.config.subjects.pipeline_dinov3,
            "fusion": ctx.config.subjects.pipeline_ml,
        }.get(service, ctx.config.subjects.video_preprocessed)
        _requeue(vid, subj)
        # reference also pushes the trigger over WS (pipeline.py:295-299)
        ctx.ws.broadcast("pipeline", {
            "type": "pipeline_status", "service": service,
            "status": "triggered",
            "details": {"video_id": vid,
                        "triggered_by": req.user["username"]}})
        # reference shape (pipeline.py trigger: {status, service,
        # video_id, subject})
        return {"status": "retriggered", "service": service,
                "video_id": vid, "subject": subj}

    @r.get("/api/pipeline/logs/{service}")
    def pipeline_logs(req: Request):
        """Per-service 'logs': the bus journal filtered to the service's
        subjects (routers/pipeline.py log view)."""
        service = req.params["service"]
        limit = _qint(req, "limit", 50)
        rel = [m for m in ctx.bus.history
               if service in m["subject"]][-limit:]
        errs = [e for e in ctx.bus.errors if service in e["subject"]][-limit:]
        return {"service": service, "messages": rel, "errors": errs}

    @r.get("/api/pipeline/queue")
    def pipeline_queue(req: Request):
        jobs = db.query("SELECT status, COUNT(*) n FROM processing_jobs "
                        "GROUP BY status")
        return {"jobs_by_status": {j["status"]: j["n"] for j in jobs},
                "bus_messages": len(ctx.bus.history),
                "bus_errors": len(ctx.bus.errors),
                # pipeline.py get_queue_status keys
                "status": "connected", "error": None}

    # ============================ health ==================================
    @r.get("/api/health/overview")
    def health_overview(req: Request):
        du = shutil.disk_usage(str(dirs.root))
        pct = du.used / du.total * 100
        disk_status = ("critical" if pct > 90 else
                       "warning" if pct > 75 else "healthy")
        hb = db.query("SELECT service_name, status FROM service_heartbeats")
        components = {
            "bus": "healthy",
            "vector_store": "healthy" if ctx.store else "unconfigured",
            "database": "healthy",
            "disk": disk_status,
        }
        issues = []
        if disk_status != "healthy":
            issues.append(f"disk {disk_status}: {round(pct, 1)}% used")
        if ctx.bus.errors:
            issues.append(f"{len(ctx.bus.errors)} bus handler errors")
        for hrow in hb:
            if hrow["status"] not in ("healthy", "idle"):
                issues.append(f"service {hrow['service_name']}: "
                              f"{hrow['status']}")
        overall = ("unhealthy" if disk_status == "critical"
                   else "degraded" if issues else "healthy")
        return {
            # health.py overview contract: status/components/issues
            "status": overall, "components": components, "issues": issues,
            "timestamp": _now(),
            "bus": {"status": "healthy" if True else "down",
                    "messages": len(ctx.bus.history),
                    "errors": len(ctx.bus.errors)},
            "vector_store": {
                "status": "healthy",
                "collections": ctx.store.collection_names()
                if ctx.store else []},
            "disk": {"percent_used": round(pct, 1), "status": disk_status,
                     "free_gb": round(du.free / 1e9, 2)},
            "services": {h["service_name"]: h["status"] for h in hb},
            "uptime_s": round(time.time() - ctx.start_time, 1),
        }

    @r.get("/api/health/throughput")
    def throughput(req: Request):
        window = float(req.query.get("window_s", 3600))
        cutoff = time.time() - window
        recent = [m for m in ctx.bus.history if m["ts"] > cutoff]
        per_subject: Dict[str, int] = {}
        for m in recent:
            per_subject[m["subject"]] = per_subject.get(m["subject"], 0) + 1
        done = per_subject.get("analysis.complete", 0)
        from ..utils.timing import TIMERS
        day = (datetime.now(timezone.utc) - timedelta(days=1)).isoformat()
        week = (datetime.now(timezone.utc) - timedelta(days=7)).isoformat()
        v24 = db.one("SELECT COUNT(*) n FROM videos WHERE "
                     "status='completed' AND uploaded_at >= ?", (day,))["n"]
        v7d = db.one("SELECT COUNT(*) n FROM videos WHERE "
                     "status='completed' AND uploaded_at >= ?", (week,))["n"]
        tried = db.one("SELECT COUNT(*) n FROM videos WHERE "
                       "status IN ('completed','failed')")["n"]
        okc = db.one("SELECT COUNT(*) n FROM videos WHERE "
                     "status='completed'")["n"]
        queued = db.one("SELECT COUNT(*) n FROM videos WHERE "
                        "status IN ('uploaded','processing')")["n"]
        eng = TIMERS.summary().get("engine", {})
        return {"window_s": window, "messages": len(recent),
                "per_subject": per_subject,
                "videos_analyzed": done,
                "videos_per_hour": done / window * 3600,
                "stage_timings": TIMERS.summary(),
                # health.py ThroughputStats model fields
                "videos_processed_24h": v24,
                "videos_processed_7d": v7d,
                "avg_processing_time_s": eng.get("mean"),
                "success_rate": okc / tried if tried else 1.0,
                "queue_depth": queued}

    # ============================ ml-config ===============================
    def _sync_ensemble_weights(cfg: Dict[str, Any]) -> None:
        """The reference persists ensemble weights for RUNTIME use on
        every ensemble-config save (routers/ml_config.py:168-196,291,333)
        — without this, admin weight edits would never reach the
        predictor, which reads models/ml/ensemble_weights.json."""
        w = (cfg.get("ensemble") or {}).get("weights")
        if not isinstance(w, dict) or not w:
            return
        from ..io import schemas
        schemas.write_result(Path(dirs.models) / "ml"
                             / "ensemble_weights.json", w)
        if ctx.ensemble is not None:
            ctx.ensemble.ensemble_weights = dict(w)

    def _model_json_schema(section: str) -> Dict[str, Any]:
        """Per-section JSON schema in the shape pydantic's
        model_json_schema() gives the reference (ml_config.py:346-357):
        title/type/properties with numeric bounds."""
        props: Dict[str, Any] = {}
        for key, meta in ML_CONFIG_SCHEMA.items():
            model, param = key.split(".", 1)
            if model != section:
                continue
            p: Dict[str, Any] = {
                "title": param.replace("_", " ").title(),
                "description": meta.get("description", "")}
            if meta.get("options"):
                p["enum"] = meta["options"]
                p["type"] = "string"
            else:
                p["type"] = {"int": "integer", "float": "number"}.get(
                    meta.get("type"), meta.get("type", "number"))
                if meta.get("min") is not None:
                    p["minimum"], p["maximum"] = meta["min"], meta["max"]
            props[param] = p
        return {"title": f"{section.title()}Config", "type": "object",
                "properties": props}

    @r.get("/api/ml-config")
    def get_ml_config(req: Request):
        """{config, config_file, models_dir} envelope
        (routers/ml_config.py:177-186) + our flat param schema."""
        return {"config": ctx.ml_config(), "schema": ML_CONFIG_SCHEMA,
                "config_file": str(ctx.ml_config_path),
                "models_dir": str(Path(dirs.models) / "ml")}

    @r.put("/api/ml-config", roles=["admin", "researcher"])
    def put_ml_config(req: Request):
        b = req.body or {}
        cfg = ctx.ml_config()
        for section, values in b.items():
            if section not in cfg or not isinstance(values, dict):
                raise HTTPError(422, f"unknown section {section}")
            cfg[section].update(values)
        ctx.save_ml_config(cfg)
        _sync_ensemble_weights(cfg)
        return {"config": cfg}

    # ============================ elo =====================================
    def _rater_weight(user_row) -> float:
        tier = (user_row or {}).get("rater_tier") or "bronze"
        return {"gold": 1.5, "silver": 1.0, "bronze": 0.75}.get(tier, 1.0)

    @r.post("/api/elo/comparison", auth=True)
    def submit_comparison(req: Request):
        """routers/elo_ranking.py:318-436: Elo update + comparison record +
        rater-reliability propagation."""
        b = req.body or {}
        v1, v2 = b.get("video_id_1"), b.get("video_id_2")
        winner = b.get("winner")
        if not v1 or not v2 or winner not in (0, 1, 2):
            raise HTTPError(422, "video_id_1, video_id_2, winner required")
        degree = int(b.get("degree", 1))
        user = db.one("SELECT * FROM users WHERE id=?", (req.user["sub"],))
        weight = _rater_weight(user)
        ra = db.get_or_create_elo(v1)
        rb = db.get_or_create_elo(v2)
        na, nb, ua, ub = elo_mod.update_ratings(
            ra["elo_rating"], rb["elo_rating"], ra["elo_uncertainty"],
            rb["elo_uncertainty"], ra["total_comparisons"],
            rb["total_comparisons"], winner, degree, weight)
        db.update_elo(v1, na, ua, {1: "win", 2: "loss", 0: "tie"}[winner])
        db.update_elo(v2, nb, ub, {1: "loss", 2: "win", 0: "tie"}[winner])
        db.insert("pairwise_comparisons", {
            "video_id_1": v1, "video_id_2": v2, "winner": winner,
            "degree": degree, "confidence": b.get("confidence", "confident"),
            "rater_id": req.user["sub"], "rater_weight": weight})
        if ctx.reliability is not None:
            ctx.reliability.handle_comparison_submitted({
                "video_id_1": v1, "video_id_2": v2,
                "rater_id": req.user["username"], "winner": winner})
        ctx.bus.publish_sync(ctx.config.subjects.hitl_comparison_submitted, {
            "video_id_1": v1, "video_id_2": v2, "winner": winner,
            "degree": degree, "rater_id": req.user["username"]})
        # reference push shape (websocket/handler.py:162-168:
        # type/event/data)
        ctx.ws.broadcast("rater", {
            "type": "rater_update", "event": "comparison",
            "data": {"rater": req.user["username"],
                     "video_id_1": v1, "video_id_2": v2}})
        # reference shape (elo_ranking.py:421-435) + our legacy keys
        return {"status": "saved",
                "video_1": {"video_id": v1, "new_elo": round(na, 1),
                            "change": round(na - ra["elo_rating"], 1)},
                "video_2": {"video_id": v2, "new_elo": round(nb, 1),
                            "change": round(nb - rb["elo_rating"], 1)},
                "video_id_1": {"rating": na, "uncertainty": ua},
                "video_id_2": {"rating": nb, "uncertainty": ub}}

    @r.get("/api/elo/hierarchy")
    def hierarchy(req: Request):
        """David's scores + steepness over all comparisons
        (elo_ranking.py:437-499)."""
        comps = db.query("SELECT * FROM pairwise_comparisons")
        ds = elo_mod.davids_scores(comps)
        st, se = elo_mod.steepness(ds)
        icc = elo_mod.inter_rater_agreement(comps)
        ranked = sorted(ds.items(), key=lambda kv: kv[1], reverse=True)
        ranking = []
        for pos, (vid, score) in enumerate(ranked, start=1):
            row = db.get_or_create_elo(vid)
            db.update("video_elo_ratings", row["id"],
                      {"normalized_score": score, "rank_position": pos})
            # elo_ranking.py:475-488: full per-row Elo record
            ranking.append({
                "video_id": vid, "davids_score": score, "rank": pos,
                "elo_rating": round(row["elo_rating"], 1),
                "elo_uncertainty": round(row["elo_uncertainty"], 1),
                "wins": row["wins"], "losses": row["losses"],
                "ties": row["ties"],
                "total_comparisons": row["total_comparisons"],
                "win_rate": round(row["wins"] / row["total_comparisons"], 3)
                if row["total_comparisons"] else 0,
            })
        return {
            "ranking": ranking,
            "total_videos": len(ranking),
            "steepness": st, "steepness_se": se,
            "inter_rater_reliability": icc,
            "total_comparisons": len(comps),
            # elo_ranking.py:492-498
            "metrics": {
                "steepness": round(st, 4), "steepness_se": round(se, 4),
                "inter_rater_agreement": round(icc, 4),
                "hierarchy_linearity": "Strong" if st > 0.7
                else "Moderate" if st > 0.4 else "Weak",
            },
        }

    @r.get("/api/elo/next-pair", auth=True)
    def next_pair(req: Request):
        return pairwise_next(req)

    @r.get("/api/elo/stats")
    def elo_stats(req: Request):
        rows = db.query("SELECT * FROM video_elo_ratings")
        comps = db.query("SELECT COUNT(*) n FROM pairwise_comparisons")
        # CASE instead of 2-arg min()/max(): those are SQLite-only scalar
        # forms (Postgres spells them LEAST/GREATEST) and this module's
        # SQL stays portable (io/db.py driver-swap contract)
        uniq = db.query(
            "SELECT COUNT(DISTINCT CASE WHEN video_id_1 < video_id_2 "
            "THEN video_id_1 || '|' || video_id_2 "
            "ELSE video_id_2 || '|' || video_id_1 END) n "
            "FROM pairwise_comparisons")[0]["n"]
        ratings = [r["elo_rating"] for r in rows]
        n_vids = db.query("SELECT COUNT(*) n FROM videos")[0]["n"]
        possible = n_vids * (n_vids - 1) // 2
        wd = {row["winner"]: row["n"] for row in db.query(
            "SELECT winner, COUNT(*) n FROM pairwise_comparisons "
            "GROUP BY winner")}
        user_stats = None
        user = getattr(req, "user", None)
        if user:
            _, _, user_uniq = _pair_progress(user["username"])
            user_total = db.one(
                "SELECT COUNT(*) n FROM pairwise_comparisons pc JOIN "
                "users u ON pc.rater_id = u.id WHERE u.username=?",
                (user["username"],))["n"]
            # tier lives in the users table, not the token payload
            row = db.one("SELECT rater_tier FROM users WHERE id=?",
                         (user["sub"],))
            user_stats = {
                "user_id": str(user["sub"]),
                "username": user["username"],
                "tier": (row or {}).get("rater_tier") or "bronze",
                "total_comparisons": user_total,
                "unique_pairs_compared": user_uniq,
                "completion_rate": user_uniq / possible if possible else 0,
                "pending_pairs": max(0, possible - (user_uniq or 0))}
        return {"total_videos": len(rows),
                "total_comparisons": comps[0]["n"],
                "unique_pairs_compared": uniq,
                "total_possible_pairs": possible,
                "completion_rate": uniq / possible if possible else 0.0,
                # reference get_elo_stats keys (elo_ranking.py:640-706)
                "winner_distribution": {
                    "video_1_wins": wd.get(1, 0),
                    "video_2_wins": wd.get(2, 0),
                    "ties": wd.get(0, 0)},
                "comparisons_per_pair": comps[0]["n"] / uniq if uniq else 0,
                "user_stats": user_stats,
                "rating_mean": float(np.mean(ratings)) if ratings else None,
                "rating_std": float(np.std(ratings)) if ratings else None}

    @r.post("/api/elo/snapshot", roles=["admin", "researcher"])
    def snapshot(req: Request):
        comps = db.query("SELECT * FROM pairwise_comparisons")
        ds = elo_mod.davids_scores(comps)
        st, se = elo_mod.steepness(ds)
        icc = elo_mod.inter_rater_agreement(comps)
        sid = db.insert("hierarchy_snapshots", {
            "name": (req.body or {}).get("name", f"snapshot-{_now()}"),
            "description": (req.body or {}).get("description"),
            "total_videos": len(ds), "total_comparisons": len(comps),
            "steepness": st, "steepness_std": se,
            "inter_rater_reliability": icc,
            "ranking_data": json.dumps(ds),
            "created_by": req.user["sub"]})
        row = db.one("SELECT * FROM hierarchy_snapshots WHERE id=?", (sid,))
        # reference shape (elo_ranking.py::create_snapshot response:
        # {id, name, total_videos, created_at}) + our legacy keys
        return {"id": sid, "name": row["name"],
                "total_videos": row["total_videos"],
                "created_at": row["created_at"],
                "snapshot_id": sid, "steepness": st}

    @r.get("/api/elo/history/{video_id}")
    def elo_history(req: Request):
        return db.query("SELECT * FROM elo_history WHERE video_id=? "
                        "ORDER BY recorded_at", (req.params["video_id"],))

    @r.post("/api/elo/recalculate", roles=["admin"])
    def recalculate(req: Request):
        """Replay every comparison from scratch (elo_ranking.py:740-817)."""
        comps = db.query("SELECT * FROM pairwise_comparisons "
                         "ORDER BY created_at")
        db.execute("DELETE FROM video_elo_ratings")
        db.execute("DELETE FROM elo_history")
        for c in comps:
            ra = db.get_or_create_elo(c["video_id_1"])
            rb = db.get_or_create_elo(c["video_id_2"])
            na, nb, ua, ub = elo_mod.update_ratings(
                ra["elo_rating"], rb["elo_rating"], ra["elo_uncertainty"],
                rb["elo_uncertainty"], ra["total_comparisons"],
                rb["total_comparisons"], c["winner"], c["degree"],
                c["rater_weight"])
            db.update_elo(c["video_id_1"], na, ua,
                          {1: "win", 2: "loss", 0: "tie"}[c["winner"]])
            db.update_elo(c["video_id_2"], nb, ub,
                          {1: "loss", 2: "win", 0: "tie"}[c["winner"]])
        n_vids = db.one("SELECT COUNT(*) n FROM video_elo_ratings")["n"]
        # reference shape (elo_ranking.py:740-817) + our legacy key
        return {"status": "recalculated", "total_comparisons": len(comps),
                "total_videos": n_vids, "recalculated": len(comps)}

    # ============================ tutorial ================================
    @r.get("/api/tutorial/tasks")
    def tutorial_tasks(req: Request):
        """{tasks, total} envelope (routers/tutorial.py list shape)."""
        rows = db.query("SELECT * FROM gold_tasks WHERE is_active=1 "
                        "ORDER BY is_tutorial DESC, tutorial_order")
        return {"tasks": rows, "total": len(rows)}

    @r.post("/api/tutorial/tasks", roles=["admin", "researcher"])
    def create_gold_task(req: Request):
        b = req.body or {}
        for k in ("video_id_1", "video_id_2", "correct_winner"):
            if b.get(k) is None:
                raise HTTPError(422, f"missing {k}")
        tid = db.insert("gold_tasks", {
            "video_id_1": b["video_id_1"], "video_id_2": b["video_id_2"],
            "correct_winner": b["correct_winner"],
            "correct_degree": b.get("correct_degree", 2),
            "difficulty": b.get("difficulty", "medium"),
            "description": b.get("description"), "hint": b.get("hint"),
            "is_tutorial": int(b.get("is_tutorial", False)),
            "tutorial_order": b.get("tutorial_order"),
            "created_by": req.user["sub"]})
        # reference returns the full task row (tutorial.py GoldTask shape)
        return db.one("SELECT * FROM gold_tasks WHERE id=?", (tid,))

    @r.delete("/api/tutorial/tasks/{task_id}", roles=["admin", "researcher"])
    def delete_gold_task(req: Request):
        db.update("gold_tasks", req.params["task_id"], {"is_active": 0})
        return {"status": "deactivated"}

    @r.post("/api/tutorial/auto-generate", roles=["admin", "researcher"])
    def auto_generate(req: Request):
        """Build gold tasks from extreme Elo-gap pairs (tutorial.py)."""
        rows = db.query("SELECT * FROM video_elo_ratings "
                        "WHERE total_comparisons >= 3 "
                        "ORDER BY elo_rating DESC")
        created = []
        n = int((req.body or {}).get("count", 3))
        for i in range(min(n, len(rows) // 2)):
            hi, lo = rows[i], rows[-(i + 1)]
            if hi["video_id"] == lo["video_id"]:
                break
            tid = db.insert("gold_tasks", {
                "video_id_1": hi["video_id"], "video_id_2": lo["video_id"],
                "correct_winner": 1, "correct_degree": 3,
                "difficulty": "easy",
                "description": "auto-generated from Elo extremes",
                "created_by": req.user["sub"]})
            created.append(tid)
        # reference shape (tutorial.py:126-160 auto_generate_tutorial)
        return {"created": created, "created_ids": created,
                "message": f"auto-generated {len(created)} gold tasks "
                           "from Elo extremes",
                "note": "auto-generated tasks need expert review before "
                        "being served to raters"}

    # ============================ cows ====================================
    @r.get("/api/cows")
    def list_cows(req: Request):
        """Registry rows enriched with the latest lameness state the
        reference's list view renders (cows.py get_cows: severity,
        current score, video count)."""
        cows = db.query("SELECT * FROM cow_identities WHERE is_active=1 "
                        "ORDER BY last_seen DESC")
        latest: Dict[str, Dict[str, Any]] = {}
        for row in db.query("SELECT cow_id, severity_level, fusion_score "
                            "FROM lameness_records "
                            "ORDER BY observation_date"):
            latest[row["cow_id"]] = row
        nvids: Dict[str, int] = {}
        for row in db.query("SELECT cow_id, COUNT(*) n FROM track_history "
                            "GROUP BY cow_id"):
            nvids[row["cow_id"]] = row["n"]
        for c in cows:
            lr = latest.get(c["id"], {})
            c["severity_level"] = lr.get("severity_level")
            c["current_score"] = lr.get("fusion_score")
            c["num_videos"] = nvids.get(c["id"], 0)
        skip = _qint(req, "skip", 0)
        limit = _qint(req, "limit", 50)
        total = len(cows)
        return {"cows": cows[skip:skip + limit], "total": total,
                "skip": skip, "limit": limit}

    @r.get("/api/cows/{cow_id}")
    def cow_detail(req: Request):
        """Reference get_cow shape: row + video_count /
        lameness_record_count / current_prediction /
        last_prediction_update (routers/cows.py)."""
        cow = db.one("SELECT * FROM cow_identities WHERE cow_id=?",
                     (req.params["cow_id"],))
        if not cow:
            raise HTTPError(404, "cow not found")
        cow["video_count"] = db.one(
            "SELECT COUNT(DISTINCT video_id) n FROM track_history "
            "WHERE cow_id=?", (cow["id"],))["n"]
        cow["lameness_record_count"] = db.one(
            "SELECT COUNT(*) n FROM lameness_records WHERE cow_id=?",
            (cow["id"],))["n"]
        pf = dirs.results / "cow_predictions" / \
            f"{req.params['cow_id']}_prediction.json"
        pred = json.load(open(pf)) if pf.exists() else {}
        cow["current_prediction"] = pred.get("prediction")
        cow["last_prediction_update"] = pred.get("last_updated")
        return cow

    @r.get("/api/cows/{cow_id}/lameness-history")
    def cow_history(req: Request):
        """Timeline + trend per the reference shape (cows.py:159-237:
        newest-first timeline, recent-vs-older trend, ?days filter)."""
        # ?days=abc is a 422 like the reference's FastAPI `days: int`
        # validation (the old ValueError fallback is unreachable now
        # that _qint raises HTTPError)
        days = _qint(req, "days", 30)
        rows = db.lameness_history(req.params["cow_id"])
        cutoff = (datetime.now(timezone.utc)
                  - timedelta(days=days)).isoformat()
        timeline = [row for row in rows
                    if not row.get("observation_date")
                    or row["observation_date"] >= cutoff]
        timeline.reverse()          # newest first, like the reference
        if len(timeline) >= 2:
            recent = [t["fusion_score"] for t in timeline[:5]
                      if t["fusion_score"] is not None]
            older = [t["fusion_score"] for t in timeline[5:10]
                     if t["fusion_score"] is not None]
            if recent and older:
                delta = (sum(recent) / len(recent)
                         - sum(older) / len(older))
                trend = ("worsening" if delta > 0.1 else
                         "improving" if delta < -0.1 else "stable")
            else:
                trend = "unknown"
        else:
            trend = "insufficient_data"
        return {"cow_id": req.params["cow_id"], "timeline": timeline,
                "total_records": len(timeline), "days_range": days,
                "trend": trend}

    @r.get("/api/cows/{cow_id}/videos")
    def cow_videos(req: Request):
        """{cow_id, videos, total, skip, limit} envelope
        (routers/cows.py::get_cow_videos)."""
        cow = db.one("SELECT * FROM cow_identities WHERE cow_id=?",
                     (req.params["cow_id"],))
        if not cow:
            raise HTTPError(404, "cow not found")
        rows = db.query("SELECT * FROM track_history WHERE cow_id=?",
                        (cow["id"],))
        skip = _qint(req, "skip", 0)
        limit = _qint(req, "limit", 50)
        return {"cow_id": req.params["cow_id"],
                "videos": rows[skip:skip + limit], "total": len(rows),
                "skip": skip, "limit": limit}

    @r.get("/api/cows/{cow_id}/prediction")
    def cow_prediction(req: Request):
        """Reference envelope {cow_id, prediction, last_updated,
        latest_video} (routers/cows.py:314-345) merged over the raw
        prediction file."""
        cid = req.params["cow_id"]
        f = dirs.results / "cow_predictions" / f"{cid}_prediction.json"
        if not f.exists():
            raise HTTPError(404, "no cow prediction")
        data = json.load(open(f))
        out = dict(data)
        out.update({"cow_id": cid,
                    "prediction": data.get("prediction", {}),
                    "last_updated": data.get("last_updated"),
                    "latest_video": data.get("latest_video")})
        return out

    @r.patch("/api/cows/{cow_id}", roles=["admin", "researcher"])
    def patch_cow(req: Request):
        cow = db.one("SELECT * FROM cow_identities WHERE cow_id=?",
                     (req.params["cow_id"],))
        if not cow:
            raise HTTPError(404, "cow not found")
        allowed = {k: v for k, v in (req.body or {}).items()
                   if k in ("tag_number", "notes", "is_active")}
        db.update("cow_identities", cow["id"], allowed)
        return db.one("SELECT * FROM cow_identities WHERE id=?", (cow["id"],))

    @r.get("/api/cows/summary/stats")
    def cow_summary(req: Request):
        """Registry summary incl. the reference's severity distribution
        (cows.py:433-477: latest severity_level per cow)."""
        cows = db.query("SELECT COUNT(*) n FROM cow_identities "
                        "WHERE is_active=1")
        all_cows = db.query("SELECT COUNT(*) n FROM cow_identities")
        lame = db.query(
            "SELECT COUNT(DISTINCT cow_id) n FROM lameness_records "
            "WHERE is_lame=1")
        tracked = db.query("SELECT COUNT(*) n FROM track_history")
        nrec = db.query("SELECT COUNT(*) n FROM lameness_records")
        sev = {"healthy": 0, "mild": 0, "moderate": 0, "severe": 0,
               "unknown": 0}
        latest: Dict[str, str] = {}
        for row in db.query("SELECT cow_id, severity_level "
                            "FROM lameness_records "
                            "ORDER BY observation_date"):
            latest[row["cow_id"]] = row["severity_level"]
        for level in latest.values():
            sev[level if level in sev else "unknown"] += 1
        return {"total_cows": all_cows[0]["n"],
                "active_cows": cows[0]["n"],
                "cows_with_lameness": lame[0]["n"],
                "total_videos_tracked": tracked[0]["n"],
                "total_lameness_records": nrec[0]["n"],
                "severity_distribution": sev}

    # ================== reference-parity completions =======================
    # The long tail of the reference's 112-endpoint surface (audited
    # against services/admin-interface/backend/app/routers/*.py).

    # -- auth (routers/auth.py) ---------------------------------------------
    @r.post("/api/auth/users", roles=["admin"])
    def admin_create_user(req: Request):
        b = req.body or {}
        for k in ("username", "password"):
            if not b.get(k):
                raise HTTPError(422, f"missing {k}")
        email = b.get("email", f"{b['username']}@lameness.local")
        if db.one("SELECT id FROM users WHERE username=? OR email=?",
                  (b["username"], email)):
            raise HTTPError(409, "username or email taken")
        role = b.get("role", "rater")
        if role not in ("admin", "researcher", "rater"):
            raise HTTPError(422, "invalid role")
        tier = b.get("rater_tier", "bronze")
        if tier not in ("gold", "silver", "bronze"):
            raise HTTPError(422, "invalid rater_tier")
        uid = db.insert("users", {
            "email": email,
            "username": b["username"],
            "password_hash": hash_password(b["password"]),
            "role": role, "rater_tier": tier if role == "rater" else None,
            "is_active": 1, "created_at": _now()})
        return {"id": uid, "username": b["username"], "role": role,
                "rater_tier": tier if role == "rater" else None}

    @r.get("/api/auth/users/{user_id}", roles=["admin"])
    def get_user(req: Request):
        u = db.one("SELECT id, email, username, role, is_active, rater_tier,"
                   " created_at, last_login FROM users WHERE id=?",
                   (req.params["user_id"],))
        if not u:
            raise HTTPError(404, "no such user")
        return u

    @r.delete("/api/auth/users/{user_id}", roles=["admin"])
    def delete_user(req: Request):
        if req.params["user_id"] == req.user["sub"]:
            raise HTTPError(422, "cannot delete yourself")
        db.update("users", req.params["user_id"], {"is_active": 0})
        return {"status": "deactivated"}

    @r.put("/api/auth/password", auth=True)
    def change_password(req: Request):
        b = req.body or {}
        if not b.get("current_password") or not b.get("new_password"):
            raise HTTPError(422, "current_password and new_password required")
        u = db.one("SELECT * FROM users WHERE id=?", (req.user["sub"],))
        if not u or not verify_password(b["current_password"],
                                        u["password_hash"]):
            raise HTTPError(403, "current password incorrect")
        db.update("users", u["id"],
                  {"password_hash": hash_password(b["new_password"])})
        return {"status": "changed"}

    # -- analysis (routers/analysis.py) -------------------------------------
    @r.get("/api/analysis/{video_id}/all")
    def analysis_all_pipelines(req: Request):
        """Reference get_all_pipeline_results shape: {video_id,
        pipelines: {name: {status, data}}} incl. shap + explanation
        slots — plus legacy raw-result top-level keys."""
        vid = req.params["video_id"]
        out = {p: ctx.read_result(p, vid) for p in PIPELINES}
        env = {p: {"status": "success" if out[p] is not None
                   else "not_available", "data": out[p]}
               for p in PIPELINES}
        shap_f = dirs.results_for("shap") / f"{vid}_shap.json"
        if shap_f.exists():
            env["shap"] = {"status": "success",
                           "data": json.load(open(shap_f))}
        exp_f = dirs.results / "explanations" / f"{vid}_explanation.json"
        env["explanation"] = {
            "status": "success" if exp_f.exists() else "not_available",
            "data": json.load(open(exp_f)) if exp_f.exists() else None}
        out["video_id"] = vid
        out["pipelines"] = env
        return out

    @r.get("/api/analysis/{video_id}/summary")
    def analysis_summary(req: Request):
        vid = req.params["video_id"]
        fus = ctx.read_result("fusion", vid)
        fr = (fus or {}).get("fusion_result", {})
        return {"video_id": vid,
                "analyzed": fus is not None,
                "final_probability": fr.get("final_probability", 0.5),
                "final_prediction": fr.get("final_prediction", 0),
                "prediction_label": "lame"
                if fr.get("final_prediction", 0) == 1 else "sound",
                "pipeline_contributions":
                fr.get("pipeline_contributions", {}),
                "confidence": fr.get("confidence"),
                "recommendation": fr.get("recommendation"),
                "pipelines_used": fr.get("pipelines_used", []),
                "cow_id": (fus or {}).get("cow_id")}

    @r.get("/api/analysis/{video_id}/export")
    def analysis_export(req: Request):
        """JSON or flattened-CSV export of every pipeline's result
        (routers/analysis.py:188-239: ?format=csv emits
        video_id,pipeline,metric,value rows; nested dicts dotted,
        lists of dicts collapsed to a _count row)."""
        vid = req.params["video_id"]
        fmt_q = req.query.get("format", "json")
        if fmt_q not in ("json", "csv"):
            raise HTTPError(400, "Format must be 'json' or 'csv'")
        video = db.one("SELECT * FROM videos WHERE id=?", (vid,))
        results = {p: ctx.read_result(p, vid) for p in PIPELINES}
        if fmt_q == "json":
            return {"video": video, "exported_at": _now(),
                    "results": results}
        rows = [["video_id", "pipeline", "metric", "value"]]

        def flatten(pipeline, data, prefix=""):
            for k, v in data.items():
                name = f"{prefix}{k}" if prefix else k
                if isinstance(v, dict):
                    flatten(pipeline, v, f"{name}.")
                elif isinstance(v, list):
                    if v and isinstance(v[0], dict):
                        rows.append([vid, pipeline, f"{name}_count", len(v)])
                    else:
                        rows.append([vid, pipeline, name, str(v)])
                else:
                    rows.append([vid, pipeline, name, v])

        for p, data in results.items():
            if data:
                flatten(p, data)
        import csv as _csv
        import io as _io
        buf = _io.StringIO()
        _csv.writer(buf).writerows(rows)
        return (200, buf.getvalue().encode(), "text/csv",
                {"Content-Disposition":
                 f"attachment; filename={vid}_analysis.csv"})

    @r.get("/api/analysis/{video_id}/frames/{frame_num}")
    def analysis_frame(req: Request):
        """Per-frame analysis view: detections + nearest pose entry."""
        vid = req.params["video_id"]
        try:
            n = int(req.params["frame_num"])
        except ValueError:
            raise HTTPError(422, "frame_num must be an integer")
        yolo = ctx.read_result("yolo", vid) or {}
        dets = [f for f in yolo.get("detections", [])
                if f.get("frame") == n]
        tleap = ctx.read_result("tleap", vid) or {}
        seqs = tleap.get("pose_sequences", [])
        pose = min(seqs, key=lambda s: abs(s.get("frame", 0) - n)) \
            if seqs else None
        # reference get_frame_data shape: a frame entry may be a
        # per-frame group ({"detections": [...]}) or a flat detection
        out = {"video_id": vid, "frame": n,
               "detections": dets[0].get("detections", dets) if dets
               else [],
               "pose_keypoints": [], "mask_coverage": None,
               "pose": pose}
        exact = [s for s in seqs if s.get("frame") == n]
        if exact:
            out["pose_keypoints"] = exact[0].get("keypoints", [])
            out["pose_bbox"] = exact[0].get("bbox", [])
        sam = ctx.read_result("sam3", vid) or {}
        for seg in sam.get("segmentations", []):
            if seg.get("frame") == n:
                out["mask_coverage"] = seg.get("mask_available", False)
                break
        return out

    @r.post("/api/analysis/batch", roles=["admin", "researcher"])
    def analysis_batch(req: Request):
        """Batch analysis READ (routers/analysis.py:242-258
        get_batch_analysis): body is a bare JSON list of video ids
        (FastAPI `video_ids: List[str]`) or {video_ids: [...]}, response
        {count, results: {vid: {pipelines: {...}}}}."""
        body = req.body
        vids = body if isinstance(body, list) \
            else (body or {}).get("video_ids") or []
        results = {}
        for vid in vids:
            pipes = {}
            for p in PIPELINES:
                res = ctx.read_result(p, vid)
                if res is not None:
                    pipes[p] = res
            results[vid] = {"pipelines": pipes}
        return {"count": len(results), "results": results}

    # -- cows (routers/cows.py reference paths) ------------------------------
    @r.get("/api/cows/{cow_id}/lameness")
    def cow_lameness(req: Request):
        """Reference get_cow_lameness_history envelope {cow_id, timeline,
        total_records, days_range, trend} — same handler as our canonical
        /lameness-history path."""
        return cow_history(req)

    # the reference exposes validation as a GET (routers/cows.py) — a
    # side-effectful GET is a quirk we deliberately fix: POST is the real
    # method; the GET alias remains for reference-client compatibility
    @r.post("/api/cows/{cow_id}/lameness/{record_id}/validate",
            roles=["admin", "researcher"])
    @r.get("/api/cows/{cow_id}/lameness/{record_id}/validate",
           roles=["admin", "researcher"])
    def validate_lameness(req: Request):
        rec = db.one("SELECT * FROM lameness_records WHERE id=?",
                     (req.params["record_id"],))
        # records store the cow's INTERNAL id; the route carries the
        # public cow_id string — accept either (cows.py resolves by
        # cow_id string)
        cow = db.one("SELECT * FROM cow_identities WHERE cow_id=?",
                     (req.params["cow_id"],))
        ids = {req.params["cow_id"]} | ({cow["id"]} if cow else set())
        if not rec or rec["cow_id"] not in ids:
            raise HTTPError(404, "no such record")
        # normalize string-typed body values the same way as the query
        # fallback: a JSON "false"/"0" must not coerce to True via bool()
        raw = (req.body or {}).get(
            "is_lame", req.query.get("is_lame", "1"))
        if isinstance(raw, str):
            raw = raw.strip().lower() not in ("0", "false", "no", "")
        is_lame = bool(raw)
        db.update("lameness_records", rec["id"],
                  {"human_validated": 1, "human_label": int(is_lame),
                   "validator_id": req.user["sub"],
                   "validation_date": _now()})
        return {"status": "validated", "record_id": rec["id"],
                "human_validated": True, "human_label": is_lame,
                "message": "Record validated successfully"}

    # -- elo snapshots (routers/elo_ranking.py) ------------------------------
    @r.get("/api/elo/snapshots")
    def list_snapshots(req: Request):
        rows = db.query("SELECT id, name, description, total_videos, "
                        "total_comparisons, steepness, "
                        "inter_rater_reliability, created_at "
                        "FROM hierarchy_snapshots ORDER BY created_at DESC")
        return {"snapshots": rows}

    @r.get("/api/elo/snapshot/{snapshot_id}")
    def get_snapshot(req: Request):
        row = db.one("SELECT * FROM hierarchy_snapshots WHERE id=?",
                     (req.params["snapshot_id"],))
        if not row:
            raise HTTPError(404, "no such snapshot")
        row["ranking_data"] = json.loads(row["ranking_data"] or "{}")
        row["ranking"] = row["ranking_data"]     # elo_ranking.py get_snapshot
        return row

    # -- health probes (routers/health.py per-dependency checks) -------------
    @r.get("/api/health/disk")
    def health_disk(req: Request):
        """LIST of per-path usage entries (health.py DiskUsage model:
        path/total_gb/used_gb/free_gb/percent_used/status)."""
        out = []
        for p in {str(dirs.root), str(dirs.videos), str(dirs.results)}:
            try:
                u = shutil.disk_usage(p)
            except OSError:
                continue
            pct = u.used / u.total * 100
            out.append({
                "path": p,
                "total_gb": round(u.total / 1e9, 1),
                "used_gb": round(u.used / 1e9, 1),
                "free_gb": round(u.free / 1e9, 1),
                "percent_used": round(pct, 1),
                "status": "healthy" if pct < 80 else
                          "warning" if pct < 90 else "critical"})
        return out

    @r.get("/api/health/nats")
    def health_nats(req: Request):
        """The in-process bus is the NATS analog; a live NatsBridge
        reports the real socket."""
        bridge = getattr(ctx.bus, "bridge", None)
        n_msgs = len(ctx.bus.history)
        # history records use the 'payload' key (bus.py::_record)
        n_bytes = sum(len(json.dumps(m.get("payload", {})))
                      for m in ctx.bus.history[-500:])
        subs = getattr(ctx.bus, "_subs", {})
        n_subs = sum(len(hs) for hs in subs.values())
        return {"status": "healthy",
                "backend": "nats-bridge" if bridge else "in-process",
                "messages": n_msgs,
                "errors": len(ctx.bus.errors),
                # health.py NatsHealth model fields
                "connections": 1,
                "subscriptions": n_subs,
                "messages_in": n_msgs, "messages_out": n_msgs,
                "bytes_in": n_bytes, "bytes_out": n_bytes}

    @r.get("/api/health/qdrant")
    def health_qdrant(req: Request):
        store = ctx.store
        if store is None:
            return {"status": "unconfigured"}
        try:
            t0 = time.perf_counter()
            names = store.collection_names()
            counts = {n: store.count(n) for n in names}
            ms = (time.perf_counter() - t0) * 1e3
            return {"status": "healthy",
                    "backend": type(store).__name__,
                    "collections": counts,
                    # health.py DbHealth model fields
                    "connection_count": 1,
                    "database_size_mb": round(
                        sum(counts.values()) * 768 * 4 / 1e6, 3),
                    "response_time_ms": round(ms, 2)}
        except Exception as e:
            return {"status": "unhealthy", "error": repr(e)[:200]}

    @r.get("/api/health/postgres")
    def health_postgres(req: Request):
        """SQLite carries the reference's Postgres contract here; the
        response shape matches health.py (size MB + probe latency)."""
        try:
            t0 = time.perf_counter()
            n = db.query("SELECT COUNT(*) n FROM users")[0]["n"]
            ms = (time.perf_counter() - t0) * 1e3
            size_mb = 0.0
            if getattr(db, "path", None) and Path(db.path).exists():
                size_mb = Path(db.path).stat().st_size / 1e6
            return {"status": "healthy", "backend": "sqlite", "users": n,
                    "connection_count": 1,    # health.py DbHealth field
                    "database_size_mb": round(size_mb, 2),
                    "response_time_ms": round(ms, 2)}
        except Exception as e:
            return {"status": "unhealthy", "error": repr(e)[:200]}

    @r.get("/api/health/docker")
    def health_docker(req: Request):
        """The reference checks its 22 containers; the analog here is the
        in-process service set + live threads."""
        import threading
        import resource
        mem_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        rows = db.query(
            "SELECT service_name, status, last_heartbeat "
            "FROM service_heartbeats")
        out = [{"name": "admin-backend", "status": "healthy",
                "cpu_percent": 0.0, "memory_mb": round(mem_mb, 1),
                "memory_percent": 0.0,
                "uptime": f"{len(threading.enumerate())} threads"}]
        for h in rows:
            out.append({"name": h["service_name"], "status": h["status"],
                        "cpu_percent": 0.0, "memory_mb": 0.0,
                        "memory_percent": 0.0,
                        "uptime": h.get("last_heartbeat") or ""})
        return out

    # -- ml-config long tail (routers/ml_config.py) --------------------------
    @r.get("/api/ml-config/schema")
    def ml_config_schema(req: Request):
        """Flat "model.param" entries (our runtime schema) + the
        reference's per-model JSON-schema keys (ml_config.py:346-357) —
        the dotted and bare keyspaces never collide."""
        out: Dict[str, Any] = dict(ML_CONFIG_SCHEMA)
        for section in DEFAULT_ML_CONFIG:
            out[section] = _model_json_schema(section)
        out["full"] = {"title": "FullMLConfig", "type": "object",
                       "properties": {s: {"$ref": f"#/{s}"}
                                      for s in DEFAULT_ML_CONFIG}}
        return out

    @r.get("/api/ml-config/parameter-descriptions")
    def ml_param_descriptions(req: Request):
        """Nested {model: {param: {name, description, category, default,
        range|options}}} shape (routers/ml_config.py:437-710)."""
        out: Dict[str, Dict[str, Any]] = {}
        for key, meta in ML_CONFIG_SCHEMA.items():
            model, param = key.split(".", 1)
            entry: Dict[str, Any] = {
                "name": param.replace("_", " ").title(),
                "description": meta.get("description", ""),
                "category": meta.get("category", "Other"),
                "default": DEFAULT_ML_CONFIG.get(model, {}).get(param),
            }
            if meta.get("options"):
                entry["options"] = meta["options"]
            elif meta.get("min") is not None:
                entry["range"] = [meta["min"], meta["max"]]
            out.setdefault(model, {})[param] = entry
        return out

    @r.get("/api/ml-config/models/status")
    def ml_models_status(req: Request):
        """{models, training_status, models_dir} envelope
        (routers/ml_config.py:359-435); per-slot entries carry the
        reference's trained/file/size plus our loaded/path."""
        models_dir = Path(dirs.models) / "ml"
        models: Dict[str, Any] = {}
        for slot in ("catboost", "xgboost", "lightgbm"):
            if ctx.ensemble is not None:
                f = ctx.ensemble._slot_path(slot)
                loaded = ctx.ensemble.models.get(slot) is not None
            else:
                f = models_dir / f"{slot}_latest.joblib"
                loaded = False
            trained = f.exists()
            models[slot] = {
                "trained": trained, "loaded": loaded,
                "file": str(f) if trained else None,
                "size": f.stat().st_size if trained else None,
                # legacy spellings our earlier clients used
                "file_exists": trained, "path": str(f)}
        wf = models_dir / "ensemble_weights.json"
        models["ensemble"] = {"trained": wf.exists(),
                              "file": str(wf) if wf.exists() else None,
                              "size": None, "file_exists": wf.exists()}
        if wf.exists():
            try:
                models["ensemble"]["weights"] = json.load(open(wf))
            except Exception:
                pass
        sf = dirs.training / "training_status.json"
        training_status = None
        if sf.exists():
            try:
                training_status = json.load(open(sf))
            except Exception:
                pass
        return {"models": models, "training_status": training_status,
                "models_dir": str(models_dir)}

    @r.post("/api/ml-config/reset", roles=["admin", "researcher"])
    def ml_config_reset(req: Request):
        cfg = json.loads(json.dumps(DEFAULT_ML_CONFIG))
        ctx.save_ml_config(cfg)
        _sync_ensemble_weights(cfg)
        # reference envelope (ml_config.py reset: {message, config});
        # the sections stay at top level for our legacy clients
        return dict(cfg, config=cfg,
                    message="configuration reset to defaults")

    @r.get("/api/ml-config/{model}")
    def ml_config_model(req: Request):
        """Reference per-model envelope {config, schema}
        (ml_config.py:208-323) with the section's params also at top
        level for our own clients (param names never collide)."""
        m = req.params["model"]
        cfg = ctx.ml_config()
        if m not in cfg:
            raise HTTPError(404, f"no config section {m}")
        out = dict(cfg[m])
        out["config"] = cfg[m]
        out["schema"] = _model_json_schema(m)
        return out

    @r.put("/api/ml-config/{model}", roles=["admin", "researcher"])
    def put_ml_config_model(req: Request):
        m = req.params["model"]
        cfg = ctx.ml_config()
        if m not in cfg:
            raise HTTPError(404, f"no config section {m}")
        cfg[m].update({k: v for k, v in (req.body or {}).items()
                       if k not in ("config", "schema")})
        ctx.save_ml_config(cfg)
        _sync_ensemble_weights(cfg)
        out = dict(cfg[m])
        out["config"] = cfg[m]
        out["message"] = f"{m} configuration updated"
        return out

    # -- models long tail (routers/models.py) --------------------------------
    @r.get("/api/models/parameters/defaults")
    def model_param_defaults(req: Request):
        return DEFAULT_ML_CONFIG

    @r.post("/api/models/parameters", roles=["admin", "researcher"])
    def set_model_parameters(req: Request):
        cfg = ctx.ml_config()
        for section, vals in (req.body or {}).items():
            if section in cfg and isinstance(vals, dict):
                cfg[section].update(vals)
        ctx.save_ml_config(cfg)
        _sync_ensemble_weights(cfg)
        # reference shape (models.py:61-84: {status, parameters})
        return dict(cfg, status="updated", parameters=cfg)

    @r.get("/api/models/comparison")
    def model_comparison(req: Request):
        """Per-slot CV metrics from the last training run."""
        status_f = Path(dirs.training) / "training_status.json"
        if not status_f.exists():
            return {"models": {}, "note": "no training run yet"}
        st = json.load(open(status_f))
        return {"models": (st.get("report") or {}).get("models", {}),
                "trained_at": st.get("completed_at"),
                "num_samples": (st.get("report") or {}).get("num_samples")}

    # -- pipeline batch ops (routers/pipeline.py) ----------------------------
    @r.post("/api/pipeline/batch/reprocess", roles=["admin", "researcher"])
    def batch_reprocess(req: Request):
        """Re-queue failed (or explicitly listed) videos."""
        b = req.body or {}
        vids = b.get("video_ids")
        if not vids:
            rows = db.query("SELECT video_id FROM processing_jobs "
                            "WHERE status='failed'")
            vids = [row["video_id"] for row in rows]
        errors = []
        for vid in vids:
            try:
                _requeue(vid)
            except Exception as e:       # pragma: no cover - requeue is local
                errors.append({"video_id": vid, "error": str(e)})
        done = [v for v in vids
                if v not in {e["video_id"] for e in errors}]
        # reference shape (pipeline.py:311-360 batch_reprocess)
        return {"status": "completed", "triggered": done,
                "triggered_count": len(done), "error_count": len(errors),
                "errors": errors, "requeued": done}

    # -- training long tail (routers/training.py) ----------------------------
    @r.get("/api/training/models")
    def training_models(req: Request):
        """Trained model inventory (checkpoints on disk)."""
        out = []
        mdir = Path(dirs.models)
        if mdir.exists():
            for p in sorted(mdir.iterdir()):
                size = sum(q.stat().st_size for q in p.rglob("*")
                           if q.is_file()) if p.is_dir() \
                    else p.stat().st_size
                out.append({"name": p.name,
                            "is_dir": p.is_dir(),
                            "size_kb": size / 1024,
                            "modified": p.stat().st_mtime})
        return {"models": out, "total": len(out)}

    @r.post("/api/training/pairwise", auth=True)
    def training_pairwise_submit(req: Request):
        """Reference path alias for comparison submission, answering
        with the reference's {status, pair_key, total_comparisons}
        (training.py:242-281) on top of the Elo-update payload."""
        out = submit_comparison(req)
        b = req.body or {}
        v1, v2 = b.get("video_id_1"), b.get("video_id_2")
        lo, hi = sorted((v1, v2))
        n = db.one("SELECT COUNT(*) n FROM pairwise_comparisons WHERE "
                   "(video_id_1=? AND video_id_2=?) OR "
                   "(video_id_1=? AND video_id_2=?)", (lo, hi, hi, lo))["n"]
        return dict(out, status="saved", pair_key=f"{lo}_{hi}",
                    total_comparisons=n)

    @r.get("/api/training/pairwise/stats")
    def pairwise_stats(req: Request):
        """Reference stats keys (routers/training.py:339-368):
        total_comparisons / pairs_compared / total_possible_pairs /
        completion_rate, plus our rater counts."""
        comps = db.query("SELECT COUNT(*) n FROM pairwise_comparisons")
        raters = db.query("SELECT COUNT(DISTINCT rater_id) n "
                          "FROM pairwise_comparisons")
        rated = db.query("SELECT COUNT(*) n FROM video_elo_ratings")
        total_possible, pairs_done, _ = _pair_progress()
        return {"total_comparisons": comps[0]["n"],
                "unique_raters": raters[0]["n"],
                "videos_rated": rated[0]["n"],
                "pairs_compared": pairs_done,
                "total_possible_pairs": total_possible,
                "completion_rate": pairs_done / total_possible
                if total_possible else 0}

    @r.put("/api/training/learn/progress", auth=True)
    def put_learn_progress(req: Request):
        """Module completion marks + quiz-game stats (training.py learn
        PUT; TrainingModule.tsx persists score/streak/accuracy here)."""
        b = req.body or {}
        prog_dir = Path(dirs.training) / "learn_progress"
        prog_dir.mkdir(parents=True, exist_ok=True)
        prog_f = prog_dir / f"{req.user['sub']}.json"
        saved: Dict[str, Any] = {}
        if prog_f.exists():
            try:
                saved = json.load(open(prog_f))
            except Exception:
                pass
        for k in ("modules_completed", "total_score", "streak",
                  "total_attempts", "correct_count", "current_level"):
            if k in b:
                saved[k] = b[k]
        saved.setdefault("modules_completed", [])
        saved["updated_at"] = _now()
        from ..io import schemas
        schemas.write_result(prog_f, saved)   # atomic vs the GET reader
        return {"status": "saved"}

    # -- tutorial long tail (routers/tutorial.py) ----------------------------
    @r.get("/api/tutorial/examples")
    def tutorial_examples(req: Request):
        tasks = db.query("SELECT * FROM gold_tasks WHERE is_active=1 "
                         "AND is_tutorial=1 ORDER BY tutorial_order")
        return {"examples": tasks, "count": len(tasks),
                "total": len(tasks)}

    @r.get("/api/tutorial/stats")
    def tutorial_stats(req: Request):
        """Totals plus the reference's richer breakdown
        (tutorial.py:449-500: tutorial/validation split + difficulty
        distribution)."""
        rows = db.query("SELECT is_tutorial, is_active, difficulty "
                        "FROM gold_tasks")
        tut = [t for t in rows if t["is_tutorial"]]
        gold = [t for t in rows if not t["is_tutorial"]]
        dist: Dict[str, int] = {}
        for t in rows:
            if t["is_active"]:
                dist[t["difficulty"]] = dist.get(t["difficulty"], 0) + 1
        return {"total_gold_tasks": sum(1 for t in rows if t["is_active"]),
                "tutorial_tasks": sum(1 for t in tut if t["is_active"]),
                "tutorials": {"total": len(tut),
                              "active": sum(1 for t in tut
                                            if t["is_active"])},
                "gold_tasks": {"total": len(gold),
                               "active": sum(1 for t in gold
                                             if t["is_active"])},
                "difficulty_distribution": dist}

    @r.put("/api/tutorial/tasks/{task_id}", roles=["admin", "researcher"])
    def update_gold_task(req: Request):
        allowed = {k: v for k, v in (req.body or {}).items()
                   if k in ("correct_winner", "correct_degree", "difficulty",
                            "description", "hint", "is_tutorial",
                            "tutorial_order", "is_active")}
        if not allowed:
            raise HTTPError(422, "no updatable fields")
        if not db.one("SELECT id FROM gold_tasks WHERE id=?",
                      (req.params["task_id"],)):
            raise HTTPError(404, "no such gold task")
        db.update("gold_tasks", req.params["task_id"], allowed)
        # reference returns the full updated task row (tutorial.py)
        row = db.one("SELECT * FROM gold_tasks WHERE id=?",
                     (req.params["task_id"],))
        return dict(row, status="updated")

    # -- videos long tail (routers/videos.py) --------------------------------
    @r.get("/api/videos/storage-config")
    def storage_config(req: Request):
        """routers/videos.py::get_storage_config shape (local backend:
        s3/cloudfront fields present but disabled)."""
        return {"backend": "local",
                "s3_enabled": False, "s3_bucket": None,
                "cloudfront_enabled": False, "cloudfront_domain": None,
                "local_path": str(dirs.videos),
                "root": str(dirs.root),
                "videos_dir": str(dirs.videos),
                "s3_flow": "upload-url/confirm-upload endpoints emulate "
                           "the reference's presigned-S3 flow locally"}

    @r.get("/api/videos/{video_id}/annotation-status")
    def annotation_status(req: Request):
        renderer = getattr(ctx, "_renderer", None)
        vid = req.params["video_id"]
        st = renderer.status.get(vid) if renderer else None
        f = Path(dirs.root) / "annotated" / f"{vid}_annotated.y4m"
        st = dict(st) if st else \
            {"status": "completed" if f.exists() else "not_started"}
        st.setdefault("video_id", vid)    # routers/videos.py shape
        return st

    @r.delete("/api/videos/{video_id}/annotation", auth=True)
    def delete_annotation(req: Request):
        vid = req.params["video_id"]
        f = Path(dirs.root) / "annotated" / f"{vid}_annotated.y4m"
        existed = f.exists()
        if existed:
            f.unlink()
        if db.one("SELECT id FROM videos WHERE id=?", (vid,)):
            db.update("videos", vid, {"has_annotated": 0})
        return {"deleted": existed}

    # ============ reference-exact path aliases ============================
    # Every alias below serves the REFERENCE's literal route shape
    # (services/admin-interface/backend/app/routers/*.py mounts) so a
    # drop-in client of the reference backend hits the same paths; each
    # delegates to the canonical handler above.

    @r.get("/api/analysis/{video_id}/explanation")         # analysis.py
    def ref_get_explanation(req: Request):
        """get_llm_explanation shape: not_available envelope instead of
        404 when no explanation exists (routers/analysis.py)."""
        vid = req.params["video_id"]
        f = dirs.results / "explanations" / f"{vid}_explanation.json"
        if not f.exists():
            msg = ("LLM explanation not available (no LLM configured or "
                   "analysis pending)"
                   if ctx.read_result("fusion", vid) is not None
                   else "No analysis results found for this video")
            return {"video_id": vid, "status": "not_available",
                    "message": msg}
        data = json.load(open(f))
        data["status"] = "available"
        data.setdefault("message", "")
        return data

    @r.get("/api/analysis/{video_id}/graph_transformer")   # analysis.py
    def ref_graph_transformer(req: Request):
        """Dedicated Graphormer view (routers/analysis.py::
        get_graph_transformer_results keys, defaults included)."""
        vid = req.params["video_id"]
        data = ctx.read_result("graph_transformer", vid)
        if data is None:
            raise HTTPError(404, "Graph Transformer results not found")
        return _graph_transformer_envelope(vid, data)

    def _ref_user_field(req: Request, field: str, body_keys):
        b = req.body or {}
        val = next((b[k] for k in body_keys if k in b), None)
        if val is None:
            raise HTTPError(422, f"missing {body_keys[0]}")
        db.update("users", req.params["user_id"], {field: val})
        return db.one("SELECT id, username, role, rater_tier, is_active "
                      "FROM users WHERE id=?", (req.params["user_id"],))

    @r.put("/api/auth/users/{user_id}/role", roles=["admin"])
    def ref_set_role(req: Request):
        return _ref_user_field(req, "role", ("role", "value"))

    @r.put("/api/auth/users/{user_id}/status", roles=["admin"])
    def ref_set_status(req: Request):
        return _ref_user_field(req, "is_active", ("is_active", "status",
                                                  "value"))

    @r.put("/api/auth/users/{user_id}/tier", roles=["admin"])
    def ref_set_tier(req: Request):
        return _ref_user_field(req, "rater_tier", ("rater_tier", "tier",
                                                   "value"))

    @r.get("/api/cows/stats/summary")                      # cows.py
    def ref_cow_summary(req: Request):
        return cow_summary(req)

    @r.get("/api/elo/video/{video_id}/history")            # elo_ranking.py
    def ref_elo_history(req: Request):
        """{video_id, history} envelope (elo_ranking.py get_video_history)."""
        return {"video_id": req.params["video_id"],
                "history": elo_history(req)}

    @r.get("/api/pipeline/{service}/logs")                 # pipeline.py
    def ref_pipeline_logs(req: Request):
        """ARRAY of LogEntry rows (pipeline.py response_model
        List[LogEntry]: timestamp/level/service/message)."""
        service = req.params["service"]
        limit = _qint(req, "limit", 50)
        out = []
        for m in ctx.bus.history:
            if service in m["subject"]:
                out.append({"timestamp": m.get("ts"), "level": "info",
                            "service": service,
                            "message": m["subject"]})
        for e in ctx.bus.errors:
            if service in e["subject"]:
                out.append({"timestamp": e.get("ts"), "level": "error",
                            "service": service,
                            "message": str(e.get("error", e["subject"]))})
        return out[-limit:]

    @r.get("/api/pipeline/{service}/status")
    def ref_pipeline_service_status(req: Request):
        row = db.one("SELECT * FROM service_heartbeats WHERE service_name=?",
                     (req.params["service"],))
        if not row:
            raise HTTPError(404, "no heartbeat for service")
        return _service_status_row(row)

    @r.post("/api/pipeline/{service}/trigger/{video_id}",
            roles=["admin", "researcher"])
    def ref_pipeline_trigger(req: Request):
        return retrigger(req)

    @r.post("/api/shap/what-if")                           # shap.py
    def ref_shap_what_if(req: Request):
        vid = (req.body or {}).get("video_id")
        if not vid:
            raise HTTPError(422, "video_id required")
        req.params["video_id"] = vid
        return shap_what_if(req)

    @r.post("/api/training/ml/start", roles=["admin", "researcher"])
    def ref_start_ml(req: Request):                        # training.py
        return start_ml_training(req)

    @r.post("/api/training/yolo/start", roles=["admin", "researcher"])
    def ref_start_yolo(req: Request):
        return start_yolo_training(req)

    @r.post("/api/training/triplet", auth=True)
    def ref_triplet_submit(req: Request):
        return triplet_submit(req)

    @r.post("/api/training/videos/{video_id}/label", auth=True)
    def ref_training_label(req: Request):
        return label_video(req)

    @r.post("/api/tutorial/examples/auto-generate",        # tutorial.py
            roles=["admin", "researcher"])
    def ref_tutorial_autogen(req: Request):
        return auto_generate(req)

    @r.get("/api/videos/{video_id}/frame/{frame_num}")     # videos.py
    def ref_video_frame(req: Request):
        req.query["frame"] = req.params["frame_num"]
        return extract_frame(req)

    @r.post("/api/videos/confirm-upload")
    def ref_confirm_upload(req: Request):
        vid = (req.body or {}).get("video_id")
        if not vid:
            raise HTTPError(422, "video_id required")
        req.params["video_id"] = vid
        return confirm_upload(req)

    # ============================ misc ====================================
    @r.get("/health")
    def root_health(req: Request):
        return {"status": "healthy", "service": "lameness-tpu-admin"}

    @r.get("/")
    def index(req: Request):
        """The admin UI (static ES-module SPA replacing the React app)."""
        page = Path(__file__).parent / "static" / "index.html"
        if not page.exists():
            raise HTTPError(404, "UI not bundled")
        return (200, page.read_bytes(), "text/html; charset=utf-8")

    _STATIC = Path(__file__).parent / "static"
    _MIME = {".js": "text/javascript; charset=utf-8",
             ".css": "text/css; charset=utf-8",
             ".html": "text/html; charset=utf-8",
             ".svg": "image/svg+xml", ".png": "image/png"}

    def _serve_static(rel: str):
        if not re.fullmatch(r"[\w.\-]+(/[\w.\-]+)?", rel) or ".." in rel:
            raise HTTPError(404, "not found")
        f = _STATIC / rel
        if not f.is_file():
            raise HTTPError(404, f"no static file {rel}")
        return (200, f.read_bytes(),
                _MIME.get(f.suffix, "application/octet-stream"))

    @r.get("/static/{fname}")
    def static_file(req: Request):
        return _serve_static(req.params["fname"])

    @r.get("/static/pages/{fname}")
    def static_page(req: Request):
        return _serve_static("pages/" + req.params["fname"])

    return r


def make_server(ctx: AdminContext, host: str = "127.0.0.1",
                port: int = 0) -> AdminHTTPServer:
    router = build_admin_api(ctx)
    return AdminHTTPServer(router, ctx.tokens, ctx.ws, host, port)
