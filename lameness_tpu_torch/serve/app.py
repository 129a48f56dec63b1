"""LamenessApp: the whole platform in one process (port of
``lameness_tpu/serve/app.py``, wired to the port's driver, engine and
services).

The reference runs 22 containers wired by NATS subjects
(``docker-compose.yml``); this is the equivalent single-process runtime:
every service's subscription is a bus handler here, the hot path runs on
the device engine, and the admin API serves the same REST/WS surface.

Subject wiring (mirrors SURVEY.md §2.3's subscription sites):
  video.uploaded       → curation (side branch) + preprocessing
  video.preprocessed   → fused feature stages (yolo+sam+dino+tleap+tcn+tr)
  pipeline.yolo        → tracking
  pipeline.dinov3      → Re-ID join + graph heads
  pipeline.ml          → fusion
  analysis.complete    → SHAP + LLM explanation + lameness record (DB)
  training.ml.requested→ tabular ensemble training
  hitl.comparison.submitted → rater reliability

The engine, the driver's decoding and curation, and the annotation renderer
run on the engine's device (without an engine, on the card).  A job stranded with its crop on disk is resumed
from its ``<id>_cropped.mp4``, as in JAX.
"""
from __future__ import annotations

import json
import threading
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, Optional

from ..core.config import Config
from ..hitl.reliability import RaterReliabilityService
from ..io.bus import MessageBus
from ..io.db import open_database
from ..io.vecstore import make_store
from ..ml.training import TrainingService
from ..utils.logging import get_logger
from ..xai.llm import LLMExplanationService
from ..xai.shap_service import ShapService
from .annotation import AnnotationRenderer
from .api import AdminContext, make_server
from .driver import PipelineDriver

_LOG = get_logger("app")


class LamenessApp:
    def __init__(self, config: Optional[Config] = None, engine=None,
                 reactive: bool = True, serve_api: bool = False,
                 api_port: int = 0, restore_checkpoints: bool = True,
                 async_dispatch: bool = False, bus_workers: int = 4,
                 resume_inflight: bool = False, clip_batch: int = 1,
                 batch_window_s: float = 0.25):
        self.config = config or Config()
        self.dirs = self.config.dirs.ensure()
        if engine is not None and restore_checkpoints:
            try:
                from ..pipeline.checkpoint import restore_engine
                restore_engine(engine, self.dirs.models)
            except Exception as e:
                # a checkpoint that does not install leaves the seeded
                # weights in place, as in the JAX app
                _LOG.error("app.restore_failed", exc=e)
        device = engine.device if engine is not None else None
        self.bus = MessageBus(
            journal_path=Path(self.dirs.root) / "bus_journal.jsonl",
            async_dispatch=async_dispatch, workers=bus_workers)
        self.db = open_database(
            self.config.db.url or Path(self.dirs.root) / "lameness.db")
        self.store = make_store(
            url=self.config.reid.vector_url,
            persist_path=Path(self.dirs.root) / "vector_store.json",
            device=device)
        self.driver = PipelineDriver(config=self.config, engine=engine,
                                     bus=self.bus, store=self.store,
                                     device=device)
        self.reliability = RaterReliabilityService(
            self.dirs.rater_reliability, bus=self.bus,
            subjects=self.config.subjects)
        self.training = TrainingService(self.dirs, bus=self.bus,
                                        subjects=self.config.subjects)
        self.shap = ShapService(self.dirs, self.driver.ensemble)
        self.llm = LLMExplanationService(self.dirs)
        self.renderer = AnnotationRenderer(self.dirs, device=device)
        self.server = None
        self._processing = threading.Lock()
        # clip batching: group queued videos into one engine batch call
        self._batcher = None
        if clip_batch > 1 and engine is not None:
            from .batcher import ClipBatcher
            self._batcher = ClipBatcher(self, max_batch=clip_batch,
                                        window_s=batch_window_s)
        # serialises tracking/Re-ID: match_or_create is check-then-create
        # over the shared identity registry, racy under async dispatch
        self._tracking = threading.Lock()

        # write consensus files where fusion reads them
        self._consensus_dir = self.dirs.rater_reliability / "consensus"
        self._consensus_dir.mkdir(parents=True, exist_ok=True)

        if reactive:
            self._wire_bus()
            if resume_inflight and engine is not None:
                self.resume_inflight_jobs()
        if serve_api:
            ctx = AdminContext(self.config, self.db, self.bus,
                               reliability=self.reliability,
                               ensemble=self.driver.ensemble,
                               shap_service=self.shap, llm_service=self.llm,
                               driver=self.driver, store=self.store)
            ctx.seed_users()
            ctx._renderer = self.renderer   # the API renders on our device
            self.ctx = ctx
            self.server = make_server(ctx, port=api_port)
            self.server.start()
            self._wire_ws_mirror()

    def _wire_ws_mirror(self):
        """Push pipeline progress + analysis results to the WS channels the
        frontend subscribes to (websocket/handler.py channels)."""
        s = self.config.subjects
        ws = self.ctx.ws

        def mk(channel, event):
            def push(msg):
                ws.broadcast(channel, {"type": event,
                                       "video_id": msg.get("video_id"),
                                       "data": {k: v for k, v in msg.items()
                                                if isinstance(v, (int, float,
                                                                  str, bool))
                                                }})
            return push

        for subject in (s.video_uploaded, s.video_preprocessed,
                        s.pipeline_yolo, s.pipeline_sam3, s.pipeline_dinov3,
                        s.pipeline_tleap, s.pipeline_tcn,
                        s.pipeline_transformer, s.pipeline_gnn,
                        s.pipeline_graph_transformer, s.pipeline_ml,
                        s.tracking_complete):
            self.bus.subscribe_sync(subject, mk("pipeline", subject))
        self.bus.subscribe_sync(s.analysis_complete,
                                mk("queue", "analysis.complete"))
        self.bus.subscribe_sync(s.rater_reliability_updated,
                                mk("rater", "rater.reliability.updated"))

    # ------------------------------------------------------------------
    def _wire_bus(self):
        s = self.config.subjects
        self.bus.subscribe_sync(s.video_uploaded, self._on_uploaded)
        self.bus.subscribe_sync(s.video_preprocessed, self._on_preprocessed)
        self.bus.subscribe_sync(s.pipeline_yolo, self._on_yolo)
        self.bus.subscribe_sync(s.pipeline_dinov3, self._on_dinov3)
        self.bus.subscribe_sync(s.pipeline_ml, self._on_ml)
        self.bus.subscribe_sync(s.analysis_complete, self._on_complete)
        self.bus.subscribe_sync(s.explanation_requested,
                                self._on_explanation_requested)
        self.bus.subscribe_sync(s.training_ml_requested,
                                self.training.handle_training_request)
        self.bus.subscribe_sync(s.hitl_comparison_submitted,
                                self.reliability.handle_comparison_submitted)
        self.bus.subscribe_sync(s.tracking_reid_match, self._on_reid_match)

    def resume_inflight_jobs(self) -> int:
        """Re-trigger jobs stranded 'processing' by a crash/restart.

        The reference's at-most-once consumers drop such videos silently
        (SURVEY §5.3; only a manual re-trigger endpoint exists) — here the
        processing_jobs table is the durable work queue, so startup can
        resume: re-publish video.preprocessed when the cropped file
        exists, else video.uploaded when the raw upload exists.
        Returns the number of jobs resumed.
        """
        s = self.config.subjects
        resumed = 0
        for job in self.db.query(
                "SELECT video_id FROM processing_jobs "
                "WHERE status='processing'"):
            vid = job["video_id"]
            if (self.dirs.results_for("fusion") /
                    f"{vid}_fusion.json").exists():
                self.db_mark_job(vid, "completed")
                continue
            processed = self.dirs.processed / f"{vid}_cropped.mp4"
            raw = next(iter(self.dirs.videos.glob(f"{vid}.*")), None)
            if processed.exists():
                _LOG.info("job.resume", video_id=vid, stage="preprocessed")
                self.bus.publish_sync(s.video_preprocessed, {
                    "video_id": vid, "processed_path": str(processed)})
                resumed += 1
            elif raw is not None:
                _LOG.info("job.resume", video_id=vid, stage="uploaded")
                self.bus.publish_sync(s.video_uploaded, {
                    "video_id": vid, "file_path": str(raw)})
                resumed += 1
            else:
                self.db_mark_job(vid, "failed",
                                 error="no artifacts found at resume")
        return resumed

    def db_mark_job(self, video_id: str, status: str,
                    error: Optional[str] = None) -> None:
        job = self.db.one(
            "SELECT job_id FROM processing_jobs WHERE video_id=? "
            "AND status='processing'", (video_id,))
        if job:
            upd = {"status": status}
            if error:
                upd["error_message"] = error
            self.db.update("processing_jobs", job["job_id"], upd,
                           pk="job_id")

    def _on_reid_match(self, msg: Dict[str, Any]):
        """Persist the cow registry + track history like the reference's
        tracking service does to Postgres (tracking:383-430)."""
        cow_id = msg.get("cow_id")
        if not cow_id:
            return
        self.db.record_sighting(
            cow_id, msg.get("video_id", ""), msg.get("track_id", 0),
            msg.get("similarity", 0.0), msg.get("start_frame", 0),
            msg.get("end_frame", 0), msg.get("confidence", 0.0))

    def _heartbeat(self, service: str, **kw):
        try:
            self.db.upsert_heartbeat(service, **kw)
        except Exception:
            pass
        if kw.get("error_count"):
            _LOG.error("service.error", service_name=service, **{
                k: v for k, v in kw.items() if k != "error_count"})
        else:
            _LOG.debug("service.heartbeat", service_name=service, **kw)

    # -- handlers ------------------------------------------------------------
    def _on_uploaded(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        if not vid or msg.get("_from_app"):
            return
        # queue bookkeeping (processing_jobs table, routers/pipeline.py)
        try:
            self.db.insert("processing_jobs", {
                "video_id": vid, "status": "processing",
                "started_at": datetime.now(timezone.utc).isoformat(),
                "current_pipeline": "preprocess"})
        except Exception:
            pass
        self._heartbeat("video-preprocessing", active_jobs=1)
        # side-branch curation (clip-curation subscribes video.uploaded too)
        raw = next(iter(self.dirs.videos.glob(f"{vid}.*")), None)
        if raw is not None:
            try:
                self.driver.curator.curate_video(raw, vid)
            except Exception:
                pass
        try:
            self.driver.preprocess(vid)
        except Exception as e:
            # failure detection at the DECODE stage: a corrupt upload
            # (VideoReader refuses to open) must mark the job failed, not
            # leave it wedged at 'processing' until restart — the same
            # contract the engine stage (_on_preprocessed) and the stream
            # path (on_decode_failure) already keep
            self._heartbeat("video-preprocessing", active_jobs=0,
                            error_count=1, last_error=repr(e)[:300])
            self.db_mark_job(vid, "failed", error=repr(e)[:500])
            raise
        self._heartbeat("video-preprocessing", active_jobs=0,
                        success_count=1)

    def _on_preprocessed(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        path = msg.get("processed_path")
        if not vid or not path or self.driver.engine is None:
            return
        if self._batcher is not None:
            self._batcher.submit(vid, Path(path))
            return
        with self._processing:
            self._heartbeat("fused-engine", active_jobs=1)
            try:
                self.driver.run_feature_stages(vid, Path(path))
            except Exception as e:
                # failure detection: record the failed job (SURVEY §5.3 —
                # the reference drops the video silently on consumer crash)
                self._heartbeat("fused-engine", active_jobs=0, error_count=1,
                                last_error=repr(e)[:300])
                self.db_mark_job(vid, "failed", error=repr(e)[:500])
                raise
            self._heartbeat("fused-engine", active_jobs=0, success_count=1)

    def _on_yolo(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        if vid:
            with self._tracking:
                self.driver.run_tracking(vid)
            self._heartbeat("tracking-service", success_count=1)

    def _on_dinov3(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        if not vid:
            return
        try:
            self.driver._ensure_graph_runner().process_video(vid)
        except Exception:
            pass
        # ml triggers on pipeline.dinov3 in the reference (ml:373-376)
        self.driver.run_ml(vid)
        self._heartbeat("graph-heads", success_count=1)

    def _on_ml(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        if vid:
            # refresh human consensus file for fusion's reader
            c = self.reliability.compute_weighted_consensus(vid)
            if c is not None:
                from ..io import schemas
                schemas.write_result(        # atomic: fusion reads it live
                    self._consensus_dir / f"{vid}.json",
                    {"probability": c.probability,
                     "confidence": c.confidence,
                     "num_raters": c.num_raters})
            self.driver.fusion.process_video(
                vid, timestamp=datetime.now(timezone.utc).isoformat())
            self._heartbeat("fusion-service", success_count=1)

    def _on_complete(self, msg: Dict[str, Any]):
        vid = msg.get("video_id")
        if not vid:
            return
        try:
            job = self.db.one(
                "SELECT job_id FROM processing_jobs WHERE video_id=? "
                "AND status='processing'", (vid,))
            if job:
                self.db.update("processing_jobs", job["job_id"], {
                    "status": "completed", "progress": 1.0,
                    "completed_at": datetime.now(timezone.utc).isoformat(),
                    "current_pipeline": None}, pk="job_id")
        except Exception:
            pass
        self.shap.process_analysis(msg)
        self.llm.handle_analysis_complete(msg)
        cow_id = msg.get("cow_id")
        if cow_id:
            fusion = msg.get("fusion_result", {})
            full = self.driver.fusion.collect_pipeline_predictions(vid)
            self.db.get_or_create_cow(cow_id)
            self.db.add_lameness_record(cow_id, vid, fusion, full)
        self._heartbeat("xai-services", success_count=1)

    def _on_explanation_requested(self, msg) -> None:
        """explanation.requested: (re)generate the LLM explanation for an
        already-analyzed video (the admin API's generate endpoint acks
        and publishes here when it has no in-process LLM)."""
        vid = msg.get("video_id")
        f = self.dirs.results_for("fusion") / f"{vid}_fusion.json"
        if not vid or not f.exists():
            return
        try:
            fusion = json.load(open(f))
        except Exception:
            return
        self.llm.handle_analysis_complete(
            {"video_id": vid,
             "fusion_result": fusion.get("fusion_result", fusion)})

    # -- public --------------------------------------------------------------
    def submit_video(self, video_path: Path,
                     video_id: Optional[str] = None) -> str:
        """Upload a video; the reactive chain does the rest."""
        return self.driver.ingest(video_path, video_id)

    def wait_for_analysis(self, video_id: str,
                          timeout_s: float = 120.0) -> Optional[Dict]:
        deadline = time.time() + timeout_s
        f = self.dirs.results_for("fusion") / f"{video_id}_fusion.json"
        while time.time() < deadline:
            if f.exists():
                return json.load(open(f))
            time.sleep(0.2)
        return None

    def close(self):
        self.bus.shutdown()
        if self._batcher is not None:
            self._batcher.stop()
        if self.server is not None:
            self.server.stop()
