"""The slice of ``lameness_tpu/core/config.py`` the clip engine, the
serving driver, curation, the graph runner and the platform (the app, the
admin API, the database) read.

Only the fields they use, with the JAX package's defaults, and
``Config.load`` (the data root and the YAML overlay).  Nothing outside the
standard library is imported at module level: ``yaml`` only when a file is
given (PyYAML is not a dependency of the port).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Subjects:
    """The bus subjects, the system's true API (shared/config/config.yaml:5-30)."""
    video_uploaded: str = "video.uploaded"
    video_preprocessed: str = "video.preprocessed"
    video_curated: str = "video.curated"
    pipeline_yolo: str = "pipeline.yolo"
    pipeline_sam3: str = "pipeline.sam3"
    pipeline_dinov3: str = "pipeline.dinov3"
    pipeline_tleap: str = "pipeline.tleap"
    pipeline_tcn: str = "pipeline.tcn"
    pipeline_transformer: str = "pipeline.transformer"
    pipeline_ml: str = "pipeline.ml"
    pipeline_gnn: str = "pipeline.gnn"
    pipeline_graph_transformer: str = "pipeline.graph_transformer"
    pipeline_fusion: str = "pipeline.fusion"
    tracking_complete: str = "tracking.complete"
    tracking_reid_match: str = "tracking.reid.match"
    tracking_lameness_update: str = "tracking.lameness.update"
    analysis_complete: str = "analysis.complete"
    explanation_requested: str = "explanation.requested"
    training_data_added: str = "training.data.added"
    training_yolo_requested: str = "training.yolo.requested"
    training_ml_requested: str = "training.ml.requested"
    training_completed: str = "training.completed"
    hitl_comparison_requested: str = "hitl.comparison.requested"
    hitl_comparison_submitted: str = "hitl.comparison.submitted"
    rater_reliability_updated: str = "rater.reliability.updated"
    cow_prediction_updated: str = "cow.prediction.updated"

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class DataDirs:
    """The data directories (shared/config/config.yaml:41-47)."""
    root: str = "data"

    @property
    def videos(self) -> Path: return Path(self.root) / "videos"
    @property
    def processed(self) -> Path: return Path(self.root) / "processed"
    @property
    def canonical(self) -> Path: return Path(self.root) / "canonical"
    @property
    def training(self) -> Path: return Path(self.root) / "training"
    @property
    def results(self) -> Path: return Path(self.root) / "results"
    @property
    def quality_reports(self) -> Path: return Path(self.root) / "quality_reports"
    @property
    def rater_reliability(self) -> Path: return Path(self.root) / "rater_reliability"
    @property
    def models(self) -> Path: return Path(self.root) / "models"

    def results_for(self, pipeline: str) -> Path:
        return self.results / pipeline

    def ensure(self) -> "DataDirs":
        for p in (self.videos, self.processed, self.canonical, self.training,
                  self.results, self.quality_reports, self.rater_reliability,
                  self.models):
            p.mkdir(parents=True, exist_ok=True)
        return self


@dataclass(frozen=True)
class CurationConfig:
    """Clip curation (clip-curation/app/main.py:74-78 and 379-386)."""
    target_fps: int = 25
    target_width: int = 1280
    target_height: int = 720
    target_duration_s: float = 5.0
    min_pass_frames: int = 30
    window_step_frac: float = 0.25      # slide step = 25% of window
    # six-part weighted window score (clip-curation:379-386)
    w_framing: float = 0.25
    w_steadiness: float = 0.25
    w_straightness: float = 0.15
    w_visual: float = 0.15
    w_occlusion: float = 0.10
    w_progress: float = 0.10

    @property
    def clip_frames(self) -> int:
        return int(round(self.target_fps * self.target_duration_s))  # 125


@dataclass(frozen=True)
class YoloConfig:
    """YOLOv8-style detector (yolo-pipeline/app/main.py:37,67)."""
    confidence_threshold: float = 0.5
    num_classes: int = 80               # COCO fallback; cow class id 19
    cow_class_id: int = 19


@dataclass(frozen=True)
class SamConfig:
    """SAM ViT encoder + mask decoder (sam3-pipeline/app/main.py:51-100)."""
    variant: str = "vit_b"              # vit_b / vit_l / vit_h
    # the single-card memory governor: EngineSpec.sam_encode_chunk (0 = the
    # whole batch in one call)
    encode_chunk: int = 0


@dataclass(frozen=True)
class DinoConfig:
    """DINOv2-base embeddings (dinov3-pipeline/app/main.py:30-36,95-127):
    the similar cases a result lists."""
    top_k_similar: int = 5


@dataclass(frozen=True)
class TcnConfig:
    mc_samples: int = 10


@dataclass(frozen=True)
class ComputeConfig:
    dtype: str = "bfloat16"             # encoders' weights/activations


@dataclass(frozen=True)
class ReidConfig:
    """Re-ID thresholds and the vector collections (matcher.py:52-54)."""
    strong_match_threshold: float = 0.85
    match_threshold: float = 0.75
    weak_match_threshold: float = 0.65
    momentum: float = 0.9
    embedding_dim: int = 768
    collection_embeddings: str = "cow_embeddings"
    collection_identities: str = "cow_identities"
    # a Qdrant REST server (io/vecstore.make_store gives its client,
    # io/qdrant_wire.QdrantRestStore, when the URL answers the protocol);
    # None = the in-process store
    vector_url: Optional[str] = None


@dataclass(frozen=True)
class GraphGPSConfig:
    """The graph runner's kNN degree and dense padding bound."""
    k_nn: int = 5
    max_nodes: int = 128                # dense padding bound (graphs are tiny)


@dataclass(frozen=True)
class DbConfig:
    """The database (admin-interface/backend/app/database.py:16): None is
    the SQLite file under the data root; a ``postgres://`` or
    ``postgresql://`` URL is a Postgres server, spoken to over the wire
    protocol (``io/db.py`` ``open_database``, ``io/pg_wire.py``).
    ``Config.load`` honours ``DATABASE_URL`` as the reference does."""
    url: Optional[str] = None


@dataclass(frozen=True)
class MLConfig:
    """The tabular ensemble and its training (training-service/app/main.py
    :205-219, routers/ml_config.py)."""
    n_estimators: int = 100
    learning_rate: float = 0.1
    max_depth: int = 6
    cv_folds: int = 5
    min_new_videos: int = 10


@dataclass(frozen=True)
class Config:
    subjects: Subjects = field(default_factory=Subjects)
    dirs: DataDirs = field(default_factory=DataDirs)
    curation: CurationConfig = field(default_factory=CurationConfig)
    yolo: YoloConfig = field(default_factory=YoloConfig)
    sam: SamConfig = field(default_factory=SamConfig)
    dino: DinoConfig = field(default_factory=DinoConfig)
    tcn: TcnConfig = field(default_factory=TcnConfig)
    graphgps: GraphGPSConfig = field(default_factory=GraphGPSConfig)
    reid: ReidConfig = field(default_factory=ReidConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    ml: MLConfig = field(default_factory=MLConfig)
    db: DbConfig = field(default_factory=DbConfig)

    @staticmethod
    def load(path: Optional[str] = None,
             data_root: Optional[str] = None) -> "Config":
        """The defaults with the data root (``data_root``, else
        ``LAMENESS_DATA_ROOT``, else "data"), and optionally a YAML file in
        the reference's shared/config/config.yaml layout overlaid: YOLO's
        ``models.yolo.confidence_threshold`` and ``data.videos_dir`` (its
        parent is the data root).  ``DATABASE_URL``, when set, is the
        database URL (``DbConfig.url``)."""
        if data_root is None:
            data_root = os.environ.get("LAMENESS_DATA_ROOT", "data")
        cfg = dataclasses.replace(Config(), dirs=DataDirs(root=data_root))
        if os.environ.get("DATABASE_URL"):
            cfg = dataclasses.replace(
                cfg, db=DbConfig(url=os.environ["DATABASE_URL"]))
        if path and Path(path).exists():
            import yaml
            with open(path) as f:
                raw: Dict[str, Any] = yaml.safe_load(f) or {}
            y = raw.get("models", {}).get("yolo", {})
            if "confidence_threshold" in y:
                cfg = dataclasses.replace(
                    cfg, yolo=dataclasses.replace(
                        cfg.yolo,
                        confidence_threshold=float(y["confidence_threshold"])))
            d = raw.get("data", {})
            if "videos_dir" in d:
                root = str(Path(d["videos_dir"]).parent)
                cfg = dataclasses.replace(cfg, dirs=DataDirs(root=root))
        return cfg
