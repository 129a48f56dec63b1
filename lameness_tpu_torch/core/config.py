"""The slice of ``lameness_tpu/core/config.py`` the clip engine reads.

Only the fields the engine uses, with the JAX package's defaults; nothing
outside the standard library is imported (the JAX config loads YAML).
"""
from __future__ import annotations

from dataclasses import dataclass, field


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
class TcnConfig:
    mc_samples: int = 10


@dataclass(frozen=True)
class ComputeConfig:
    dtype: str = "bfloat16"             # encoders' weights/activations


@dataclass(frozen=True)
class Config:
    yolo: YoloConfig = field(default_factory=YoloConfig)
    sam: SamConfig = field(default_factory=SamConfig)
    tcn: TcnConfig = field(default_factory=TcnConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
