"""bf16 policy for the engine (port of ``lameness_tpu/pipeline/precision.py``).

The encoders (YOLO, DINO, the trained pose model, the SAM image encoder)
run in bf16.  These stay
f32, by the JAX policy's rule: BatchNorm stats and scale/bias (the BN
module casts its output back to the input dtype), the SAM neck LayerNorm2d
(its f32 output promotes the neck's last conv and feeds the decoder in
f32), the SAM prompt encoder and mask decoder, and the sequence heads.
Transformer LayerNorm weights are cast (f32 ones would promote every
following matmul back to f32).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def keep_f32(name: str) -> bool:
    """Whether the parameter ``name`` (a state-dict key) stays f32."""
    n = name.lower()
    if any(seg.startswith("bn") for seg in n.split(".")):
        return True
    if "_ln" in n or "mean" in n or "var" in n:
        return True
    return "mask_decoder" in n or "prompt_encoder" in n


def cast_module_bf16(module: nn.Module) -> None:
    """In place: float32 parameters to bf16, except the f32 islands."""
    for name, p in module.named_parameters():
        if p.dtype == torch.float32 and not keep_f32(name):
            p.data = p.data.to(torch.bfloat16)


def recast_installed(name: str, module: nn.Module) -> str:
    """The policy's cast of one sub-model (by engine name), also for a
    module built after the policy was applied (a SAM rebuilt at another
    variant, a new pose model).  Returns what was cast."""
    if name in ("yolo", "dino", "pose"):
        cast_module_bf16(module)
        return "bf16 (bn stats f32)"
    if name == "sam":
        cast_module_bf16(module.vision_encoder)
        return "encoder bf16, prompt+decoder f32"
    return "f32"


def apply_engine_policy(engine) -> Dict[str, str]:
    """bf16 encoders (YOLO, DINO, the trained pose model, SAM's image
    encoder), f32 heads and SAM decoder; sets ``spec.dtype``.  Returns what
    was cast."""
    summary = {}
    for name in ("yolo", "dino", "pose", "sam"):
        module = engine.pose_model if name == "pose" \
            else getattr(engine, name)
        if module is not None:
            summary[name] = recast_installed(name, module)
    engine.spec.dtype = torch.bfloat16
    return summary
