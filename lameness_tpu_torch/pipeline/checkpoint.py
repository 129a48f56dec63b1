"""The reference's torch checkpoints into an engine (port of the torch half
of ``lameness_tpu/pipeline/checkpoint.py``).

The reference loads each model's weights if its file exists and falls back
otherwise (SURVEY.md §2.8): ``restore_engine`` looks for
``<models_dir>/{yolo,dino,sam,pose}/*.pt|*.pth|*.bin`` and installs what it
finds through ``LamenessEngine.load_torch_weights``.  The JAX package also
restores its own orbax (or pickle) param trees first; that half waits for
the port's own checkpoint format, which comes with training (ROADMAP.md §1
item 9).
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def try_load_torch(models_dir: Path, name: str) -> Optional[Dict[str, Any]]:
    """The first state dict under ``models_dir/name`` (``*.pt``, then
    ``*.pth``, then ``*.bin``, each in name order), loaded with
    ``weights_only=True`` onto the CPU; None when there is none."""
    d = Path(models_dir) / name
    if not d.exists():
        return None
    for pattern in ("*.pt", "*.pth", "*.bin"):
        for f in sorted(d.glob(pattern)):
            try:
                obj = torch.load(f, map_location="cpu", weights_only=True)
            except Exception as exc:     # not a torch file: try the next
                print(f"try_load_torch: {f} not loaded ({exc})",
                      file=sys.stderr, flush=True)
                continue
            if isinstance(obj, dict):
                return obj
    return None


def restore_engine(engine, models_dir: Path) -> Dict[str, bool]:
    """Install whichever torch checkpoints exist into ``engine``; returns
    {name: installed}.  A pose checkpoint is not installed into an engine
    with ``pose_pixels=False`` (its wire carries no pose frames), and one
    that fails to convert is reported and left out, as in the JAX
    package."""
    loaded: Dict[str, bool] = {}
    for name in ("yolo", "dino", "sam", "tcn", "gait"):
        if getattr(engine, name) is None:
            continue
        sd = try_load_torch(models_dir, name)
        loaded[name] = False
        if sd is not None and name in ("yolo", "dino", "sam"):
            loaded[name] = _load(engine, name, sd)
    pose_dir = Path(models_dir) / "pose"
    if pose_dir.exists() and not engine.spec.pose_pixels:
        print("restore_engine: pose checkpoint present but the engine "
              "spec has pose_pixels=False (heuristic-pose wire trim) — "
              "NOT installing; rebuild with pose_pixels=True to use it",
              file=sys.stderr, flush=True)
        loaded["pose"] = False
    elif pose_dir.exists():
        sd = try_load_torch(models_dir, "pose")
        if sd is not None:
            loaded["pose"] = _load(engine, "pose", sd)
    return loaded


def _load(engine, name: str, sd) -> bool:
    try:
        engine.load_torch_weights(name, sd)
    except Exception as exc:
        print(f"restore_engine: {name} checkpoint not installed ({exc!r})",
              file=sys.stderr, flush=True)
        return False
    return True
