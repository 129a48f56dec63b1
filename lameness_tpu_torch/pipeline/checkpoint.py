"""Checkpoints: the port's own, the JAX package's pickles and the
reference's torch files (port of ``lameness_tpu/pipeline/checkpoint.py``).

The reference loads each model's weights if its file exists and falls back
otherwise (SURVEY.md §2.8).  Under ``<models_dir>/<name>/``:

- ``params.torch``: the port's own format, a CPU ``state_dict`` written by
  ``torch.save`` (``save_params``; ``load_params`` reads it with
  ``weights_only``).  The suffix keeps it out of ``try_load_torch``'s
  globs, which would take it for a reference checkpoint.
- ``params.pkl``: the JAX package's pickle fallback, a nested dict of numpy
  arrays (its flax tree), read by ``load_jax_params`` through a restricted
  unpickler and installed through ``weights.from_jax_params``.  The JAX
  package's orbax directory (``params/``) is reported and skipped: orbax
  is JAX's, and the card's machine has none.
- ``*.pt|*.pth|*.bin``: the reference's torch checkpoints
  (``try_load_torch``), converted by ``LamenessEngine.load_torch_weights``.

``restore_engine`` tries the three in that order for each sub-model.
"""
from __future__ import annotations

import io
import os
import pickle
import sys
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

PARAMS_FILE = "params.torch"
JAX_PICKLE = "params.pkl"
ENGINE_MODELS = ("yolo", "dino", "sam", "tcn", "gait")


def save_params(models_dir: Path, name: str,
                params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                ) -> Path:
    """Write one sub-model's state dict (a module's, or a mapping of
    tensors) to ``<models_dir>/<name>/params.torch`` on the CPU, through a
    temporary file, so a reader never sees half of it."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    path = Path(models_dir) / name / PARAMS_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(PARAMS_FILE + ".tmp")
    torch.save({k: v.detach().to("cpu", copy=True) for k, v in sd.items()},
               tmp)
    os.replace(tmp, path)
    return path


def load_params(models_dir: Path, name: str
                ) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict ``save_params`` wrote for ``name`` (CPU tensors), or
    None when there is none."""
    path = Path(models_dir) / name / PARAMS_FILE
    if not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class _NumpyTreeUnpickler(pickle.Unpickler):
    """Unpickles dicts, lists and numpy arrays, and nothing else (no code
    from the file runs)."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "numpy" or (module, name) in (
                ("collections", "OrderedDict"), ("builtins", "dict"),
                ("builtins", "list"), ("builtins", "tuple")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not part of a "
                                     f"numpy param tree")


def load_jax_params(models_dir: Path, name: str) -> Optional[Any]:
    """The JAX package's pickle fallback for ``name`` (its flax tree, numpy
    leaves), or None when there is none or it is not such a tree.  An orbax
    checkpoint is reported and skipped."""
    d = Path(models_dir) / name
    pkl = d / JAX_PICKLE
    if pkl.exists():
        try:
            return _NumpyTreeUnpickler(io.BytesIO(pkl.read_bytes())).load()
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError) as exc:
            print(f"load_jax_params: {pkl} not loaded ({exc})",
                  file=sys.stderr, flush=True)
            return None
    if (d / "params").is_dir():
        print(f"load_jax_params: {d / 'params'} is an orbax checkpoint of "
              f"the JAX package; orbax is not available to the port, "
              f"skipped", file=sys.stderr, flush=True)
    return None


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


def _restore_one(engine, models_dir: Path, name: str) -> bool:
    """The port's own checkpoint, then the JAX pickle, then the torch
    formats (yolo, dino, sam and pose only); True once one installs."""
    sd = load_params(models_dir, name)
    if sd is not None and _try(name, "params.torch",
                               engine.install_state_dict, name, sd):
        return True
    tree = load_jax_params(models_dir, name)
    if tree is not None and _try(name, JAX_PICKLE,
                                 engine.install_jax_params, name, tree):
        return True
    if name in ("yolo", "dino", "sam", "pose"):
        sd = try_load_torch(models_dir, name)
        if sd is not None:
            return _try(name, "torch checkpoint", engine.load_torch_weights,
                        name, sd)
    return False


def _try(name: str, what: str, fn, *args) -> bool:
    try:
        fn(*args)
    except Exception as exc:
        print(f"restore_engine: {name} checkpoint not installed ({what}: "
              f"{exc!r})", file=sys.stderr, flush=True)
        return False
    return True


def restore_engine(engine, models_dir: Path) -> Dict[str, bool]:
    """Install whichever checkpoints exist into ``engine``; returns {name:
    installed}.  A pose checkpoint is not installed into an engine with
    ``pose_pixels=False`` (its wire carries no pose frames), and one that
    fails to install is reported and left out, as in the JAX package."""
    loaded: Dict[str, bool] = {}
    for name in ENGINE_MODELS:
        if getattr(engine, name) is not None:
            loaded[name] = _restore_one(engine, models_dir, name)
    pose_dir = Path(models_dir) / "pose"
    if pose_dir.exists() and not engine.spec.pose_pixels:
        print("restore_engine: pose checkpoint present but the engine "
              "spec has pose_pixels=False (heuristic-pose wire trim) — "
              "NOT installing; rebuild with pose_pixels=True to use it",
              file=sys.stderr, flush=True)
        loaded["pose"] = False
    elif pose_dir.exists():
        loaded["pose"] = _restore_one(engine, models_dir, "pose")
    return loaded
