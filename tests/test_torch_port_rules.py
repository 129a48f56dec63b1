"""Rules of the PyTorch/CUDA port (``lameness_tpu_torch``, ``chip_smoke.py``):
no JAX and nothing of the JAX package, no OpenCV (the machine with the card
has none), the card by default, and the PERF.md kernel table."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "lameness_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "emulate_cuda_kernels.py",
    ROOT / "scripts" / "ab_kernels.py", ROOT / "scripts" / "k5_breakdown.py",
    ROOT / "scripts" / "window_breakdown.py",
    ROOT / "scripts" / "k1_breakdown.py", ROOT / "scripts" / "k1_phases.py",
    ROOT / "scripts" / "ab_engine.py"]


def test_import_leaves_jax_out():
    """Importing the port loads no JAX, nothing of the JAX package, no
    OpenCV, and none of the libraries the card's machine lacks (optax,
    orbax, joblib, sklearn, the boosting libraries, lap, PyYAML)."""
    code = ("import sys, lameness_tpu_torch.pipeline.engine, "
            "lameness_tpu_torch.pipeline.checkpoint, "
            "lameness_tpu_torch.video.yuv, lameness_tpu_torch.weights, "
            "lameness_tpu_torch.video.decode, "
            "lameness_tpu_torch.video.curation, "
            "lameness_tpu_torch.core.config, lameness_tpu_torch.__main__, "
            "lameness_tpu_torch.serve.driver, "
            "lameness_tpu_torch.serve.graph_runner, "
            "lameness_tpu_torch.track.assignment, "
            "lameness_tpu_torch.track.bytetrack, "
            "lameness_tpu_torch.track.device_tracker, "
            "lameness_tpu_torch.track.kalman, "
            "lameness_tpu_torch.track.reid, "
            "lameness_tpu_torch.fuse.fusion, "
            "lameness_tpu_torch.fuse.stacking, "
            "lameness_tpu_torch.ml.ensemble, "
            "lameness_tpu_torch.ml.gbdt_train, "
            "lameness_tpu_torch.ml.training, "
            "lameness_tpu_torch.models.sequence_features, "
            "lameness_tpu_torch.pipeline.optim, "
            "lameness_tpu_torch.pipeline.evaluation, "
            "lameness_tpu_torch.pipeline.head_training, "
            "lameness_tpu_torch.pipeline.detect_training, "
            "lameness_tpu_torch.pipeline.pose_training, "
            "lameness_tpu_torch.pipeline.graph_training; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lameness_tpu', "
            "'cv2', 'joblib', 'sklearn', 'catboost', 'xgboost', 'lightgbm', "
            "'lap', 'yaml')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    """(line, top-level module) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    for line, top in _imports(path):
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                           "lameness_tpu"), \
            f"{path.name}:{line} imports {top}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "lameness_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_cv2_imports(path):
    """The host-side converters of the port (I420, the split-ingest
    resize) are its own: the machine with the card has no OpenCV."""
    for line, top in _imports(path):
        assert top != "cv2", f"{path.name}:{line} imports cv2"


def test_engine_needs_cuda_unless_cpu(monkeypatch):
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LamenessEngine(spec=EngineSpec(use_sam_model=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        TCN()
    eng = LamenessEngine(spec=EngineSpec(use_sam_model=False),
                         device="cpu", init_models=False)
    assert eng.device.type == "cpu"
    # with a card, the default is the current device with its index: a
    # tensor on it reports cuda:0, which an unindexed "cuda" does not equal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    eng = LamenessEngine(spec=EngineSpec(use_sam_model=False),
                         init_models=False)
    assert eng.device == torch.device("cuda", 0)
    assert eng.device.index == 0


def test_perf_md_lists_all_nine_kernels():
    text = (ROOT / "PERF.md").read_text()
    for kid, where in [("K1", "ops/attention.py:50"),
                       ("K2", "ops/sam_attention.py:586"),
                       ("K3", "ops/sam_attention.py:216"),
                       ("K4", "sam_attention.py:32"),
                       ("K5", "sam_attention.py:137"),
                       ("K6", "sam_attention.py:492"),
                       ("K7", "sam_attention.py:309"),
                       ("K8", "sam_attention.py:398"),
                       ("K9", "sam_attention.py:688")]:
        assert re.search(rf"\|\s*{kid}\s*\|[^\n]*{re.escape(where)}", text), \
            kid
