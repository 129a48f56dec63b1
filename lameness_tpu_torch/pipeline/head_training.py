"""Training loop for the sequence lameness heads (TCN + GaitTransformer)
(port of ``lameness_tpu/pipeline/head_training.py``).

Given labeled videos (``data/training/labels``) whose tleap results exist,
build the 44-d 125-frame sequence dataset, train both heads jointly (BCE,
``clip_by_global_norm(1)`` + ``adamw(lr)``, dropout on, early stopping
after 10 epochs without a better epoch loss), and checkpoint the best
epoch's weights where ``restore_engine`` picks them up
(``<models_dir>/{tcn,gait}/params.torch``).

Dropout masks come from a ``torch.Generator`` on the training device seeded
with ``seed``; the epoch order from ``np.random.default_rng(seed)``, as in
the JAX package.  The JAX module's data-parallel mesh is not ported.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import sequence_features as seqf
from ..models.gait_transformer import GaitTransformer
from ..models.tcn import TCN
from ..weights import seeded_state_dict
from .checkpoint import save_params
from .optim import Optimizer


def build_dataset(dirs) -> Optional[Dict[str, np.ndarray]]:
    """Labeled videos × tleap results -> (features, masks, labels)."""
    labels_dir = dirs.training / "labels"
    if not labels_dir.exists():
        return None
    feats, masks, labels, vids = [], [], [], []
    for label_file in sorted(labels_dir.glob("*_label.json")):
        vid = label_file.stem.replace("_label", "")
        try:
            with open(label_file) as f:
                label = json.load(f).get("label")
        except (OSError, ValueError):
            continue
        if label is None:
            continue
        tleap_file = dirs.results_for("tleap") / f"{vid}_tleap.json"
        if not tleap_file.exists():
            continue
        with open(tleap_file) as f:
            tleap = json.load(f)
        f, m = seqf.extract_from_pose_sequences(
            tleap.get("pose_sequences", []))
        if f is None:
            continue
        f, m = seqf.pad_or_truncate(f, m)
        feats.append(f)
        masks.append(m)
        labels.append(int(label))
        vids.append(vid)
    if len(labels) < 2 or len(set(labels)) < 2:
        return None
    return {"features": np.stack(feats), "masks": np.stack(masks),
            "labels": np.asarray(labels, np.float32), "video_ids": vids}


def _bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-6, 1 - 1e-6)
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()


def heads_loss(tcn: TCN, gait: GaitTransformer, x: torch.Tensor,
               m: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Joint BCE of both heads on (B, T, 44) features, (B, T) masks and
    (B,) labels; dropout on when ``generator`` is given (TCN's masks drawn
    first).  Returns (loss, (tcn probs, gait probs))."""
    tp = tcn(x, generator=generator)[:, 0]
    gp = gait(x, m, generator=generator)["probability"][:, 0]
    return _bce(tp, y) + _bce(gp, y), (tp, gp)


def _snapshot(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def train_heads(dirs, models_dir: Path, epochs: int = 50,
                batch_size: int = 16, lr: float = 1e-3,
                seed: int = 0,
                dataset: Optional[Dict[str, np.ndarray]] = None,
                device=None) -> Dict[str, Any]:
    """Joint BCE training of TCN + GaitTransformer on ``device`` (``None``:
    the card; raises without one); checkpoints the best epoch."""
    data = dataset if dataset is not None else build_dataset(dirs)
    if data is None:
        return {"status": "failed",
                "error": "need >=2 labeled videos covering both classes "
                         "with tleap results"}
    dev = resolve_device(device)
    n = len(data["labels"])
    tcn = TCN(input_dim=44, device=dev)
    gait = GaitTransformer(input_dim=44, device=dev)
    init = torch.Generator().manual_seed(seed)
    tcn.load_state_dict(seeded_state_dict(tcn, init))
    gait.load_state_dict(seeded_state_dict(gait, init))
    opt = Optimizer([*tcn.parameters(), *gait.parameters()], lr,
                    max_norm=1.0)
    dropout = torch.Generator(device=dev).manual_seed(seed)

    x_all = torch.from_numpy(np.asarray(data["features"], np.float32)).to(dev)
    m_all = torch.from_numpy(np.asarray(data["masks"], bool)).to(dev)
    y_all = torch.from_numpy(np.asarray(data["labels"], np.float32)).to(dev)

    history = []
    np_rng = np.random.default_rng(seed)
    best = {"loss": np.inf, "tcn": _snapshot(tcn), "gait": _snapshot(gait),
            "epoch": -1}
    for epoch in range(epochs):
        order = np_rng.permutation(n)
        epoch_loss = 0.0
        steps = 0
        for i in range(0, n, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            loss, _ = heads_loss(tcn, gait, x_all[idx], m_all[idx],
                                 y_all[idx], dropout)
            opt.step(loss)
            epoch_loss += loss.item()
            steps += 1
        epoch_loss /= max(1, steps)
        history.append(epoch_loss)
        if epoch_loss < best["loss"]:
            best = {"loss": epoch_loss, "tcn": _snapshot(tcn),
                    "gait": _snapshot(gait), "epoch": epoch}
        # early stop: no improvement for 10 epochs
        if epoch - best["epoch"] >= 10:
            break

    # final train accuracy with the best params (deterministic forwards)
    tcn.load_state_dict(best["tcn"])
    gait.load_state_dict(best["gait"])
    with torch.no_grad():
        tp = tcn(x_all)[:, 0].cpu().numpy()
        gp = gait(x_all, m_all)["probability"][:, 0].cpu().numpy()
    y = data["labels"] > 0.5
    acc_tcn = float(((tp > 0.5) == y).mean())
    acc_gait = float(((gp > 0.5) == y).mean())
    save_params(models_dir, "tcn", best["tcn"])
    save_params(models_dir, "gait", best["gait"])
    return {"status": "completed", "num_samples": n,
            "epochs_run": len(history), "best_epoch": best["epoch"],
            "best_loss": best["loss"], "final_loss": history[-1],
            "train_accuracy": {"tcn": acc_tcn, "gait": acc_gait},
            "loss_history": history[:200]}
