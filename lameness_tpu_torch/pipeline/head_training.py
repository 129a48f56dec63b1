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
the JAX package.  With ``mesh=`` the heads are replicated over the data
axis and a batch that the data axis divides is split over it, as in the JAX
package: each data shard runs both heads on its rows (on its own device; a
replica on the training device is the modules themselves), the loss is the
global batch's, and each shard draws its rows of the masks the whole batch
draws (``pipeline/train.py`` ``RowDraws``), so the run equals the
unsharded one up to float reassociation.
"""
from __future__ import annotations

import copy
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


def sharded_heads_loss(replicas, x: torch.Tensor, m: torch.Tensor,
                       y: torch.Tensor, generator: torch.Generator):
    """``heads_loss`` with the batch split over the data shards:
    ``replicas`` one (device, tcn, gait) per data shard.  Each shard takes
    its rows of the whole batch's dropout draws; the caller's generator
    moves on as one ``heads_loss`` call moves it."""
    from .train import RowDraws
    b, dp = len(y), len(replicas)
    per = b // dp
    first = x.device
    tps, gps = [], []
    for d, (dev, tcn, gait) in enumerate(replicas):
        g = torch.Generator(device=dev)
        g.set_state(generator.get_state())
        draws = RowDraws(g, b, d * per, (d + 1) * per)
        rows = slice(d * per, (d + 1) * per)
        xd, md = x[rows].to(dev), m[rows].to(dev)
        tps.append(tcn(xd, generator=draws)[:, 0].to(first))
        gps.append(gait(xd, md, generator=draws)["probability"][:, 0]
                   .to(first))
    generator.set_state(g.get_state())
    tp, gp = torch.cat(tps), torch.cat(gps)
    return _bce(tp, y) + _bce(gp, y), (tp, gp)


def _snapshot(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def train_heads(dirs, models_dir: Path, epochs: int = 50,
                batch_size: int = 16, lr: float = 1e-3,
                seed: int = 0, mesh=None,
                dataset: Optional[Dict[str, np.ndarray]] = None,
                device=None) -> Dict[str, Any]:
    """Joint BCE training of TCN + GaitTransformer on ``device`` (``None``:
    the card; raises without one); checkpoints the best epoch.  ``mesh``: a
    (data, model) mesh whose data axis splits the batches (the models live
    on ``device``; the first data position should be it)."""
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
    replicas, groups = [], []
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS
        for rdev in mesh.devices[:, 0]:
            if rdev == dev:
                replicas.append((dev, tcn, gait))
                continue
            copies = [copy.deepcopy(m).to(rdev) for m in (tcn, gait)]
            replicas.append((rdev, *copies))
            for mod, cp in zip((tcn, gait), copies):
                for p, q in zip(mod.parameters(), cp.parameters()):
                    groups.append([p, q])
        dp = mesh.shape[DATA_AXIS]
    params = [*tcn.parameters(), *gait.parameters()]
    params += [q for group in groups for q in group[1:]]
    opt = Optimizer(params, lr, max_norm=1.0, replicas=_merge(groups))
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
            if replicas and len(idx) % dp == 0:
                loss, _ = sharded_heads_loss(replicas, x_all[idx],
                                             m_all[idx], y_all[idx], dropout)
            else:
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


def _merge(pairs):
    """[param, copy] pairs -> one group per parameter (all its copies)."""
    groups: Dict[int, list] = {}
    for p, q in pairs:
        groups.setdefault(id(p), [p]).append(q)
    return list(groups.values())
