"""Training loop for the relational heads (GraphGPS + Graphormer) (port of
``lameness_tpu/pipeline/graph_training.py``).

Both dense heads train at their serving widths on the labeled cow graph:
node features come from the per-video result files (the 50-d assembly the
graph runner uses), and the loss is masked BCE over the labeled nodes plus
graph-level BCE against the mean label.  Training is full-batch and
deterministic (no dropout), each head with its own
``clip_by_global_norm(0.5)`` + ``adamw(lr)``; the best epoch's weights are
saved under ``<models_dir>/{gnn,graphormer}/params.torch``.  As in the JAX
package, nothing loads those checkpoints yet: the graph runner serves its
seeded weights (or a caller's).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..graph import build as gb
from ..models.graphgps import EnhancedGraphGPS
from ..models.graphormer import CowLamenessGraphormer
from ..serve.graph_runner import (embedding_for_video, gnn_inputs, gt_inputs,
                                  node_features_for_video, on_device)
from ..weights import seeded_state_dict
from .checkpoint import save_params
from .optim import Optimizer


def build_graph_dataset(dirs, max_nodes: int = 64
                        ) -> Optional[Dict[str, Any]]:
    """Labeled videos with features -> one dense padded graph + label mask."""
    labels_dir = dirs.training / "labels"
    if not labels_dir.exists():
        return None
    vids, feats, embs, labels = [], [], [], []
    for label_file in sorted(labels_dir.glob("*_label.json")):
        vid = label_file.stem.replace("_label", "")
        try:
            with open(label_file) as f:
                label = json.load(f).get("label")
        except (OSError, ValueError):
            continue
        nf = node_features_for_video(dirs, vid)
        emb = embedding_for_video(dirs, vid)
        if label is None or nf is None or emb is None:
            continue
        vids.append(vid)
        feats.append(nf)
        embs.append(emb[:32])
        labels.append(float(label))
    if len(vids) < 2 or len(set(labels)) < 2:
        return None
    vids = vids[:max_nodes]
    g = gb.build_dense_graph(np.stack(feats)[:max_nodes],
                             np.stack(embs)[:max_nodes],
                             video_ids=vids, max_nodes=max_nodes)
    y = np.zeros(max_nodes, np.float32)
    y[:len(labels[:max_nodes])] = labels[:max_nodes]
    label_mask = np.zeros(max_nodes, bool)
    label_mask[:len(vids)] = True
    g["x"] = gb.standardize_features(g["x"], g["node_mask"])
    g["labels"] = y
    g["label_mask"] = label_mask
    g["lap_pe"] = gb.laplacian_pe(g["edge_mask"], g["node_mask"], 8)
    g["rw_pe"] = gb.random_walk_pe(g["edge_mask"], g["node_mask"], 16)
    g["spd"] = gb.shortest_path_dense(g["edge_mask"], g["node_mask"], 10)
    g["din"], g["dout"] = gb.degrees(g["edge_mask"], g["node_mask"])
    g["video_ids"] = vids
    return g


def _bce(p, y, mask):
    p = p.clamp(1e-6, 1 - 1e-6)
    per = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return (per * mask).sum() / mask.sum().clamp(min=1)


def graph_loss(model: torch.nn.Module, args: Sequence[torch.Tensor],
               y: torch.Tensor, lm: torch.Tensor, mean_label: float
               ) -> torch.Tensor:
    """Masked node BCE + 0.2 · graph BCE against the mean label, from a
    deterministic forward of ``model`` on ``args``."""
    out = model(*args)
    loss = _bce(out["node_pred"][0, :, 0], y, lm)
    gp = out["graph_pred"].reshape(-1)[0]
    return loss + 0.2 * _bce(gp, mean_label, torch.ones_like(gp))


def fit_graph_head(model: torch.nn.Module, args, y, lm, mean_label: float,
                   epochs: int, lr: float, patience: int):
    """Train one head (its own clipped optimizer: sharing one would let the
    head with larger gradients starve the other); returns the best epoch
    ({"loss", "epoch", "params": state dict}) and the loss history."""
    # clip: the first full-batch steps carry ~80+ global grad norm, which
    # kills the relu heads (outputs collapse to exactly 0.5)
    opt = Optimizer(model.parameters(), lr, max_norm=0.5)
    history = []
    best = {"loss": np.inf, "epoch": -1,
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}
    for epoch in range(epochs):
        loss = graph_loss(model, args, y, lm, mean_label)
        opt.step(loss)
        loss = loss.item()
        history.append(loss)
        if loss < best["loss"]:
            # as in the JAX loop: the weights after the step, beside the
            # loss taken before it
            best = {"loss": loss, "epoch": epoch,
                    "params": {k: v.detach().clone()
                               for k, v in model.state_dict().items()}}
        if epoch - best["epoch"] >= patience:
            break
    return best, history


def train_graph_heads(dirs, models_dir: Path, epochs: int = 600,
                      lr: float = 3e-4, seed: int = 0,
                      patience: int = 150,
                      dataset: Optional[Dict[str, Any]] = None,
                      device=None) -> Dict[str, Any]:
    """Train both graph heads at their serving widths on ``device``
    (``None``: the card; raises without one) from weights seeded with
    ``seed``; checkpoints the best epoch of each."""
    g = dataset if dataset is not None else build_graph_dataset(dirs)
    if g is None:
        return {"status": "failed",
                "error": "need >=2 labeled videos of both classes with "
                         "dinov3 results"}
    dev = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    gnn = EnhancedGraphGPS(device=dev)
    gnn.load_state_dict(seeded_state_dict(gnn, init))
    gt = CowLamenessGraphormer(device=dev)
    gt.load_state_dict(seeded_state_dict(gt, init))
    y = torch.from_numpy(g["labels"]).to(dev)
    lm = torch.from_numpy(g["label_mask"].astype(np.float32)).to(dev)
    mean_label = float((g["labels"] * g["label_mask"]).sum()
                       / max(1, g["label_mask"].sum()))
    mask = g["label_mask"]

    results = {}
    for name, model, args in (("gnn", gnn, on_device(gnn_inputs(g), dev)),
                              ("graphormer", gt,
                               on_device(gt_inputs(g), dev))):
        best, history = fit_graph_head(model, args, y, lm, mean_label,
                                       epochs, lr, patience)
        model.load_state_dict(best["params"])
        with torch.no_grad():
            node = model(*args)["node_pred"][0, :, 0].cpu().numpy()
        acc = float(((node > 0.5) == (g["labels"] > 0.5))[mask].mean())
        save_params(models_dir, name, best["params"])
        results[name] = (best, history, acc)

    (best_gnn, hist_gnn, acc_gnn), (best_gt, hist_gt, acc_gt) = \
        results["gnn"], results["graphormer"]
    return {"status": "completed", "num_nodes": int(mask.sum()),
            "epochs_run": {"gnn": len(hist_gnn), "graphormer": len(hist_gt)},
            "best_loss": best_gnn["loss"] + best_gt["loss"],
            "train_accuracy": {"gnn": acc_gnn, "graphormer": acc_gt},
            "loss_history": (hist_gnn + hist_gt)[:200]}
