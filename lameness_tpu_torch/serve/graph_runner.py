"""Cross-video graph-head runner: GraphGPS + Graphormer over the cow graph
(port of ``lameness_tpu/serve/graph_runner.py``).

On every new video: assemble the 50-d node features of the known videos
from their result files (pose 10 + silhouette 5 + embedding 32 + metadata
3), build the kNN + per-cow temporal dense graph on the host
(``graph/build.py``, as the JAX runner does), run both heads on the card
with 10-sample MC-dropout (one forward each over a leading sample
dimension) and a deterministic forward, and write the gnn and
graph_transformer result files.

The heads' weights are the caller's (``params``: ``weights.from_jax_params``
of a JAX runner's trees) or seeded from a ``torch.Generator``: the JAX
runner serves ``PRNGKey(0)`` initialisations, which the card, having no
JAX, cannot draw.  Each video's MC-dropout generator is seeded from
``zlib.crc32(video_id)``, so its result files are the same on every run.
"""
from __future__ import annotations

import json
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..graph import build as gb
from ..io import schemas
from ..models.graphgps import EnhancedGraphGPS
from ..models.graphormer import CowLamenessGraphormer
from ..utils.logging import get_logger
from ..weights import seeded_state_dict

LOG = get_logger("graph_runner")
MC_SAMPLES = 10


def _read_json(path) -> Optional[Dict[str, Any]]:
    if not path.exists():
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def node_features_for_video(dirs, video_id: str) -> Optional[np.ndarray]:
    """50-d node feature vector (gnn:1292-1369): pose 10 + silhouette 5 +
    embedding 32 (first components) + metadata 3."""
    feats = np.zeros(50, np.float32)

    def read(p):
        return _read_json(dirs.results_for(p) / f"{video_id}_{p}.json")

    tleap = read("tleap")
    loco = (tleap or {}).get("locomotion_features", {})
    pose_keys = ("back_arch_mean", "back_arch_std", "back_arch_score",
                 "head_bob_magnitude", "head_bob_frequency", "head_bob_score",
                 "stride_fl_mean", "stride_fr_mean", "front_leg_asymmetry",
                 "rear_leg_asymmetry")
    for i, k in enumerate(pose_keys):
        feats[i] = loco.get(k, 0.0)

    sam = read("sam3")
    sf = (sam or {}).get("aggregated_features", {})
    for i, k in enumerate(("avg_mask_area", "avg_area_ratio",
                           "avg_circularity", "avg_aspect_ratio")):
        feats[10 + i] = sf.get(k, 0.0)
    yolo = read("yolo")
    feats[14] = (yolo or {}).get("features", {}).get("detection_rate", 0.0)

    dino = read("dinov3")
    emb = (dino or {}).get("embedding")
    if emb:
        e = np.asarray(emb, np.float32)
        feats[15:15 + 32] = e[:32] / (np.linalg.norm(e) + 1e-8) * 10
    feats[47] = (dino or {}).get("neighbor_evidence", 0.5)
    feats[48] = len((dino or {}).get("similar_cases", []))
    feats[49] = (yolo or {}).get("features", {}).get("avg_confidence", 0.0)

    if tleap is None and dino is None and yolo is None:
        return None
    return feats


def embedding_for_video(dirs, video_id: str) -> Optional[np.ndarray]:
    f = dirs.results_for("dinov3") / f"{video_id}_dinov3.json"
    if not f.exists():
        return None
    with open(f) as fh:
        data = json.load(fh)
    emb = data.get("embedding")
    if emb is None and data.get("canonical_frames"):
        emb = np.mean([c["embedding"] for c in data["canonical_frames"]],
                      axis=0)
    return np.asarray(emb, np.float32) if emb is not None else None


def gnn_inputs(g) -> tuple:
    """GraphGPS's inputs from a dense graph (numpy): features, Laplacian and
    random-walk encodings, edge features, edge and node masks."""
    lap = gb.laplacian_pe(g["edge_mask"], g["node_mask"], 8)
    rw = gb.random_walk_pe(g["edge_mask"], g["node_mask"], 16)
    return (g["x"], lap, rw, g["edge_attr"], g["edge_mask"], g["node_mask"])


def gt_inputs(g) -> tuple:
    """Graphormer's inputs from a dense graph (numpy): features, shortest
    paths, edge features, edge mask, degrees, timestamps, node mask."""
    spd = gb.shortest_path_dense(g["edge_mask"], g["node_mask"], 10)
    din, dout = gb.degrees(g["edge_mask"], g["node_mask"])
    return (g["x"], spd, g["edge_attr"], g["edge_mask"], din, dout,
            g["timestamps"], g["node_mask"])


def on_device(arrays, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


class GraphHeadRunner:
    def __init__(self, config: Config, bus=None,
                 max_nodes: Optional[int] = None, device=None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        """``params``: {"gnn": state dict, "gt": state dict}, else weights
        drawn from a generator seeded with 0."""
        self.config = config
        self.dirs = config.dirs
        self.bus = bus
        # the padding bound is a LIVE config knob (graphgps.max_nodes);
        # an explicit argument still wins (tests size it down)
        self.max_nodes = int(max_nodes if max_nodes is not None
                             else config.graphgps.max_nodes)
        self.device = resolve_device(device)
        self.gnn = EnhancedGraphGPS(device=self.device).eval()
        self.gt = CowLamenessGraphormer(device=self.device).eval()
        if params is None:
            gen = torch.Generator().manual_seed(0)
            params = {"gnn": seeded_state_dict(self.gnn, gen),
                      "gt": seeded_state_dict(self.gt, gen)}
        self.gnn.load_state_dict(params["gnn"])
        self.gt.load_state_dict(params["gt"])

    def _gnn_args(self, g):
        return on_device(gnn_inputs(g), self.device)

    def _gt_args(self, g):
        return on_device(gt_inputs(g), self.device)

    def _mc_generator(self, video_id: str) -> torch.Generator:
        # stable seed: builtin hash() is salted per process
        # (PYTHONHASHSEED), which would make the MC-dropout uncertainty
        # numbers differ across runs — result JSONs must be idempotent
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(zlib.crc32(video_id.encode()) % (2 ** 31))

    # ------------------------------------------------------------------
    def _cow_for(self, vid: str) -> Optional[str]:
        tr = _read_json(self.dirs.results_for("tracking")
                        / f"{vid}_tracking.json")
        for r in (tr or {}).get("reid_results", []):
            if r.get("cow_id"):
                return r["cow_id"]
        return None

    def collect_graph(self, target_video: str):
        """Per-cow graph when the target video maps to a cow (only that
        cow's videos, gnn:1442-1453), else the global graph of all known
        videos — the reference's exact fallback semantics."""
        video_ids: List[str] = []
        feats: List[np.ndarray] = []
        embs: List[np.ndarray] = []
        cow_ids: List[Optional[str]] = []
        timestamps: List[float] = []
        dino_dir = self.dirs.results_for("dinov3")
        candidates = sorted(f.stem.replace("_dinov3", "")
                            for f in dino_dir.glob("*_dinov3.json")) \
            if dino_dir.exists() else []
        if target_video not in candidates:
            candidates.append(target_video)
        target_cow = self._cow_for(target_video)
        if target_cow is not None:
            candidates = [v for v in candidates
                          if v == target_video or
                          self._cow_for(v) == target_cow]
        # the node cap must never evict the TARGET: with > max_nodes
        # known videos a lexicographically-early target would slice out
        # of its own graph and get no gnn/graph_transformer results
        others = [v for v in candidates if v != target_video]
        selected = others[-(self.max_nodes - 1):] + [target_video]
        dropped = len(others) - (len(selected) - 1)
        if dropped > 0:
            LOG.warning("graph.node_cap_truncated", video_id=target_video,
                        max_nodes=self.max_nodes,
                        candidates=len(others) + 1, dropped=dropped,
                        kept="newest by name order")
        for vid in selected:
            nf = node_features_for_video(self.dirs, vid)
            emb = embedding_for_video(self.dirs, vid)
            if nf is None or emb is None:
                continue
            video_ids.append(vid)
            feats.append(nf)
            embs.append(emb[:32])
            cow_ids.append(self._cow_for(vid))
            timestamps.append((dino_dir / f"{vid}_dinov3.json")
                              .stat().st_mtime)
        return video_ids, feats, embs, cow_ids, timestamps

    def build_graph(self, video_id: str):
        """The padded dense graph around ``video_id`` (host numpy), with its
        video ids and cow ids; None when the video has no node."""
        video_ids, feats, embs, cow_ids, ts = self.collect_graph(video_id)
        if video_id not in video_ids:
            return None
        g = gb.build_dense_graph(
            np.stack(feats), np.stack(embs), video_ids=video_ids,
            cow_ids=cow_ids, timestamps=ts,
            k=self.config.graphgps.k_nn, max_nodes=self.max_nodes)
        g["x"] = gb.standardize_features(g["x"], g["node_mask"])
        return g, video_ids, cow_ids

    @torch.no_grad()
    def process_video(self, video_id: str) -> Optional[Dict[str, Any]]:
        built = self.build_graph(video_id)
        if built is None:
            return None
        g, video_ids, cow_ids = built
        target_idx = video_ids.index(video_id)
        target_cow = cow_ids[target_idx]
        per_cow = target_cow is not None
        n_edges = int(g["edge_mask"].sum())

        # --- GraphGPS -----------------------------------------------------
        args = self._gnn_args(g)
        preds = self.gnn(*args, generator=self._mc_generator(video_id),
                         samples=MC_SAMPLES)["node_pred"].cpu().numpy()
        node_mean = preds.mean(axis=0)[:, 0]
        node_std = preds.std(axis=0, ddof=1)[:, 0]
        cow_score = float(self.gnn(*args)["graph_pred"][0, 0])
        node_score = float(node_mean[target_idx])
        neighbor_scores = [{"video_id": video_ids[src],
                            "score": float(node_mean[src])}
                           for src in range(len(video_ids))
                           if g["edge_mask"][src, target_idx]]
        gnn_result = schemas.gnn_result(
            video_id, target_cow, "EnhancedGraphGPS", node_score, cow_score,
            float(node_std[target_idx]),
            {"num_nodes": len(video_ids), "num_edges": n_edges,
             "k_neighbors": self.config.graphgps.k_nn,
             "has_edge_features": True,
             "has_temporal_edges": per_cow,
             "num_heads": 8, "hierarchical_pooling": True,
             "per_cow_graph": per_cow},
            neighbor_scores, video_ids)
        path = schemas.write_result(
            self.dirs.results_for("gnn") / f"{video_id}_gnn.json", gnn_result)
        if self.bus is not None:
            self.bus.publish_sync(self.config.subjects.pipeline_gnn, {
                "video_id": video_id, "pipeline": "gnn",
                "results_path": str(path),
                "severity_score": node_score})

        # --- Graphormer ---------------------------------------------------
        gt_args = self._gt_args(g)
        gt_preds = self.gt(*gt_args, generator=self._mc_generator(video_id),
                           samples=MC_SAMPLES)["graph_pred"].cpu().numpy()
        gt_graph_mean = float(gt_preds.mean())
        gt_graph_std = float(gt_preds.std(ddof=1))
        gt_det = self.gt(*gt_args)
        gt_node = float(gt_det["node_pred"][0, target_idx, 0])
        attn = gt_det["attention_weights"][0].cpu().numpy()   # (H, N, N)
        attn_to_target = attn[:, :, target_idx].mean(axis=0)
        order = np.argsort(attn_to_target)[::-1]
        top_attending = [
            {"video_id": video_ids[i], "attention": float(attn_to_target[i])}
            for i in order[:6] if i < len(video_ids) and i != target_idx][:5]
        gt_result = schemas.graph_transformer_result(
            video_id, target_cow, gt_node, gt_graph_mean, gt_graph_std,
            {"num_nodes": len(video_ids), "num_edges": n_edges,
             "num_layers": self.gt.num_layers, "num_heads": self.gt.heads,
             "hidden_dim": self.gt.hidden_dim,
             "has_temporal_edges": per_cow,
             "per_cow_graph": per_cow},
            {"top_attending_nodes": top_attending}, video_ids)
        path = schemas.write_result(
            self.dirs.results_for("graph_transformer")
            / f"{video_id}_graph_transformer.json", gt_result)
        if self.bus is not None:
            self.bus.publish_sync(
                self.config.subjects.pipeline_graph_transformer, {
                    "video_id": video_id, "pipeline": "graph_transformer",
                    "results_path": str(path),
                    "graph_prediction": gt_graph_mean})
        return {"gnn": gnn_result, "graph_transformer": gt_result}
