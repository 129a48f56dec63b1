"""Dense graph construction for the relational lameness heads (port of
``lameness_tpu/graph/build.py``, copied line for line: numpy on the host).

kNN-5 cosine edges and per-cow temporal chains with the reference's 3-d
edge attributes ``[weight, is_knn, is_temporal]`` (gnn:195-213), the
Laplacian eigenvector and random-walk positional encodings (gnn:249-380)
by dense ``eigh``, and all-pairs shortest paths by min-plus iteration
(graph-transformer encodings.py:112-149).  The JAX runner computes these on
the host too, so the port's heads get inputs bit for bit the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def knn_edges_dense(embeddings: np.ndarray, mask: np.ndarray,
                    k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine kNN: directed edges i -> its top-k neighbours (gnn:55-100).

    Returns (edge_mask (N, N) bool [src, dst], weights (N, N) similarity).
    If fewer than k+1 valid nodes, k shrinks to n_valid-1 like the reference.
    """
    n = embeddings.shape[0]
    edge_mask = np.zeros((n, n), bool)
    weights = np.zeros((n, n), np.float32)
    valid_idx = np.where(mask)[0]
    nv = len(valid_idx)
    if nv < 2:
        return edge_mask, weights
    k_eff = min(k, nv - 1)
    e = embeddings[valid_idx]
    e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-8)
    sim = e @ e.T
    np.fill_diagonal(sim, -np.inf)
    for a in range(nv):
        top = np.argsort(sim[a])[-k_eff:]
        for b in top:
            if np.isfinite(sim[a, b]):
                i, j = valid_idx[a], valid_idx[b]
                edge_mask[i, j] = True
                weights[i, j] = sim[a, b]
    return edge_mask, weights


def temporal_edges_dense(cow_ids: List[Optional[str]],
                         timestamps: List[float],
                         mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bidirectional chains linking consecutive videos of each cow
    (gnn:102-147).  Returns (edge_mask (N, N), time_delta (N, N) seconds,
    signed src->dst)."""
    n = len(cow_ids)
    edge_mask = np.zeros((n, n), bool)
    deltas = np.zeros((n, n), np.float32)
    groups: Dict[str, List[int]] = {}
    for i, cid in enumerate(cow_ids):
        if cid is not None and mask[i]:
            groups.setdefault(cid, []).append(i)
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        order = sorted(idxs, key=lambda x: timestamps[x])
        for a, b in zip(order[:-1], order[1:]):
            dt = timestamps[b] - timestamps[a]
            edge_mask[a, b] = edge_mask[b, a] = True
            deltas[a, b] = dt
            deltas[b, a] = -dt
    return edge_mask, deltas


def build_dense_graph(node_features: np.ndarray, embeddings: np.ndarray,
                      video_ids: Optional[List[str]] = None,
                      cow_ids: Optional[List[Optional[str]]] = None,
                      timestamps: Optional[List[float]] = None,
                      k: int = 5, max_nodes: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """Full dense graph with the reference's 3-d edge attributes:
    attr[..., 0] = kNN similarity or tanh(|dt|/86400); attr[..., 1] = is_knn;
    attr[..., 2] = is_temporal (gnn:195-213).  kNN wins ties on overlap
    (temporal attrs only fill where no kNN edge exists), matching the
    reference's concatenated-edge ordering where both copies exist.
    Pads to `max_nodes` when given.
    """
    n = node_features.shape[0]
    pad_n = max_nodes if max_nodes is not None else n
    mask = np.zeros(pad_n, bool)
    mask[:n] = True
    feats = np.zeros((pad_n, node_features.shape[1]), np.float32)
    feats[:n] = node_features
    embs = np.zeros((pad_n, embeddings.shape[1]), np.float32)
    embs[:n] = embeddings

    knn_mask, knn_w = knn_edges_dense(embs, mask, k)
    if cow_ids is not None and timestamps is not None:
        cow_pad = list(cow_ids) + [None] * (pad_n - n)
        ts_pad = list(timestamps) + [0.0] * (pad_n - n)
        t_mask, t_dt = temporal_edges_dense(cow_pad, ts_pad, mask)
    else:
        t_mask = np.zeros((pad_n, pad_n), bool)
        t_dt = np.zeros((pad_n, pad_n), np.float32)

    edge_mask = knn_mask | t_mask
    attr = np.zeros((pad_n, pad_n, 3), np.float32)
    attr[..., 0] = np.where(knn_mask, knn_w,
                            np.tanh(np.abs(t_dt) / 86400.0) * t_mask)
    attr[..., 1] = knn_mask.astype(np.float32)
    attr[..., 2] = (t_mask & ~knn_mask).astype(np.float32)

    ts_arr = np.zeros(pad_n, np.float32)
    if timestamps is not None:
        ts_arr[:n] = np.asarray(timestamps, np.float32)

    return {
        "x": feats, "node_mask": mask, "edge_mask": edge_mask,
        "edge_attr": attr, "timestamps": ts_arr,
        "num_nodes": np.int32(n),
    }


# ---------------------------------------------------------------------------
# positional encodings (host numpy, reference numerics)
# ---------------------------------------------------------------------------
def _adj_with_self_loops(edge_mask: np.ndarray, node_mask: np.ndarray
                         ) -> np.ndarray:
    a = edge_mask.astype(np.float64).copy()
    n = len(node_mask)
    a[np.arange(n), np.arange(n)] = node_mask.astype(np.float64)
    a = a * node_mask[:, None] * node_mask[None, :]
    return a


def laplacian_pe(edge_mask: np.ndarray, node_mask: np.ndarray,
                 k: int = 8) -> np.ndarray:
    """k smallest non-trivial eigenvectors of the normalized Laplacian with
    self-loops (gnn:249-303), zero-padded; invalid nodes get zeros."""
    n_pad = len(node_mask)
    valid = np.where(node_mask)[0]
    nv = len(valid)
    out = np.zeros((n_pad, k), np.float32)
    if nv < 2:
        return out
    a = _adj_with_self_loops(edge_mask, node_mask)[np.ix_(valid, valid)]
    deg = a.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    lap = np.eye(nv) - (dinv[:, None] * a * dinv[None, :])
    w, v = np.linalg.eigh((lap + lap.T) / 2)
    pe = v[:, 1:k + 1]
    out[valid, :pe.shape[1]] = pe.astype(np.float32)
    return out


def random_walk_pe(edge_mask: np.ndarray, node_mask: np.ndarray,
                   walk_length: int = 16) -> np.ndarray:
    """Self-return probabilities diag(P^k), k = 1..walk_length (gnn:333-376)."""
    n_pad = len(node_mask)
    valid = np.where(node_mask)[0]
    nv = len(valid)
    out = np.zeros((n_pad, walk_length), np.float32)
    if nv == 0:
        return out
    a = _adj_with_self_loops(edge_mask, node_mask)[np.ix_(valid, valid)]
    deg = a.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / deg, 0.0)
    p = dinv[:, None] * a
    pk = p.copy()
    for step in range(walk_length):
        out[valid, step] = np.diag(pk).astype(np.float32)
        pk = pk @ p
    return out


def shortest_path_dense(edge_mask: np.ndarray, node_mask: np.ndarray,
                        max_spd: int = 10) -> np.ndarray:
    """All-pairs shortest paths by min-plus iteration (replaces NetworkX BFS,
    encodings.py:112-149).  Undirected; unreachable/invalid -> max_spd + 1;
    distances clipped at max_spd; self-distance 0.
    """
    n = len(node_mask)
    big = max_spd + 1
    sym = (edge_mask | edge_mask.T) & node_mask[:, None] & node_mask[None, :]
    d = np.where(sym, 1, n + big).astype(np.int64)
    np.fill_diagonal(d, 0)
    # repeated squaring of the min-plus product: ceil(log2) rounds
    hops = 1
    while hops < max_spd:
        d = np.minimum(d, (d[:, :, None] + d[None, :, :]).min(axis=1))
        hops *= 2
    d = np.minimum(d, big)
    d[~node_mask, :] = big
    d[:, ~node_mask] = big
    np.fill_diagonal(d, np.where(node_mask, 0, big))
    return d


def degrees(edge_mask: np.ndarray, node_mask: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(in_degree, out_degree) over directed dense edges."""
    em = edge_mask & node_mask[:, None] & node_mask[None, :]
    return em.sum(axis=0).astype(np.int64), em.sum(axis=1).astype(np.int64)


def standardize_features(x: np.ndarray, node_mask: np.ndarray) -> np.ndarray:
    """Z-score node features over the valid nodes (padded rows stay zero).

    The 50-d node vector mixes raw pixel areas (~1e4) with probabilities
    (~1e-1); without standardisation the large-scale features drown the
    informative ones for both training and attention.  Must be applied
    identically at train and inference time.
    """
    x = np.asarray(x, np.float32).copy()
    valid = x[node_mask]
    if len(valid) == 0:
        return x
    mu = valid.mean(axis=0)
    sd = valid.std(axis=0)
    sd = np.where(sd < 1e-6, 1.0, sd)
    x[node_mask] = (valid - mu) / sd
    return x
