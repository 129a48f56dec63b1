"""In-process vector store with the Qdrant surface the reference uses
(port of ``lameness_tpu/io/vecstore.py``).

The reference keeps 768-d DINO embeddings in Qdrant collections
(``cow_embeddings`` keyed by video id, dinov3-pipeline/app/main.py:70-93,
228-243).  Both are cosine top-k over at most a few thousand points, so an
exact in-process store serves.  ``VectorStore`` is the JAX module's store
(create_collection / upsert / search / retrieve / set_payload / count /
export_collection, JSON persistence); its device top-k is one matvec and a
stable descending sort on the store's device.  ``make_store`` gives only
this local store: the Qdrant REST client is not ported yet.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device


@dataclass
class ScoredPoint:
    id: str
    score: float
    payload: Dict[str, Any]
    vector: Optional[List[float]] = None


@dataclass
class _Collection:
    dim: int
    distance: str = "cosine"
    ids: List[str] = field(default_factory=list)
    vectors: Optional[np.ndarray] = None          # (N, D) L2-normalized rows
    payloads: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def index_of(self, pid: str) -> int:
        try:
            return self.ids.index(pid)
        except ValueError:
            return -1


def _device_topk(vectors: np.ndarray, q: np.ndarray, k: int, device=None):
    """Matvec + top-k on ``device``, the rows padded to the next power of
    two (as the JAX package pads them to bound its retraces).  The top k of
    a stable descending sort: equal scores keep the lower index first, as
    ``lax.top_k`` does (``torch.topk`` promises no order)."""
    dev = resolve_device(device)
    n, d = vectors.shape
    n_pad = 1 << max(0, (n - 1)).bit_length()      # next power of two
    mat = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    mat[:n] = torch.from_numpy(np.ascontiguousarray(vectors, np.float32))
    valid = torch.arange(n_pad, device=dev) < n
    qv = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
    s = torch.where(valid, mat @ qv, torch.full((n_pad,), -float("inf"),
                                                device=dev))
    scores, idx = torch.sort(s, descending=True, stable=True)
    return scores[:k].cpu().numpy(), idx[:k].cpu().numpy()


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)


class VectorStore:
    """Exact cosine top-k store, JSON-persistent, thread-safe."""

    def __init__(self, persist_path: Optional[Path] = None, device=None):
        self._collections: Dict[str, _Collection] = {}
        # where ``search(use_device=True)`` runs: None is the current CUDA
        # device (resolved at the first such search)
        self.device = device
        self._lock = threading.Lock()
        self.persist_path = Path(persist_path) if persist_path else None
        if self.persist_path and self.persist_path.exists():
            self._load()

    # -- collection management ---------------------------------------------
    def create_collection(self, name: str, dim: int,
                          distance: str = "cosine") -> None:
        with self._lock:
            if name not in self._collections:
                self._collections[name] = _Collection(dim=dim, distance=distance)
        self._save()

    def has_collection(self, name: str) -> bool:
        return name in self._collections

    def collection_names(self) -> List[str]:
        return list(self._collections)

    def count(self, name: str) -> int:
        c = self._collections.get(name)
        return len(c.ids) if c else 0

    # -- points ------------------------------------------------------------
    def upsert(self, name: str, point_id: str, vector: Sequence[float],
               payload: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            c = self._collections.setdefault(
                name, _Collection(dim=len(vector)))
            v = _normalize(np.asarray(vector, np.float32))[None, :]
            idx = c.index_of(str(point_id))
            if idx >= 0:
                c.vectors[idx] = v[0]
            else:
                c.ids.append(str(point_id))
                c.vectors = v if c.vectors is None else np.vstack([c.vectors, v])
            if payload is not None:
                c.payloads[str(point_id)] = payload
            elif str(point_id) not in c.payloads:
                c.payloads[str(point_id)] = {}
        self._save()

    def retrieve(self, name: str, point_id: str,
                 with_vector: bool = True) -> Optional[ScoredPoint]:
        c = self._collections.get(name)
        if not c:
            return None
        idx = c.index_of(str(point_id))
        if idx < 0:
            return None
        return ScoredPoint(
            id=str(point_id), score=1.0,
            payload=c.payloads.get(str(point_id), {}),
            vector=c.vectors[idx].tolist() if with_vector else None)

    def set_payload(self, name: str, point_id: str,
                    payload: Dict[str, Any]) -> None:
        with self._lock:
            c = self._collections.get(name)
            if c and c.index_of(str(point_id)) >= 0:
                c.payloads[str(point_id)].update(payload)
        self._save()

    def export_collection(self, name: str, start: int = 0,
                          limit: Optional[int] = None
                          ) -> Optional[Dict[str, Any]]:
        """Points of a collection: {ids, vectors (N, D), payloads, total}.
        The bulk-read surface (Qdrant's scroll) used by the similarity
        map's PCA; ``start``/``limit`` page without copying the whole
        collection per page."""
        c = self._collections.get(name)
        if not c or c.vectors is None or len(c.ids) == 0:
            return None
        end = len(c.ids) if limit is None else min(start + limit,
                                                   len(c.ids))
        ids = list(c.ids[start:end])
        return {"ids": ids,
                "vectors": np.asarray(c.vectors[start:end],
                                      np.float32).copy(),
                "payloads": {i: c.payloads.get(i, {}) for i in ids},
                "total": len(c.ids)}

    def search(self, name: str, query: Sequence[float],
               top_k: int = 5, use_device: bool = False) -> List[ScoredPoint]:
        """Exact cosine top-k (scores in [-1, 1], descending).

        ``use_device=True`` runs the matvec + top-k on the store's device
        (the collection padded to the next power of two, as in the JAX
        package) — worthwhile once the collection is thousands of points.
        Ties there go to the lowest index, as ``lax.top_k``'s do.
        """
        c = self._collections.get(name)
        if not c or c.vectors is None or len(c.ids) == 0:
            return []
        k = min(top_k, len(c.ids))
        q = _normalize(np.asarray(query, np.float32))
        if use_device:
            scores_k, idx_k = _device_topk(c.vectors, q, k,
                                            self.device)
            return [ScoredPoint(id=c.ids[i], score=float(s),
                                payload=c.payloads.get(c.ids[i], {}))
                    for s, i in zip(scores_k, idx_k)]
        scores = c.vectors @ q
        order = np.argpartition(-scores, k - 1)[:k]
        order = order[np.argsort(-scores[order])]
        return [ScoredPoint(id=c.ids[i], score=float(scores[i]),
                            payload=c.payloads.get(c.ids[i], {}))
                for i in order]

    # -- persistence --------------------------------------------------------
    def _save(self) -> None:
        if not self.persist_path:
            return
        data = {}
        for name, c in self._collections.items():
            data[name] = {
                "dim": c.dim, "distance": c.distance, "ids": c.ids,
                "vectors": c.vectors.tolist() if c.vectors is not None else [],
                "payloads": c.payloads,
            }
        self.persist_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.persist_path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
        tmp.replace(self.persist_path)

    def _load(self) -> None:
        with open(self.persist_path) as f:
            data = json.load(f)
        for name, c in data.items():
            vecs = np.asarray(c["vectors"], np.float32) if c["vectors"] else None
            self._collections[name] = _Collection(
                dim=c["dim"], distance=c.get("distance", "cosine"),
                ids=list(c["ids"]), vectors=vecs,
                payloads={k: v for k, v in c["payloads"].items()})


def make_store(url: Optional[str] = None,
               persist_path: Optional[Path] = None, device=None):
    """The local store.  A vector server ``url`` raises: the port has no
    Qdrant REST client yet."""
    if url:
        raise NotImplementedError(
            f"make_store: no Qdrant client in lameness_tpu_torch yet (url "
            f"{url!r}); leave ReidConfig.vector_url unset for the local store")
    return VectorStore(persist_path=persist_path, device=device)
