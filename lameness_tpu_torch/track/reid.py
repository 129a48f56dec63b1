"""Cow Re-Identification over the vector store (port of
``lameness_tpu/track/reid.py``, copied line for line over the port's
``io/vecstore.py``).

Cosine match against per-cow prototype embeddings with thresholds
0.85/0.75/0.65 (high/medium/low confidence), momentum-0.9 prototype updates
on a match (matcher.py:257-301), auto-created ``COW-%04d`` ids
(matcher.py:225) and Qdrant-schema payloads.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.vecstore import VectorStore

COLLECTION_NAME = "cow_identities"
SIM_HIGH = 0.85
SIM_MEDIUM = 0.75
SIM_LOW = 0.65


@dataclass
class ReIDMatch:
    identity_id: str
    cow_id: str
    similarity: float
    confidence: str
    is_new_identity: bool


class CowReIDMatcher:
    def __init__(self, store: VectorStore, embedding_dim: int = 768,
                 auto_create_identities: bool = True,
                 embedding_momentum: float = 0.9):
        self.store = store
        self.embedding_dim = embedding_dim
        self.auto_create = auto_create_identities
        self.momentum = embedding_momentum
        store.create_collection(COLLECTION_NAME, embedding_dim)
        self.identity_counter = store.count(COLLECTION_NAME)

    def _confidence_label(self, sim: float) -> str:
        if sim >= SIM_HIGH:
            return "high"
        if sim >= SIM_MEDIUM:
            return "medium"
        if sim >= SIM_LOW:
            return "low"
        return "none"

    def match_embedding(self, embedding: np.ndarray, top_k: int = 5
                        ) -> Tuple[Optional[ReIDMatch], List[ReIDMatch]]:
        hits = self.store.search(COLLECTION_NAME, embedding, top_k=top_k)
        candidates = [
            ReIDMatch(identity_id=h.payload.get("identity_id", h.id),
                      cow_id=h.payload.get("cow_id", "UNKNOWN"),
                      similarity=h.score,
                      confidence=self._confidence_label(h.score),
                      is_new_identity=False)
            for h in hits]
        best = candidates[0] if candidates and candidates[0].similarity >= SIM_LOW \
            else None
        return best, candidates

    def match_or_create(self, embedding: np.ndarray, video_id: str,
                        track_id: int,
                        metadata: Optional[Dict] = None) -> ReIDMatch:
        best, candidates = self.match_embedding(embedding)
        if best is not None and best.similarity >= SIM_MEDIUM:
            self._update_identity_embedding(best.identity_id, embedding)
            return best
        if self.auto_create:
            identity_id, cow_id = self.create_identity(
                embedding,
                metadata={"first_video": video_id, "first_track": track_id,
                          **(metadata or {})})
            return ReIDMatch(identity_id=identity_id, cow_id=cow_id,
                             similarity=1.0, confidence="high",
                             is_new_identity=True)
        return ReIDMatch(identity_id=str(uuid.uuid4()), cow_id="UNKNOWN",
                         similarity=candidates[0].similarity if candidates else 0.0,
                         confidence="low", is_new_identity=True)

    def create_identity(self, embedding: np.ndarray,
                        tag_number: Optional[str] = None,
                        metadata: Optional[Dict] = None) -> Tuple[str, str]:
        self.identity_counter += 1
        identity_id = str(uuid.uuid4())
        cow_id = f"COW-{self.identity_counter:04d}"
        vec = np.asarray(embedding, float)
        vec = vec / (np.linalg.norm(vec) + 1e-8)
        self.store.upsert(COLLECTION_NAME, identity_id, vec, payload={
            "identity_id": identity_id, "cow_id": cow_id,
            "tag_number": tag_number, "total_sightings": 1,
            **(metadata or {})})
        return identity_id, cow_id

    def _update_identity_embedding(self, identity_id: str,
                                   new_embedding: np.ndarray) -> None:
        point = self.store.retrieve(COLLECTION_NAME, identity_id)
        if point is None or point.vector is None:
            return
        old = np.asarray(point.vector, float)
        new = np.asarray(new_embedding, float)
        new = new / (np.linalg.norm(new) + 1e-8)
        merged = self.momentum * old + (1 - self.momentum) * new
        merged = merged / (np.linalg.norm(merged) + 1e-8)
        payload = dict(point.payload)
        payload["total_sightings"] = payload.get("total_sightings", 0) + 1
        self.store.upsert(COLLECTION_NAME, identity_id, merged, payload=payload)
