"""Qdrant-REST-compatible vector server + client (port of
``lameness_tpu/io/qdrant_wire.py``, the same routes and bodies).

The reference talks to a real Qdrant server for the two embedding
collections (``dinov3-pipeline/app/main.py:70-93`` creates/upserts
``cow_embeddings``; ``tracking-service/app/reid/matcher.py:51,80-102``
searches ``cow_identities``).  Like ``io/nats_wire.py`` for the bus, this
module implements the wire contract itself:

* ``QdrantRestServer`` (the ``qdrant-server`` subcommand) -- the REST
  endpoint subset the system needs (collections list/create/info, points
  upsert/retrieve/search/scroll/payload), each response in Qdrant's
  ``{"result": ..., "status": "ok", "time": ...}`` envelope, over the
  port's ``serve/http.py``.  It is backed by the port's exact-cosine
  ``VectorStore`` and searches on the store's device: a server whose store
  is on the card runs each search's matvec and top-k there.
* ``QdrantRestStore`` -- a client for that protocol exposing the SAME
  method surface as ``VectorStore`` (create_collection / upsert /
  search / retrieve / set_payload / count / has_collection /
  collection_names / export_collection), so ``make_store(url=...)``
  returns a drop-in: the driver's Re-ID and embedding flows run unchanged
  against a server socket.

Route shapes follow the Qdrant REST API v1 (PUT /collections/{name},
PUT /collections/{name}/points, POST /collections/{name}/points/search,
POST /collections/{name}/points (retrieve by ids), POST
/collections/{name}/points/payload).
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from ..serve.http import AdminHTTPServer, HTTPError, Router, TokenCodec
from .vecstore import ScoredPoint, VectorStore


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class QdrantRestServer:
    """Serve a ``VectorStore`` over the Qdrant REST wire protocol.  Its
    searches run on the store's device (without ``store``, a store on the
    card)."""

    def __init__(self, store: Optional[VectorStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store or VectorStore()
        router = Router()
        store_ref = self.store

        def ok(result: Any) -> Dict[str, Any]:
            return {"result": result, "status": "ok", "time": 0.0}

        def get_collection(name: str):
            if not store_ref.has_collection(name):
                raise HTTPError(404, f"Collection `{name}` doesn't exist!")

        @router.get("/collections")
        def collections(req):
            return ok({"collections": [
                {"name": n} for n in store_ref.collection_names()]})

        @router.put("/collections/{name}")
        def create_collection(req):
            cfg = ((req.body or {}).get("vectors") or {})
            store_ref.create_collection(
                req.params["name"], int(cfg.get("size", 768)),
                distance=str(cfg.get("distance", "Cosine")).lower())
            return ok(True)

        @router.get("/collections/{name}")
        def collection_info(req):
            name = req.params["name"]
            get_collection(name)
            return ok({"status": "green",
                       "points_count": store_ref.count(name)})

        @router.put("/collections/{name}/points")
        def upsert_points(req):
            name = req.params["name"]
            pts = (req.body or {}).get("points") or []
            for p in pts:
                store_ref.upsert(name, str(p["id"]), p["vector"],
                                 payload=p.get("payload"))
            return ok({"operation_id": 0, "status": "completed"})

        @router.post("/collections/{name}/points")
        def retrieve_points(req):
            name = req.params["name"]
            get_collection(name)
            body = req.body or {}
            with_vector = bool(body.get("with_vector", True))
            out = []
            for pid in body.get("ids") or []:
                p = store_ref.retrieve(name, str(pid),
                                       with_vector=with_vector)
                if p is not None:
                    out.append({"id": p.id, "payload": p.payload,
                                "vector": p.vector})
            return ok(out)

        @router.post("/collections/{name}/points/search")
        def search_points(req):
            name = req.params["name"]
            get_collection(name)
            body = req.body or {}
            hits = store_ref.search(name, body.get("vector") or [],
                                    top_k=int(body.get("limit", 5)),
                                    use_device=True)
            return ok([{"id": h.id, "score": h.score,
                        "payload": h.payload
                        if body.get("with_payload", True) else None}
                       for h in hits])

        @router.post("/collections/{name}/points/scroll")
        def scroll_points(req):
            """Qdrant scroll: page through all points (with vectors).
            Offsets are the integer cursors this server itself returns
            (Qdrant permits numeric offsets), so each page copies only
            its own slice."""
            name = req.params["name"]
            get_collection(name)
            body = req.body or {}
            limit = int(body.get("limit", 256))
            offset = body.get("offset")
            start = offset if isinstance(offset, int) and offset >= 0 else 0
            page = store_ref.export_collection(name, start=start,
                                               limit=limit)
            if page is None:
                return ok({"points": [], "next_page_offset": None})
            with_vec = body.get("with_vector", True)
            pts = [{"id": pid,
                    "payload": page["payloads"].get(pid, {}),
                    "vector": page["vectors"][i].tolist()
                    if with_vec else None}
                   for i, pid in enumerate(page["ids"])]
            nxt = start + limit if start + limit < page["total"] else None
            return ok({"points": pts, "next_page_offset": nxt})

        @router.post("/collections/{name}/points/payload")
        def set_payload(req):
            name = req.params["name"]
            get_collection(name)
            body = req.body or {}
            for pid in body.get("points") or []:
                store_ref.set_payload(name, str(pid),
                                      body.get("payload") or {})
            return ok({"operation_id": 0, "status": "completed"})

        self._server = AdminHTTPServer(router, TokenCodec(),
                                       host=host, port=port)

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self) -> None:
        self._server.stop()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class QdrantRestStore:
    """VectorStore-surface client over the Qdrant REST protocol."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                resp = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return resp.get("result")

    # -- VectorStore surface -------------------------------------------------
    def create_collection(self, name: str, dim: int,
                          distance: str = "cosine") -> None:
        self._call("PUT", f"/collections/{name}",
                   {"vectors": {"size": dim, "distance": distance}})

    def has_collection(self, name: str) -> bool:
        return self._call("GET", f"/collections/{name}") is not None

    def collection_names(self) -> List[str]:
        res = self._call("GET", "/collections") or {}
        return [c["name"] for c in res.get("collections", [])]

    def count(self, name: str) -> int:
        res = self._call("GET", f"/collections/{name}")
        return int(res["points_count"]) if res else 0

    def upsert(self, name: str, point_id: str, vector: Sequence[float],
               payload: Optional[Dict[str, Any]] = None) -> None:
        pt: Dict[str, Any] = {"id": str(point_id),
                              "vector": [float(v) for v in vector]}
        if payload is not None:
            pt["payload"] = payload
        self._call("PUT", f"/collections/{name}/points", {"points": [pt]})

    def retrieve(self, name: str, point_id: str,
                 with_vector: bool = True) -> Optional[ScoredPoint]:
        res = self._call("POST", f"/collections/{name}/points",
                         {"ids": [str(point_id)],
                          "with_vector": with_vector})
        if not res:
            return None
        p = res[0]
        return ScoredPoint(id=str(p["id"]), score=1.0,
                           payload=p.get("payload") or {},
                           vector=p.get("vector"))

    def set_payload(self, name: str, point_id: str,
                    payload: Dict[str, Any]) -> None:
        self._call("POST", f"/collections/{name}/points/payload",
                   {"points": [str(point_id)], "payload": payload})

    def search(self, name: str, query: Sequence[float], top_k: int = 5,
               use_device: bool = False) -> List[ScoredPoint]:
        res = self._call("POST", f"/collections/{name}/points/search",
                         {"vector": [float(v) for v in query],
                          "limit": top_k, "with_payload": True}) or []
        return [ScoredPoint(id=str(h["id"]), score=float(h["score"]),
                            payload=h.get("payload") or {}) for h in res]

    def export_collection(self, name: str, start: int = 0,
                          limit: Optional[int] = None):
        """Bulk read via Qdrant scroll pages -> {ids, vectors, payloads,
        total} (same surface as VectorStore.export_collection).

        Server-side paging: the scroll starts at ``offset=start`` (this
        server hands out integer cursors) and stops once ``limit`` points
        are in hand, so a paged caller transfers only its own slice —
        ``total`` comes from the collection metadata, not a full scan.
        """
        import numpy as np
        total = self.count(name)
        if not self.has_collection(name):
            return None
        want = (total - start) if limit is None else limit
        ids, vecs, payloads = [], [], {}
        offset: Optional[int] = start
        while want > 0 and offset is not None:
            res = self._call("POST", f"/collections/{name}/points/scroll",
                             {"limit": min(256, want), "offset": offset,
                              "with_vector": True})
            if res is None:
                return None
            pts = res.get("points", [])
            if not pts:
                break
            for p in pts:
                ids.append(str(p["id"]))
                vecs.append(p.get("vector") or [])
                payloads[str(p["id"])] = p.get("payload") or {}
            want -= len(pts)
            offset = res.get("next_page_offset")
        if not ids:
            return None
        return {"ids": ids,
                "vectors": np.asarray(vecs, np.float32),
                "payloads": payloads,
                "total": total}

    def ping(self) -> bool:
        """True only for a server that actually speaks the Qdrant
        protocol — a generic HTTP service answering 404s must NOT pass
        (make_store would then silently no-op every upsert)."""
        try:
            res = self._call("GET", "/collections")
            return isinstance(res, dict) and "collections" in res
        except Exception:
            return False
