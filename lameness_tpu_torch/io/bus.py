"""In-process message bus (port of ``lameness_tpu/io/bus.py``).

The reference's services talk over NATS core pub/sub with JSON payloads,
at-most-once, each callback's exceptions swallowed.  ``MessageBus`` keeps
that contract in one process: the same subject names, JSON round-tripped
dict payloads, per-message exception isolation, fire-and-forget publish,
and a JSON-lines journal.  ``NatsBridge`` joins it to a NATS server over
the wire protocol of ``io/nats_wire.py`` (the broker of the ``nats-server``
subcommand, the JAX package's, or a stock Go one).
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Awaitable, Callable, Dict, List, Optional

Handler = Callable[[Dict[str, Any]], Any]


class MessageBus:
    """Synchronous-dispatch in-process pub/sub with NATS-compatible surface.

    Handlers may be plain callables or coroutines; coroutines run on a
    dedicated event loop thread.  ``publish`` never raises on handler
    failure (matching nats_client.py:61-67's swallow-all semantics) but
    failures are recorded in ``self.errors`` so tests can assert on them.
    """

    def __init__(self, journal_path: Optional[Path] = None,
                 async_dispatch: bool = False, workers: int = 4):
        self._subs: Dict[str, List[Handler]] = defaultdict(list)
        self._lock = threading.Lock()
        self.journal_path = journal_path
        self.errors: List[Dict[str, Any]] = []
        self.history: List[Dict[str, Any]] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.connected = False
        # async dispatch: publishes enqueue; a worker pool drains them off
        # the publisher's thread (the NATS deployment's concurrency model —
        # each reference service consumes its subjects independently).
        self.async_dispatch = async_dispatch
        self._queue: Optional["queue.Queue"] = None
        self._workers: List[threading.Thread] = []
        self._inflight = 0
        self._idle = threading.Condition()
        if async_dispatch:
            import queue as _queue
            self._queue = _queue.Queue()
            for i in range(max(1, workers)):
                t = threading.Thread(target=self._worker, daemon=True,
                                     name=f"bus-worker-{i}")
                t.start()
                self._workers.append(t)

    # -- NATS-compatible surface -------------------------------------------
    async def connect(self) -> None:
        self.connected = True

    async def close(self) -> None:
        self.connected = False

    async def subscribe(self, subject: str, handler: Handler) -> None:
        self.subscribe_sync(subject, handler)

    async def publish(self, subject: str, payload: Dict[str, Any]) -> None:
        decoded = self._record(subject, payload)
        with self._lock:
            handlers = list(self._subs.get(subject, ()))
        for h in handlers:
            try:
                result = h(decoded)
                if asyncio.iscoroutine(result):
                    await result
            except Exception as e:
                self.errors.append({"subject": subject, "error": repr(e)})

    # -- synchronous API ----------------------------------------------------
    def subscribe_sync(self, subject: str, handler: Handler) -> None:
        with self._lock:
            self._subs[subject].append(handler)

    def _record(self, subject: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        # Force JSON round-trippability at the boundary, like the wire would.
        encoded = json.dumps(payload)
        record = {"subject": subject, "ts": time.time(), "payload": payload}
        self.history.append(record)
        if self.journal_path is not None:
            self.journal_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.journal_path, "a") as f:
                f.write(encoded and json.dumps(
                    {"subject": subject, "ts": record["ts"],
                     "payload": payload}) + "\n")
        return json.loads(encoded)

    def publish_sync(self, subject: str, payload: Dict[str, Any]) -> None:
        decoded = self._record(subject, payload)
        with self._lock:
            handlers = list(self._subs.get(subject, ()))
        if self.async_dispatch and self._queue is not None:
            with self._idle:
                self._inflight += 1
            self._queue.put((subject, decoded, handlers))
            return
        self._dispatch(subject, decoded, handlers)

    def _dispatch(self, subject, decoded, handlers) -> None:
        for h in handlers:
            try:
                result = h(decoded)
                if asyncio.iscoroutine(result):
                    self._run_coro(result)
            except Exception as e:  # at-most-once, swallow like the reference
                self.errors.append({"subject": subject, "error": repr(e)})

    # -- async worker pool ----------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            subject, decoded, handlers = item
            try:
                self._dispatch(subject, decoded, handlers)
            finally:
                with self._idle:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

    def flush(self, timeout_s: float = 60.0) -> bool:
        """Block until every enqueued message (and any it triggered) has
        been handled.  No-op in synchronous mode."""
        if not self.async_dispatch:
            return True
        deadline = time.time() + timeout_s
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._idle.wait(min(remaining, 0.5))
        return True

    def shutdown(self) -> None:
        """Stop the worker pool (pending messages are drained first)."""
        if self._queue is not None:
            self.flush()
            for _ in self._workers:
                self._queue.put(None)
            for t in self._workers:
                t.join(timeout=5)
            self._workers = []

    def _run_coro(self, coro: Awaitable) -> None:
        if self._loop is None or self._loop.is_closed():
            self._loop = asyncio.new_event_loop()
        self._loop.run_until_complete(coro)

    # -- introspection ------------------------------------------------------
    def messages_on(self, subject: str) -> List[Dict[str, Any]]:
        return [m["payload"] for m in self.history if m["subject"] == subject]

    def subjects_seen(self) -> List[str]:
        seen: List[str] = []
        for m in self.history:
            if m["subject"] not in seen:
                seen.append(m["subject"])
        return seen


class NatsBridge:
    """Bidirectional bridge between the in-process bus and a real NATS
    server over the wire protocol (first-party client, ``io/nats_wire.py``
    — no nats-py needed; also speaks to a stock Go nats-server).

    Outbound: every local publish on a bridged subject is mirrored to the
    socket.  Inbound: MSGs from the socket re-enter the local bus tagged
    ``_via_nats`` so they are not mirrored back out.  The connection uses
    CONNECT ``echo: false`` so the bridge never hears its own publishes —
    a mesh of bridged processes therefore delivers each message
    at-most-once per process, like the reference deployment.
    """

    def __init__(self, bus: MessageBus, url: str = "nats://127.0.0.1:4222",
                 subjects: Optional[List[str]] = None):
        self.bus = bus
        self.url = url
        self.subjects = subjects
        self._nc = None

    def start(self) -> bool:
        """Connect and wire both directions; False if unreachable."""
        from .nats_wire import NatsClient
        try:
            self._nc = NatsClient(self.url, name="lameness-bridge",
                                  echo=False).connect()
        except (OSError, ConnectionError):
            self._nc = None
            return False

        subjects = self.subjects or list(self.bus._subs)

        def _outbound(subject: str):
            def h(payload: Dict[str, Any]):
                if self._nc is not None and self._nc.is_connected \
                        and not payload.get("_via_nats"):
                    self._nc.publish(subject, payload)
            return h

        def _inbound(subject: str):
            def cb(payload: Dict[str, Any]):
                if not payload.get("_via_nats"):
                    payload = dict(payload)
                    payload["_via_nats"] = True
                    self.bus.publish_sync(subject, payload)
            return cb

        for subject in subjects:
            self.bus.subscribe_sync(subject, _outbound(subject))
            self._nc.subscribe(subject, _inbound(subject))
        return True

    def flush(self, timeout_s: float = 5.0) -> bool:
        return self._nc.flush(timeout_s) if self._nc else False

    def stop(self) -> None:
        if self._nc is not None:
            self._nc.close()
            self._nc = None
