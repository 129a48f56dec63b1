"""NATS core wire protocol: a broker and a client, pure stdlib (port of
``lameness_tpu/io/nats_wire.py``, copied byte for byte on the wire).

The reference's services communicate exclusively over NATS core pub/sub
(``shared/utils/nats_client.py:13-76``, server ``nats://nats:4222`` from
``docker-compose.yml``).  This module implements the text protocol
(https://docs.nats.io/reference/reference-protocols/nats-protocol) --
INFO / CONNECT / PING / PONG / SUB / UNSUB / PUB / MSG / +OK / -ERR --
so the port can:

- run a broker (``NatsServer``, the ``nats-server`` subcommand) for the
  compose topology where the Go nats-server binary isn't available, and
- speak to ANY NATS server (this one, the JAX package's, or a stock Go
  one) via ``NatsClient`` without the nats-py dependency.

Subject semantics match NATS core: '.'-separated tokens, '*' matches one
token, '>' matches the rest.  Delivery is at-most-once fan-out, like the
reference deployment.  Nothing here touches the card.
"""
from __future__ import annotations

import json
import socket
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

_CRLF = b"\r\n"


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS wildcard matching: '*' = one token, '>' = one-or-more tail."""
    pt = pattern.split(".")
    st = subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return len(st) >= i + 1
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------
class _ClientConn:
    def __init__(self, sock: socket.socket, addr, server: "NatsServer"):
        self.sock = sock
        self.addr = addr
        self.server = server
        self.subs: Dict[str, str] = {}          # sid -> subject pattern
        self.lock = threading.Lock()
        self.alive = True
        self.echo = True                        # CONNECT {"echo": false}

    def send(self, data: bytes) -> None:
        try:
            with self.lock:
                self.sock.sendall(data)
        except OSError:
            self.alive = False


class NatsServer:
    """Minimal NATS core broker: enough for the reference's 25-subject
    pub/sub contract (no JetStream, no auth, no queue groups)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 verbose_default: bool = False):
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._clients: List[_ClientConn] = []
        self._lock = threading.Lock()
        self._stopping = False
        self.messages_routed = 0
        self.verbose_default = verbose_default

    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="nats-accept").start()
        return self.port

    def stop(self) -> None:
        self._stopping = True
        try:
            if self._sock:
                self._sock.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.sock.close()
                except OSError:
                    pass
            self._clients.clear()

    # -- internals ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            conn = _ClientConn(sock, addr, self)
            with self._lock:
                self._clients.append(conn)
            threading.Thread(target=self._serve_client, args=(conn,),
                             daemon=True, name=f"nats-{addr[1]}").start()

    def _info(self) -> bytes:
        info = {"server_id": "lameness-nats", "version": "0.1.0",
                "proto": 1, "host": self.host, "port": self.port,
                "max_payload": 8 * 1024 * 1024, "headers": False}
        return b"INFO " + json.dumps(info).encode() + _CRLF

    def _serve_client(self, conn: _ClientConn) -> None:
        conn.send(self._info())
        verbose = self.verbose_default
        buf = b""
        sock = conn.sock
        try:
            while not self._stopping and conn.alive:
                # read one protocol line
                while _CRLF not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(_CRLF, 1)
                op, _, rest = line.partition(b" ")
                op = op.upper()
                if op == b"CONNECT":
                    try:
                        opts = json.loads(rest or b"{}")
                        verbose = bool(opts.get("verbose", False))
                        conn.echo = bool(opts.get("echo", True))
                    except ValueError:
                        verbose = False
                    if verbose:
                        conn.send(b"+OK" + _CRLF)
                elif op == b"PING":
                    conn.send(b"PONG" + _CRLF)
                elif op == b"PONG":
                    pass
                elif op == b"SUB":
                    parts = rest.decode().split()
                    if len(parts) >= 2:          # subject [queue] sid
                        subject, sid = parts[0], parts[-1]
                        conn.subs[sid] = subject
                        if verbose:
                            conn.send(b"+OK" + _CRLF)
                elif op == b"UNSUB":
                    parts = rest.decode().split()
                    if parts:
                        conn.subs.pop(parts[0], None)
                        if verbose:
                            conn.send(b"+OK" + _CRLF)
                elif op == b"PUB":
                    # PUB <subject> [reply-to] <#bytes>\r\n<payload>\r\n
                    parts = rest.decode().split()
                    if len(parts) < 2:
                        conn.send(b"-ERR 'Unknown Protocol Operation'" + _CRLF)
                        continue
                    subject = parts[0]
                    reply = parts[1] if len(parts) == 3 else ""
                    nbytes = int(parts[-1])
                    while len(buf) < nbytes + 2:
                        chunk = sock.recv(65536)
                        if not chunk:
                            return
                        buf += chunk
                    payload, buf = buf[:nbytes], buf[nbytes + 2:]
                    if verbose:            # ack before fan-out so a client
                        conn.send(b"+OK" + _CRLF)  # sees +OK then its MSG
                    self._route(subject, reply, payload, src=conn)
                else:
                    conn.send(b"-ERR 'Unknown Protocol Operation'" + _CRLF)
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                if conn in self._clients:
                    self._clients.remove(conn)
            try:
                sock.close()
            except OSError:
                pass

    def _route(self, subject: str, reply: str, payload: bytes,
               src: Optional[_ClientConn] = None) -> None:
        self.messages_routed += 1
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            if c is src and not c.echo:
                continue
            for sid, pattern in list(c.subs.items()):
                if subject_matches(pattern, subject):
                    head = f"MSG {subject} {sid}" + \
                        (f" {reply}" if reply else "") + f" {len(payload)}"
                    c.send(head.encode() + _CRLF + payload + _CRLF)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class NatsClient:
    """Blocking-socket NATS core client with a background reader thread.

    Mirrors the reference NATSClient's surface (nats_client.py:13-76):
    ``connect() / publish(subject, dict) / subscribe(subject, cb) /
    close()`` — JSON payloads, fire-and-forget, per-callback exception
    isolation.
    """

    def __init__(self, url: str = "nats://127.0.0.1:4222",
                 name: str = "lameness-tpu", echo: bool = True):
        self.echo = echo
        rest = url.split("://", 1)[-1]
        if "@" in rest:                          # strip user:pass@
            rest = rest.split("@", 1)[1]
        host, _, port = rest.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 4222)
        self.name = name
        self._sock: Optional[socket.socket] = None
        self._subs: Dict[str, Tuple[str, Callable]] = {}   # sid -> (subj, cb)
        self._wlock = threading.Lock()
        self._connected = threading.Event()
        self.server_info: Dict[str, Any] = {}
        self.errors: List[str] = []
        self._pong_waiters: List[threading.Event] = []
        self._pong_lock = threading.Lock()
        self._buf = b""

    # -- lifecycle -------------------------------------------------------------
    def connect(self, timeout_s: float = 5.0) -> "NatsClient":
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=timeout_s)
        # keep the timeout through the INFO/CONNECT/PONG handshake: a
        # non-NATS listener (wrong port) would otherwise hang recv()
        # forever instead of failing fast
        self._buf = b""
        try:
            line = self._read_line()
            if not line.startswith(b"INFO "):
                raise ConnectionError(f"unexpected greeting: {line[:40]!r}")
            self.server_info = json.loads(line[5:])
            opts = {"verbose": False, "pedantic": False, "name": self.name,
                    "lang": "python", "version": "0.1.0", "protocol": 1,
                    "echo": self.echo}
            self._send(b"CONNECT " + json.dumps(opts).encode() + _CRLF +
                       b"PING" + _CRLF)
            pong = self._read_line()
            if pong.strip().upper() != b"PONG":
                raise ConnectionError(f"no PONG after CONNECT: {pong[:40]!r}")
        except (socket.timeout, TimeoutError) as e:
            self._sock.close()
            raise ConnectionError(
                f"NATS handshake timed out after {timeout_s}s "
                f"(is {self.host}:{self.port} really a NATS server?)") from e
        self._sock.settimeout(None)          # blocking mode for the reader
        self._connected.set()
        threading.Thread(target=self._reader, daemon=True,
                         name=f"nats-reader-{self.port}").start()
        return self

    def close(self) -> None:
        self._connected.clear()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    @property
    def is_connected(self) -> bool:
        return self._connected.is_set()

    # -- pub/sub ----------------------------------------------------------------
    def publish(self, subject: str, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload).encode()
        self._send(f"PUB {subject} {len(data)}".encode() + _CRLF +
                   data + _CRLF)

    def publish_raw(self, subject: str, data: bytes) -> None:
        self._send(f"PUB {subject} {len(data)}".encode() + _CRLF +
                   data + _CRLF)

    def subscribe(self, subject: str,
                  callback: Callable[[Dict[str, Any]], Any]) -> str:
        sid = uuid.uuid4().hex[:8]
        self._subs[sid] = (subject, callback)
        self._send(f"SUB {subject} {sid}".encode() + _CRLF)
        return sid

    def unsubscribe(self, sid: str) -> None:
        self._subs.pop(sid, None)
        self._send(f"UNSUB {sid}".encode() + _CRLF)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Round-trip PING/PONG: when it returns, every prior publish has
        been processed by the server.

        PING/PONG pair FIFO (one PONG releases exactly the oldest waiter),
        so concurrent flush() calls each wait for their OWN round trip —
        a later flush cannot ride an earlier flush's PONG.
        """
        ev = threading.Event()
        with self._pong_lock:
            self._pong_waiters.append(ev)
        self._send(b"PING" + _CRLF)
        return ev.wait(timeout_s)

    # -- internals ----------------------------------------------------------------
    def _send(self, data: bytes) -> None:
        if self._sock is None:
            raise ConnectionError("not connected")
        with self._wlock:
            self._sock.sendall(data)

    def _read_line(self) -> bytes:
        while _CRLF not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self._buf += chunk
        line, self._buf = self._buf.split(_CRLF, 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _reader(self) -> None:
        try:
            while self._connected.is_set():
                line = self._read_line()
                if not line:
                    continue
                op, _, rest = line.partition(b" ")
                op = op.upper()
                if op == b"MSG":
                    parts = rest.decode().split()
                    # <subject> <sid> [reply-to] <#bytes>
                    subject, sid = parts[0], parts[1]
                    nbytes = int(parts[-1])
                    payload = self._read_exact(nbytes + 2)[:-2]
                    entry = self._subs.get(sid)
                    if entry is not None:
                        try:
                            data = json.loads(payload)
                        except ValueError:
                            data = {"_raw": payload.decode("utf-8", "replace")}
                        try:
                            entry[1](data)
                        except Exception as e:   # swallow-all, like reference
                            self.errors.append(repr(e))
                elif op == b"PING":
                    self._send(b"PONG" + _CRLF)
                elif op == b"PONG":
                    with self._pong_lock:
                        w = (self._pong_waiters.pop(0)
                             if self._pong_waiters else None)
                    if w is not None:
                        w.set()
                # +OK / -ERR / INFO updates: record errors, ignore the rest
                elif op == b"-ERR":
                    self.errors.append(rest.decode(errors="replace"))
        except (ConnectionError, OSError):
            self._connected.clear()
