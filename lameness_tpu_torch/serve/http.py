"""Minimal stdlib HTTP + WebSocket framework for the admin API (port of
``lameness_tpu/serve/http.py``, copied line for line: the standard library
only).

The reference serves its admin surface with FastAPI + uvicorn; neither is
in this image, so this module provides the small subset needed: a router
with path parameters, JSON request/response handling, role-based auth
middleware (HMAC-signed tokens, scrypt password hashes — bcrypt-free),
CORS, and RFC6455 WebSocket channels with broadcast + dead-connection
cleanup mirroring ``admin-interface/backend/app/websocket/handler.py``.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import re
import secrets
import select
import socket
import struct
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# auth primitives
# ---------------------------------------------------------------------------
def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt or secrets.token_bytes(16)
    digest = hashlib.scrypt(password.encode(), salt=salt, n=2 ** 14, r=8, p=1)
    return base64.b64encode(salt).decode() + "$" + \
        base64.b64encode(digest).decode()


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_b64, digest_b64 = stored.split("$")
        salt = base64.b64decode(salt_b64)
        digest = hashlib.scrypt(password.encode(), salt=salt,
                                n=2 ** 14, r=8, p=1)
        return hmac.compare_digest(digest, base64.b64decode(digest_b64))
    except Exception:
        return False


class TokenCodec:
    """HMAC-SHA256 signed tokens (JWT-shaped, stdlib only)."""

    def __init__(self, secret: Optional[bytes] = None):
        self.secret = secret or secrets.token_bytes(32)

    def encode(self, payload: Dict[str, Any], ttl_s: int = 86400) -> str:
        payload = dict(payload, exp=time.time() + ttl_s)
        body = base64.urlsafe_b64encode(json.dumps(payload).encode())
        sig = hmac.new(self.secret, body, hashlib.sha256).digest()
        return body.decode() + "." + base64.urlsafe_b64encode(sig).decode()

    def decode(self, token: str) -> Optional[Dict[str, Any]]:
        try:
            body_b64, sig_b64 = token.split(".")
            body = body_b64.encode()
            sig = base64.urlsafe_b64decode(sig_b64)
            expect = hmac.new(self.secret, body, hashlib.sha256).digest()
            # strict: signature must round-trip exactly (b64decode is lenient
            # about trailing garbage)
            if base64.urlsafe_b64encode(sig).decode() != sig_b64:
                return None
            if not hmac.compare_digest(sig, expect):
                return None
            payload = json.loads(base64.urlsafe_b64decode(body))
            if payload.get("exp", 0) < time.time():
                return None
            return payload
        except Exception:
            return None


# ---------------------------------------------------------------------------
# request / router
# ---------------------------------------------------------------------------
@dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]
    query: Dict[str, str]
    body: Any
    headers: Dict[str, str]
    user: Optional[Dict[str, Any]] = None
    raw: Optional[bytes] = None


@dataclass
class Route:
    method: str
    regex: re.Pattern
    handler: Callable[[Request], Any]
    auth: bool = False
    roles: Optional[List[str]] = None
    n_params: int = 0


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def _compile(pattern: str) -> re.Pattern:
    regex = re.sub(r"{(\w+)}", r"(?P<\1>[^/]+)", pattern)
    return re.compile("^" + regex + "/?$")


class Router:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.routes: List[Route] = []

    def add(self, method: str, pattern: str, handler, auth=False, roles=None):
        self.routes.append(Route(method, _compile(self.prefix + pattern),
                                 handler, auth, roles,
                                 pattern.count("{")))
        # literal routes match before parameterized ones regardless of
        # registration order (/api/analysis/similarity/map must not be
        # swallowed by /api/analysis/{video_id}/{pipeline})
        self.routes.sort(key=lambda r: r.n_params)

    def get(self, pattern, **kw):
        return lambda fn: (self.add("GET", pattern, fn, **kw), fn)[1]

    def post(self, pattern, **kw):
        return lambda fn: (self.add("POST", pattern, fn, **kw), fn)[1]

    def put(self, pattern, **kw):
        return lambda fn: (self.add("PUT", pattern, fn, **kw), fn)[1]

    def patch(self, pattern, **kw):
        return lambda fn: (self.add("PATCH", pattern, fn, **kw), fn)[1]

    def delete(self, pattern, **kw):
        return lambda fn: (self.add("DELETE", pattern, fn, **kw), fn)[1]


# ---------------------------------------------------------------------------
# websocket
# ---------------------------------------------------------------------------
_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()


def ws_send(sock: socket.socket, text: str) -> None:
    data = text.encode()
    header = bytearray([0x81])
    n = len(data)
    if n < 126:
        header.append(n)
    elif n < 65536:
        header.append(126)
        header += struct.pack(">H", n)
    else:
        header.append(127)
        header += struct.pack(">Q", n)
    sock.sendall(bytes(header) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on EOF.  TCP delivers a stream, not
    frames — a 2-byte WS header can arrive split across packets (common
    through proxies), so every fixed-size field needs a loop."""
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return data


def ws_recv(sock: socket.socket) -> Optional[str]:
    """Read one text frame (client frames are masked); None on close."""
    try:
        head = _recv_exact(sock, 2)
        if head is None:
            return None
        opcode = head[0] & 0x0F
        if opcode == 0x8:
            return None
        masked = head[1] & 0x80
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", _recv_exact(sock, 2))[0]
        elif n == 127:
            n = struct.unpack(">Q", _recv_exact(sock, 8))[0]
        mask = _recv_exact(sock, 4) if masked else b"\x00" * 4
        data = _recv_exact(sock, n)
        if data is None or mask is None:
            return None
        if masked:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        return data.decode(errors="replace")
    except Exception:
        return None


class WebSocketManager:
    """Channel registry with broadcast + dead-connection cleanup
    (websocket/handler.py:15-103)."""

    CHANNELS = ("pipeline", "health", "queue", "rater")

    def __init__(self):
        self._conns: Dict[str, List[socket.socket]] = {
            c: [] for c in self.CHANNELS}
        self._lock = threading.Lock()

    def register(self, channel: str, sock: socket.socket) -> None:
        with self._lock:
            self._conns.setdefault(channel, []).append(sock)

    def unregister(self, channel: str, sock: socket.socket) -> None:
        with self._lock:
            if sock in self._conns.get(channel, []):
                self._conns[channel].remove(sock)

    def broadcast(self, channel: str, message: Dict[str, Any]) -> int:
        text = json.dumps(message)
        dead = []
        with self._lock:
            conns = list(self._conns.get(channel, []))
        for s in conns:
            try:
                ws_send(s, text)
            except Exception:
                dead.append(s)
        for s in dead:
            self.unregister(channel, s)
        return len(conns) - len(dead)

    def connection_count(self, channel: str) -> int:
        return len(self._conns.get(channel, []))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class AdminHTTPServer:
    def __init__(self, router: Router, tokens: TokenCodec,
                 ws_manager: Optional[WebSocketManager] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.router = router
        self.tokens = tokens
        self.ws = ws_manager or WebSocketManager()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _dispatch(self, method):
                try:
                    outer._handle(self, method)
                except BrokenPipeError:
                    pass

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_PATCH(self):
                self._dispatch("PATCH")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def do_OPTIONS(self):
                self.send_response(204)
                outer._cors(self)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- plumbing ------------------------------------------------------------
    @staticmethod
    def _cors(h):
        h.send_header("Access-Control-Allow-Origin", "*")
        h.send_header("Access-Control-Allow-Headers",
                      "Authorization, Content-Type")
        h.send_header("Access-Control-Allow-Methods",
                      "GET, POST, PUT, PATCH, DELETE, OPTIONS")

    def _respond(self, h, status: int, obj: Any) -> None:
        data = json.dumps(obj).encode()
        h.send_response(status)
        self._cors(h)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _respond_bytes(self, h, status: int, data: bytes,
                       content_type: str,
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> None:
        h.send_response(status)
        self._cors(h)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(data)

    def _handle(self, h, method: str) -> None:
        parsed = urllib.parse.urlparse(h.path)
        path = parsed.path
        query = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}

        # websocket upgrade?
        if h.headers.get("Upgrade", "").lower() == "websocket":
            self._handle_ws(h, path)
            return

        length = int(h.headers.get("Content-Length") or 0)
        raw = h.rfile.read(length) if length else b""
        try:
            body = json.loads(raw) if raw else None
        except Exception:
            body = None

        for route in self.router.routes:
            if route.method != method:
                continue
            m = route.regex.match(path)
            if not m:
                continue
            req = Request(method=method, path=path, params=m.groupdict(),
                          query=query, body=body,
                          headers={k: v for k, v in h.headers.items()},
                          raw=raw)
            if route.auth or route.roles:
                auth = h.headers.get("Authorization", "")
                token = auth[7:] if auth.startswith("Bearer ") else None
                payload = self.tokens.decode(token) if token else None
                if payload is None:
                    self._respond(h, 401, {"detail": "Not authenticated"})
                    return
                if route.roles and payload.get("role") not in route.roles:
                    self._respond(h, 403, {"detail": "Insufficient role"})
                    return
                req.user = payload
            else:
                # optional auth (reference get_optional_user): ungated
                # handlers see the caller when a valid token is sent —
                # e.g. /api/elo/stats personalizes user_stats
                auth = h.headers.get("Authorization", "")
                token = auth[7:] if auth.startswith("Bearer ") else None
                payload = self.tokens.decode(token) if token else None
                if payload is not None:
                    req.user = payload
            try:
                result = route.handler(req)
                if isinstance(result, tuple) and len(result) == 2 and \
                        isinstance(result[0], int):
                    self._respond(h, result[0], result[1])
                elif isinstance(result, tuple) and len(result) == 3:
                    self._respond_bytes(h, result[0], result[1], result[2])
                elif isinstance(result, tuple) and len(result) == 4:
                    # (status, bytes, content_type, extra_headers)
                    self._respond_bytes(h, result[0], result[1], result[2],
                                        result[3])
                else:
                    self._respond(h, 200, result)
            except HTTPError as e:
                self._respond(h, e.status, {"detail": e.detail})
            except Exception as e:
                self._respond(h, 500, {"detail": repr(e)[:300]})
            return
        self._respond(h, 404, {"detail": f"Not found: {method} {path}"})

    def _handle_ws(self, h, path: str) -> None:
        m = re.match(r"^/api/ws/(\w+)/?$", path)
        channel = m.group(1) if m else None
        if channel not in WebSocketManager.CHANNELS:
            self._respond(h, 404, {"detail": "unknown ws channel"})
            return
        key = h.headers.get("Sec-WebSocket-Key", "")
        h.send_response(101)
        h.send_header("Upgrade", "websocket")
        h.send_header("Connection", "Upgrade")
        h.send_header("Sec-WebSocket-Accept", _ws_accept_key(key))
        h.end_headers()
        sock = h.connection
        self.ws.register(channel, sock)
        try:
            while True:
                # reference keepalive (websocket/handler.py:193-212):
                # 30 s idle -> server sends {"type": "ping"}; select
                # (not a socket timeout) so a frame split across
                # packets can never be half-consumed
                r, _, _ = select.select([sock], [], [], 30.0)
                if not r:
                    try:
                        ws_send(sock, json.dumps({"type": "ping"}))
                    except OSError:
                        break
                    continue
                msg = ws_recv(sock)
                if msg is None:
                    break
                # bare-text ping -> bare-text pong, exactly the
                # reference convention (handler.py:197-199)
                if msg == "ping":
                    ws_send(sock, "pong")
        finally:
            self.ws.unregister(channel, sock)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
