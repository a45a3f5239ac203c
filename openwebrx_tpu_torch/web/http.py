"""Minimal asyncio HTTP server + router.

Replaces the reference's stdlib ThreadingMixIn HTTPServer + regex Router
(reference ``owrx/http.py:90-222``, ``owrx/__main__.py:34-40``) with one
event loop.  Routes: static assets from ``htdocs/``, the WebSocket
upgrade at ``/ws/``, and JSON API endpoints (status, features, metrics).
"""

from __future__ import annotations

import asyncio
import json
import logging
import mimetypes
import os
import re
from email.utils import formatdate

logger = logging.getLogger(__name__)

def _find_htdocs() -> str:
    """Web asset root: OWRX_HTDOCS env override, the repo checkout next to
    the package (development), or the system install location (deploy/)."""
    repo = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "htdocs")
    for cand in (os.environ.get("OWRX_HTDOCS"), repo,
                 "/usr/share/openwebrx-tpu/htdocs"):
        if cand and os.path.isdir(cand):
            return cand
    return repo


HTDOCS = _find_htdocs()


class Request:
    def __init__(self, method, path, headers, body, reader, writer):
        self.method = method
        self.path = path
        self.query = {}
        if "?" in path:
            self.path, qs = path.split("?", 1)
            for pair in qs.split("&"):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    self.query[k] = v
        self.headers = headers
        self.body = body
        self.reader = reader
        self.writer = writer
        self.matches = None


def response(status: int, body: bytes = b"", content_type: str = "text/plain",
             headers: dict | None = None) -> bytes:
    reason = {200: "OK", 304: "Not Modified", 400: "Bad Request",
              404: "Not Found", 500: "Internal Server Error"}.get(status, "")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            f"Date: {formatdate(usegmt=True)}",
            "Connection: keep-alive"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def json_response(data, status: int = 200,
                  headers: dict | None = None) -> bytes:
    return response(status, json.dumps(data, indent=2).encode(),
                    "application/json", headers)


class Router:
    def __init__(self):
        self.static_routes = {}
        self.regex_routes = []
        self.websocket_handler = None

    def add(self, path: str, handler, method: str = "GET"):
        self.static_routes[(method, path)] = handler

    def add_regex(self, pattern: str, handler, method: str = "GET"):
        self.regex_routes.append((method, re.compile(pattern), handler))

    def route(self, request: Request):
        handler = self.static_routes.get((request.method, request.path))
        if handler is not None:
            return handler
        for method, rx, handler in self.regex_routes:
            if method == request.method:
                m = rx.match(request.path)
                if m:
                    request.matches = m
                    return handler
        return None


class HttpServer:
    def __init__(self, router: Router, port: int = 8073, host: str = "0.0.0.0",
                 ssl_context=None):
        self.router = router
        self.port = port
        self.host = host
        self.ssl_context = ssl_context
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, ssl=self.ssl_context)
        logger.info("HTTP%s server listening on %s:%d",
                    "S" if self.ssl_context else "", self.host, self.port)

    async def stop(self):
        if self._server is not None:
            self._server.close()
            # long-lived websocket handlers never return on their own —
            # close their transports or wait_closed() blocks forever
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:
                    pass
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                request = await self._read_request(reader, writer)
                if request is None:
                    break
                if request.headers.get("upgrade", "").lower() == "websocket":
                    if self.router.websocket_handler is not None:
                        await self.router.websocket_handler(request)
                    return  # connection consumed by websocket
                handler = self.router.route(request)
                if handler is None:
                    writer.write(response(404, b"not found"))
                else:
                    result = handler(request)
                    if asyncio.iscoroutine(result):
                        result = await result
                    writer.write(result)
                await writer.drain()
                if request.headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("request handling failed")
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader, writer) -> Request | None:
        try:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=300)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
            return None
        lines = head.decode("latin1").split("\r\n")
        try:
            method, path, _ = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        body = b""
        length = int(headers.get("content-length", 0))
        if length:
            body = await reader.readexactly(length)
        return Request(method, path, headers, body, reader, writer)


# asset pipeline (reference owrx/controllers/assets.py:57-225): client-side
# caching via Last-Modified / If-Modified-Since, gzip for compressible
# types, and concatenated JS bundles — all keyed on file mtimes so edits
# invalidate instantly in development.
_COMPRESSIBLE = ("text/", "application/javascript", "application/json",
                 "image/svg+xml", "application/xml")
_GZIP_CACHE: dict[str, tuple[float, bytes]] = {}

# bundle name → source files (relative to htdocs), concatenated in order
# (reference CompiledAssetsController.profiles, assets.py:120-198)
JS_BUNDLES = {
    "compiled/receiver.js": [
        "lib/AudioEngine.js", "lib/Waterfall.js", "lib/MessagePanel.js",
        "lib/MetaPanel.js", "lib/Bandplan.js", "lib/Lookup.js",
        "plugins.js", "receiver.js",
    ],
    "compiled/map.js": ["lib/Map.js"],
}
_BUNDLE_CACHE: dict[str, tuple[tuple, bytes]] = {}


def _http_date(ts: float) -> str:
    return formatdate(ts, usegmt=True)


def _etag(mtime: float, size: int) -> str:
    """Strong validator from (mtime, size): unlike If-Modified-Since
    (whole-second granularity), this catches a file modified twice within
    one second during development."""
    return f'"{int(mtime * 1e6):x}-{size:x}"'


def _cache_headers(mtime: float, size: int) -> dict:
    return {"Cache-Control": "no-cache",
            "Last-Modified": _http_date(mtime),
            "ETag": _etag(mtime, size)}


def _client_has_current(request: Request, mtime: float,
                        size: int | None = None) -> bool:
    # ETag wins when the client sent one (RFC 9110 §13.1.3)
    inm = request.headers.get("if-none-match")
    if inm is not None:
        return size is not None and _etag(mtime, size) in inm
    ims = request.headers.get("if-modified-since")
    if not ims:
        return False
    try:
        from email.utils import parsedate_to_datetime
        return parsedate_to_datetime(ims).timestamp() >= int(mtime)
    except (TypeError, ValueError):
        return False


def _maybe_gzip(request: Request, body: bytes, ctype: str, key: str,
                mtime: float, headers: dict) -> bytes:
    if len(body) < 512 or not ctype.startswith(_COMPRESSIBLE):
        return body
    if "gzip" not in request.headers.get("accept-encoding", ""):
        return body
    cached = _GZIP_CACHE.get(key)
    if cached is None or cached[0] != mtime:
        import gzip as _gzip
        cached = (mtime, _gzip.compress(body, 6))
        _GZIP_CACHE[key] = cached
    headers["Content-Encoding"] = "gzip"
    return cached[1]


def _serve_bundle(request: Request, rel: str, root: str) -> bytes:
    parts = [os.path.join(root, p) for p in JS_BUNDLES[rel]]
    try:
        mtimes = tuple(os.path.getmtime(p) for p in parts)
    except OSError:
        return response(404, b"bundle source missing")
    newest = max(mtimes)
    cached = _BUNDLE_CACHE.get(rel)
    if cached is None or cached[0] != mtimes:
        chunks = []
        for p in parts:
            with open(p, "rb") as f:
                chunks.append(b"/* --- %s --- */\n" % os.path.basename(p).encode())
                chunks.append(f.read())
                chunks.append(b"\n")
        cached = (mtimes, b"".join(chunks))
        _BUNDLE_CACHE[rel] = cached
    # 304 responses repeat the validators (RFC 9110 §15.4.5)
    headers = _cache_headers(newest, len(cached[1]))
    if _client_has_current(request, newest, len(cached[1])):
        return response(304, b"", headers=headers)
    body = _maybe_gzip(request, cached[1], "application/javascript",
                       "bundle:" + rel, newest, headers)
    return response(200, body, "application/javascript", headers)


def serve_static(request: Request, root: str = HTDOCS) -> bytes:
    rel = request.path.lstrip("/") or "index.html"
    if rel in JS_BUNDLES:
        return _serve_bundle(request, rel, root)
    # normalize and confine to the document root
    full = os.path.normpath(os.path.join(root, rel))
    if not full.startswith(os.path.abspath(root)):
        return response(404, b"not found")
    if os.path.isdir(full):
        full = os.path.join(full, "index.html")
    if not os.path.isfile(full):
        return response(404, b"not found")
    st = os.stat(full)
    mtime, size = st.st_mtime, st.st_size
    headers = _cache_headers(mtime, size)
    if _client_has_current(request, mtime, size):
        return response(304, b"", headers=headers)
    ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
    with open(full, "rb") as f:
        body = f.read()
    body = _maybe_gzip(request, body, ctype, full, mtime, headers)
    return response(200, body, ctype, headers)
