"""Minimal threaded HTTP service kit (routing + JSON + multipart).

The port's copy of the core of `seaweedfs_tpu/server/httpd.py`, on
http.server.ThreadingHTTPServer: the `route` decorator, `Request`,
`Response`, and the client helpers `http_request`, `get_json`,
`post_json` and `peer_url`.

Not ported: request metrics, the debug and profiler endpoints, QoS,
trace propagation, TLS, the IP guard, unix-socket listeners and the
pooled client.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

DEFAULT_TIMEOUT = 30.0  # seconds; no outbound call may hang a worker forever
# peers are cluster-internal: never route them through an environment proxy
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, match: re.Match) -> None:
        self.handler = handler
        self.match = match
        parsed = urllib.parse.urlparse(handler.path)
        self.path = parsed.path
        self.query = {
            k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        self.headers = handler.headers
        self.method = handler.command
        self._body: bytes | None = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = int(self.headers.get("Content-Length") or 0)
            self._body = self.handler.rfile.read(length) if length else b""
        return self._body

    def json(self) -> dict:
        if not self.body:
            return {}
        return json.loads(self.body)

    def multipart_file(self) -> tuple[str, str, bytes] | None:
        """Parse the first file part of a multipart/form-data body ->
        (filename, content_type, data); None if not multipart."""
        ctype = self.headers.get("Content-Type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if "multipart/form-data" not in ctype or not m:
            return None
        boundary = m.group(1).encode()
        parts = self.body.split(b"--" + boundary)
        for part in parts:
            if b"\r\n\r\n" not in part:
                continue
            head, _, data = part.partition(b"\r\n\r\n")
            if data.endswith(b"\r\n"):
                data = data[:-2]
            head_s = head.decode("utf-8", "replace")
            fm = re.search(r'filename="([^"]*)"', head_s)
            if fm is None:
                continue
            cm = re.search(r"Content-Type:\s*([^\r\n]+)", head_s, re.I)
            return fm.group(1), (cm.group(1).strip() if cm else ""), data
        return None


class Response:
    def __init__(
        self,
        body: bytes | str | dict | None = None,
        status: int = 200,
        headers: dict | None = None,
        content_type: str | None = None,
    ) -> None:
        self.status = status
        self.headers = dict(headers or {})
        if isinstance(body, dict):
            self.body = json.dumps(body).encode()
            self.headers.setdefault("Content-Type", "application/json")
        elif isinstance(body, str):
            self.body = body.encode()
            self.headers.setdefault("Content-Type", "text/plain; charset=utf-8")
        else:
            self.body = body or b""
            if content_type:
                self.headers.setdefault("Content-Type", content_type)


class HTTPService:
    """Route table + server lifecycle. Routes are (method, regex) -> fn(req)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.routes: list[tuple[str, re.Pattern, Callable[[Request], Response]]] = []
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def route(self, method: str, pattern: str):
        compiled = re.compile(pattern)

        def deco(fn):
            self.routes.append((method, compiled, fn))
            return fn

        return deco

    def _dispatch(self, handler: BaseHTTPRequestHandler) -> None:
        path = urllib.parse.urlparse(handler.path).path
        req = None
        for method, pattern, fn in self.routes:
            if method != handler.command:
                continue
            m = pattern.fullmatch(path)
            if m is None:
                continue
            req = Request(handler, m)
            try:
                resp = fn(req)
            except Exception as e:  # uniform JSON error surface
                resp = Response({"error": str(e)}, status=500)
            break
        else:
            resp = Response({"error": f"no route {handler.command} {path}"}, 404)
        # drain an unread request body before responding — on a keep-alive
        # connection leftover body bytes would desynchronize the next request
        length = int(handler.headers.get("Content-Length") or 0)
        if length and (req is None or req._body is None):
            try:
                handler.rfile.read(length)
            except Exception:
                pass
        try:
            handler.send_response(resp.status)
            body = resp.body
            if "Content-Length" not in resp.headers:
                handler.send_header("Content-Length", str(len(body)))
            for k, v in resp.headers.items():
                handler.send_header(k, v)
            handler.end_headers()
            if handler.command != "HEAD":
                handler.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def start(self) -> None:
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # response headers+body are
            # separate writes; Nagle would stall keep-alive clients ~40ms

            def log_message(self, fmt, *args):  # silent
                pass

            def _handle(self):
                service._dispatch(self)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _handle

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def peer_url(hostport: str) -> str:
    """Scheme-qualify another node's advertised host:port (plain HTTP:
    the port has no TLS)."""
    if hostport.startswith(("http://", "https://")):
        return hostport
    return f"http://{hostport}"


# --- tiny client helpers ----------------------------------------------------
def http_request(
    method: str,
    url: str,
    body: bytes | None = None,
    headers: dict | None = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def get_json(url: str, timeout: float = DEFAULT_TIMEOUT) -> dict:
    status, _, body = http_request("GET", url, timeout=timeout)
    data = json.loads(body) if body else {}
    if status >= 400:
        raise IOError(f"GET {url} -> {status}: {data}")
    return data


def post_json(url: str, payload: dict | None = None,
              timeout: float = DEFAULT_TIMEOUT) -> dict:
    body = json.dumps(payload or {}).encode()
    status, _, out = http_request(
        "POST", url, body, {"Content-Type": "application/json"}, timeout
    )
    data = json.loads(out) if out else {}
    if status >= 400:
        raise IOError(f"POST {url} -> {status}: {data}")
    return data
