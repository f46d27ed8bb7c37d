"""Minimal threaded HTTP service kit (routing + JSON + multipart).

The port's copy of the core of `seaweedfs_tpu/server/httpd.py`, on
http.server.ThreadingHTTPServer: the `route` decorator, `Request` (with
`multipart_file` and `multipart_form`, the S3 POST-policy upload's
parser), `Response`, the client helpers `http_request`, `get_json`,
`post_json` and `peer_url`, and `PooledHTTP`, the keep-alive client of
the filer's data-plane hops. The first `HTTPService.start` of a process
sets the GIL switch interval to 0.5 ms (`SEAWEEDFS_TPU_SWITCH_INTERVAL`;
"0" keeps Python's 5 ms), as the JAX service does.

Every service serves `GET /debug/faults` (the process's fault points and
their state) and `POST /debug/faults` (arm, disarm, disarm_all), registered
first so a catch-all namespace (the filer, the S3 gateway) cannot shadow
them. The POST answers 403 unless the process opted in
(`faults.enable()`, a server built with `faults_spec`, or
SEAWEEDFS_TPU_FAULTS=1).

The handler answers the WebDAV verbs (PROPFIND, PROPPATCH, MKCOL, MOVE,
COPY, LOCK, UNLOCK) beside the HTTP ones. `enable_unix_socket(path)` adds
an AF_UNIX listener on the same routes (the filer's `-filer.localSocket`,
the mount's admin socket), advertised as `unix_url`; `http_request` and
`PooledHTTP` speak `http+unix://<percent-encoded socket path><path>`
URLs. A service whose `plain_backend` is set binds its TCP side to
127.0.0.1.

Security (`security/`): a service whose `guard` is set answers 403 to a
peer whose IP the white list does not admit. Once `security.tls` is
configured, every service started afterwards listens with mutual TLS (a
client certificate signed by the CA is required; the handshake runs in
the connection's handler thread, not the accept loop) and answers 403 to
a certificate whose CommonName the allow-list, captured at start, does
not match; its `url` is `https`, `peer_url` qualifies bare addresses as
`https`, and `http_request` and `PooledHTTP` present the client
certificate on every `https` connection. The unix-socket listener is
same-host-trusted: neither the CN gate nor the guard applies there. A
`plain_backend` listener stays plain.

Observability (`stats/`): `enable_metrics(role)` counts and times every
request under the role's label (`SeaweedFS_http_request_{total,seconds}`),
serves `/metrics` unless the role has a catch-all namespace (the filer
serves it on a `MetricsService`, its metrics port), and starts the
process's history loop, alert engine and events journal and the role's
request spans. `enable_tracing` registers the debug routes:
`/debug/traces`, `/debug/requests`, `/debug/pprof/{profile,threads,device}`
(the device route is a `torch.profiler` capture of the process's CUDA
activity), `/debug/metrics/history`, `/debug/alerts` and `/debug/events`.
`http_request` and `PooledHTTP` carry the active span's trace headers
(`X-Sw-Trace-Id`, `X-Sw-Span`) to the next hop.

Tenants and QoS (`stats/{usage,heat}.py`, `qos/`): `enable_metrics` also
registers the process's usage accountant and heat engine, and the debug
routes serve `/debug/usage` and `/debug/heat` (?n= caps the rows),
`GET /qos/limits` (= `/debug/qos`: the admission controller's state and
the burn actuator's level) and `POST /qos/limits` (replace the limit
table at runtime; arms admission).
"""

from __future__ import annotations

import http.client
import json
import math
import os
import re
import socket
import ssl
import sys
import threading
import time
import weakref
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .. import __version__
from ..qos import actuator as act_mod
from ..qos import admission as qos_mod
from ..security import tls as _tls
from ..stats import alerts as alerts_mod
from ..stats import default_registry
from ..stats import events as events_mod
from ..stats import heat as heat_mod
from ..stats import history as history_mod
from ..stats import profiler as prof_mod
from ..stats import trace as trace_mod
from ..stats import usage as usage_mod
from ..stats.metrics import PROCESS_START_TIME
from ..util import faults as faults_mod

DEFAULT_TIMEOUT = 30.0  # seconds; no outbound call may hang a worker forever
# peers are cluster-internal: never route them through an environment proxy
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, match: re.Match) -> None:
        self.handler = handler
        self.match = match
        parsed = urllib.parse.urlparse(handler.path)
        self.path = parsed.path
        self.raw_query = parsed.query  # exact bytes: fastlane profile keys
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

    def multipart_form(self) -> tuple[dict, tuple[str, str, bytes] | None]:
        """Parse a multipart/form-data body -> ({field: value}, file_part)
        where file_part is (filename, content_type, data) for the part named
        "file" (or any part carrying a filename). Browser-POST uploads
        (S3 post-policy) arrive this way."""
        ctype = self.headers.get("Content-Type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        fields: dict = {}
        if "multipart/form-data" not in ctype or not m:
            return fields, None
        boundary = m.group(1).encode()
        file_part = None
        for part in self.body.split(b"--" + boundary):
            if b"\r\n\r\n" not in part:
                continue
            head, _, data = part.partition(b"\r\n\r\n")
            if data.endswith(b"\r\n"):
                data = data[:-2]
            head_s = head.decode("utf-8", "replace")
            nm = re.search(r'name="([^"]*)"', head_s)
            if nm is None:
                continue
            fm = re.search(r'filename="([^"]*)"', head_s)
            if fm is not None:
                cm = re.search(r"Content-Type:\s*([^\r\n]+)", head_s, re.I)
                file_part = (
                    fm.group(1), (cm.group(1).strip() if cm else ""), data
                )
            else:
                fields[nm.group(1)] = data.decode("utf-8", "replace")
        return fields, file_part


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


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5. Clients that open a
    # connection a request (urllib, the gateways' filer hops) overflow it
    # under a few dozen concurrent requests, and each dropped SYN waits out
    # a retransmit of 1, 3, 7, 15 or 31 s, past a 30 s client timeout.
    # The kernel caps the value at net.core.somaxconn.
    request_queue_size = 1024


class HTTPService:
    """Route table + server lifecycle. Routes are (method, regex) -> fn(req)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.routes: list[tuple[str, re.Pattern, Callable[[Request], Response]]] = []
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._unix_httpd: ThreadingHTTPServer | None = None
        self._unix_path: str | None = None
        # a listener only same-host code reaches (the mount's admin service)
        # binds its TCP side to loopback, never an external interface, and
        # stays plain under process mTLS
        self.plain_backend = False
        self.guard = None  # security.Guard: 403 to IPs it does not admit
        self._tls_on = False  # set at start(): this listener serves mTLS
        self._allowed_cns: list = []  # the CN allow-list captured at start()
        self.metrics_role: str | None = None  # instrument requests when set
        self.trace_role: str | None = None  # record request spans when set
        _register_fault_routes(self)

    def enable_metrics(self, role: str, serve_route: bool = True) -> None:
        """Count and time every request under this role label and (unless
        the main port has a catch-all namespace, like the filer's) serve
        the Prometheus text format on /metrics (`weed/stats/metrics.go`).
        The first metered service of a process starts its history loop,
        alert engine and events journal."""
        self.metrics_role = role
        reg = default_registry()
        self._m_total = reg.counter(
            "SeaweedFS_http_request_total", "requests", ("role", "method", "code")
        )
        # exemplars: each latency sample carries the active trace id, so a
        # cluster.top p99 row links to the trace that landed in that bucket
        self._m_seconds = reg.histogram(
            "SeaweedFS_http_request_seconds", "request latency",
            ("role", "method"), exemplars=True,
        )
        if serve_route:
            self.route("GET", r"/metrics")(_metrics_route(reg))
        # process identity: start time (the history ring's restart signal)
        # and a build_info series a role: cluster.top's uptime and version.
        # Whole seconds render exactly in the exposition.
        reg.gauge(
            "SeaweedFS_process_start_time_seconds",
            "unix time this process started (counter-reset detection)",
        ).set(int(PROCESS_START_TIME))
        reg.gauge(
            "SeaweedFS_build_info",
            "constant 1, labeled with the build version and server role",
            ("version", "role"),
        ).labels(__version__, role).set(1)
        history_mod.default_history().start()
        alerts_mod.engine()
        events_mod.enable()
        usage_mod.enable()
        heat_mod.enable()
        self.enable_tracing(role)

    def enable_tracing(self, role: str) -> None:
        """Record a span for every request under this role (inheriting the
        caller's trace through X-Sw-Trace-Id/X-Sw-Span) and serve the debug
        routes. Idempotent."""
        if self.trace_role is not None:
            return
        self.trace_role = role
        _register_debug_routes(self)

    def serve_debug_routes(self) -> None:
        """Serve the debug routes without request spans (a standalone
        listener such as MetricsService)."""
        _register_debug_routes(self)

    def route(self, method: str, pattern: str):
        compiled = re.compile(pattern)

        def deco(fn):
            self.routes.append((method, compiled, fn))
            return fn

        return deco

    def _admitted(self, handler: BaseHTTPRequestHandler) -> Response | None:
        """The mTLS CN gate, then the IP guard: a 403 for a peer either
        refuses, else None. A unix-socket peer is same-host-trusted:
        neither applies (no TLS on AF_UNIX, no IP to whitelist)."""
        if getattr(handler, "_unix_peer", False):
            return None
        if self._tls_on:
            try:
                ok = _tls.peer_allowed(handler.connection.getpeercert(),
                                       self._allowed_cns)
            except Exception:
                ok = False
            if not ok:
                return Response({"error": "client certificate CN not allowed"}, 403)
        addr = handler.client_address
        if self.guard is not None and isinstance(addr, tuple) and addr \
                and not self.guard.is_allowed(addr[0]):
            return Response({"error": "forbidden"}, 403)
        return None

    def _dispatch(self, handler: BaseHTTPRequestHandler) -> None:
        start = time.monotonic()
        path = urllib.parse.urlparse(handler.path).path
        span = None
        if self.trace_role is not None:
            span = trace_mod.begin_server_span(
                self.trace_role, handler.command, path, handler.headers
            )
        req = None
        resp = self._admitted(handler)
        if resp is None:
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
                    from ..util.sentry import capture_exception

                    capture_exception(e, path=path, method=handler.command)
                    resp = Response({"error": str(e)}, status=500)
                break
            else:
                resp = Response({"error": f"no route {handler.command} {path}"}, 404)
        # a QoS shed (X-Sw-Qos-Reason rides every one) is a deliberate
        # refusal ahead of service, not a failure: counting its 503 would
        # burn the availability SLO the shed protects
        if self.metrics_role is not None and "X-Sw-Qos-Reason" not in resp.headers:
            self._m_total.labels(
                self.metrics_role, handler.command, str(resp.status)
            ).inc()
            self._m_seconds.labels(
                self.metrics_role, handler.command
            ).observe(time.monotonic() - start)
        if span is not None:
            resp.headers.setdefault(trace_mod.TRACE_HEADER, span.trace_id)
            trace_mod.end_server_span(span, resp.status)
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

    _SWITCH_INTERVAL_SET = False

    def start(self) -> None:
        # Many handler threads on few cores convoy badly on the default 5ms
        # GIL switch interval (p99 explodes, throughput collapses ~2-4x on a
        # single-core host). Request serving is IO-and-syscall heavy and the
        # kernels release the GIL, so a sub-ms interval is the right trade
        # for every server in this process, once per process. Override:
        # SEAWEEDFS_TPU_SWITCH_INTERVAL (seconds; "0" leaves the default).
        if not HTTPService._SWITCH_INTERVAL_SET:
            HTTPService._SWITCH_INTERVAL_SET = True
            val = os.environ.get("SEAWEEDFS_TPU_SWITCH_INTERVAL", "0.0005")
            try:
                if float(val) > 0:
                    sys.setswitchinterval(float(val))
            except ValueError:
                pass
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
            # OPTIONS: the S3 gateway's CORS preflight and WebDAV's probe;
            # the rest are WebDAV's verbs (webdav_server.go surface)
            do_OPTIONS = do_PROPFIND = do_PROPPATCH = do_MKCOL = _handle
            do_MOVE = do_COPY = do_LOCK = do_UNLOCK = _handle

        ctx = None if self.plain_backend else _tls.server_context()
        self._tls_on = ctx is not None
        self._allowed_cns = _tls.allowed_cn_patterns()
        bind_host = "127.0.0.1" if self.plain_backend else self.host
        if ctx is None:
            self._httpd = _Server((bind_host, self.port), Handler)
        else:
            # mTLS on every listener (`weed/security/tls.go` semantics). The
            # accepted socket is wrapped without a handshake: it runs on the
            # first read in the connection's handler thread, so a stalled
            # client cannot pin the accept loop
            class _TLSServer(_Server):
                def get_request(inner):
                    sock, addr = inner.socket.accept()
                    sock.settimeout(60)
                    return ctx.wrap_socket(sock, server_side=True,
                                           do_handshake_on_connect=False), addr

                def handle_error(inner, request, client_address):
                    # a refused handshake (no certificate, a plain-http
                    # client, an unknown CA) is the gate working, not a fault
                    if not isinstance(sys.exc_info()[1], (ssl.SSLError, OSError)):
                        super().handle_error(request, client_address)

            self._httpd = _TLSServer((bind_host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._handler_cls = Handler
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def enable_unix_socket(self, path: str) -> None:
        """Extra AF_UNIX listener sharing this service's routes — the
        `-filer.localSocket` feature (`weed/command/filer.go`): same-host
        clients (mounts especially) skip the TCP stack. The unix path is
        same-host-trusted, like the reference's. Call after start()."""
        import socketserver

        class handler(self._handler_cls):
            # TCP_NODELAY does not exist on AF_UNIX sockets
            disable_nagle_algorithm = False
            _unix_peer = True  # same-host: exempt from the CN gate and guard

        class UnixHTTPServer(_Server):
            address_family = socket.AF_UNIX

            def server_bind(inner):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                # skip HTTPServer.server_bind: it unpacks server_address
                # as (host, port), which a unix path is not
                socketserver.TCPServer.server_bind(inner)
                inner.server_name = "localhost"
                inner.server_port = 0

        srv = UnixHTTPServer(path, handler)
        srv.daemon_threads = True
        self._unix_httpd = srv
        self._unix_path = path
        threading.Thread(target=srv.serve_forever, daemon=True).start()

    @property
    def unix_url(self) -> str | None:
        """http+unix:// URL for the local-socket listener, or None."""
        if self._unix_path is None:
            return None
        return "http+unix://" + urllib.parse.quote(self._unix_path, safe="")

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._unix_httpd is not None:
            self._unix_httpd.shutdown()
            self._unix_httpd.server_close()
            self._unix_httpd = None
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass
            self._unix_path = None  # unix_url must stop advertising it

    @property
    def url(self) -> str:
        scheme = "https" if self._tls_on else "http"
        return f"{scheme}://{self.host}:{self.port}"


def _register_fault_routes(service: HTTPService) -> None:
    @service.route("GET", r"/debug/faults")
    def debug_faults_get(req: Request) -> Response:
        snap = faults_mod.snapshot()
        return Response({
            "points": snap,
            "declared": list(faults_mod.ALL_POINTS),
            "armed": sum(1 for p in snap if p["armed"] is not None),
        })

    @service.route("POST", r"/debug/faults")
    def debug_faults_post(req: Request) -> Response:
        """Runtime fault arming for THIS process — the cluster.faults
        verb fans this out across discovered nodes. Body:
          {"action": "arm", "point": ..., "mode": ...,
           "rate"/"ms"/"frac"/"count"/"key"/"after": ...}
          {"action": "disarm", "point": ...}
          {"action": "disarm_all"}
        The fastlane engine has no injection ABI of its own, so
        engine-side injection is the Python-side drain seam,
        `volume.fastlane.drain`."""
        if not faults_mod.runtime_arming_enabled():
            # a reachable port must not be enough to arm torn writes on a
            # production server
            return Response(
                {"error": "fault injection disabled for this process"
                          " (start with -faults or SEAWEEDFS_TPU_FAULTS=1)"},
                403,
            )
        p = req.json()
        action = p.get("action", "arm")
        try:
            if action == "arm":
                spec = faults_mod.arm(
                    p["point"], p["mode"],
                    rate=p.get("rate", 1.0), ms=p.get("ms", 0.0),
                    frac=p.get("frac", 0.5), count=p.get("count", -1),
                    key=p.get("key", ""), after=p.get("after", 0),
                )
                return Response({"ok": True, "point": p["point"],
                                 "armed": spec.to_dict()})
            if action == "disarm":
                return Response({
                    "ok": True, "point": p["point"],
                    "was_armed": faults_mod.disarm(p["point"]),
                })
            if action == "disarm_all":
                return Response({"ok": True,
                                 "disarmed": faults_mod.disarm_all()})
        except (KeyError, ValueError) as e:
            return Response({"error": str(e)}, 400)
        return Response({"error": f"unknown action {action!r}"}, 400)


def _metrics_route(reg):
    def metrics(req: Request) -> Response:
        return Response(
            reg.render().encode(),
            content_type="text/plain; version=0.0.4; charset=utf-8",
        )
    return metrics


def _since_param(query: dict):
    """Parse the shared `?since=` incremental cursor (None when absent;
    ValueError on anything non-finite, which the routes answer with 400).
    /debug/metrics/history and /debug/events both take it: pass the previous
    response's unrounded `watermark` back and only newer items ship."""
    since = query.get("since")
    if since is None:
        return None
    since = float(since)
    if not math.isfinite(since):
        raise ValueError(since)
    return since


def _register_debug_routes(service: HTTPService) -> None:
    """`/debug/traces` (recent finished traces; ?limit= & ?min_ms=, or ?id=
    for one trace), `/debug/requests` (in-flight spans; ?limit=), the
    profiling surface (`/debug/pprof/profile`: ?seconds= & ?hz=,
    collapsed-stack text or ?format=json; `/debug/pprof/threads`;
    `/debug/pprof/device`: a gzipped Chrome trace of the process's CUDA
    activity, 501 without CUDA, 429 while a capture runs),
    `/debug/metrics/history` (?family= & ?window= & ?samples= & ?since=),
    `/debug/alerts` (?window=), `/debug/events` (?type= & ?volume= &
    ?trace= & ?since= & ?limit=), `/debug/usage` and `/debug/heat` (?n=),
    and `/qos/limits` (GET = `/debug/qos`, POST). On a catch-all namespace
    (the filer) they shadow same-named file paths. A malformed number is a
    400."""
    col = trace_mod.collector()

    def role():
        return service.trace_role or service.metrics_role

    @service.route("GET", r"/debug/traces")
    def debug_traces(req: Request) -> Response:
        trace_id = req.query.get("id")
        if trace_id is not None:
            # exact lookup: exemplar links and cluster.why resolve one trace
            # without paging the whole ring
            if not re.fullmatch(r"[0-9a-f]{1,32}", trace_id):
                return Response(
                    {"error": f"malformed trace id {trace_id!r}"
                              " (lowercase hex)"}, 400
                )
            spans = col.trace_spans(trace_id)
            return Response({
                "trace_id": trace_id,
                "found": bool(spans),
                "spans": spans,
            })
        try:
            limit = int(req.query.get("limit", 20))
            min_ms = float(req.query.get("min_ms", 0))
            if not math.isfinite(min_ms):
                raise ValueError(min_ms)
        except ValueError:
            return Response(
                {"error": "limit/min_ms must be finite numbers"}, 400
            )
        return Response({
            "traces": col.traces(limit=limit, min_ms=min_ms),
            "capacity": col.max_spans,
        })

    @service.route("GET", r"/debug/requests")
    def debug_requests(req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", 0))
        except ValueError:
            return Response({"error": "limit must be numeric"}, 400)
        in_flight = col.inflight()
        if limit > 0:
            in_flight = in_flight[:limit]
        return Response({"in_flight": in_flight})

    @service.route("GET", r"/debug/pprof/profile")
    def debug_pprof_profile(req: Request) -> Response:
        try:
            seconds = prof_mod.clamp_seconds(req.query.get("seconds", 2))
            hz = int(req.query.get("hz", 100))
        except ValueError:
            return Response({"error": "seconds/hz must be finite numbers"}, 400)
        try:
            out = prof_mod.profile(seconds=seconds, hz=hz)
        except prof_mod.ProfilerBusy as e:
            return Response({"error": str(e)}, 429)
        out["role"] = role()
        out["proc"] = prof_mod.PROCESS_TOKEN  # cluster.profile dedup key
        if req.query.get("format") == "json":
            return Response(out)
        return Response(prof_mod.render_collapsed(out["stacks"]))

    @service.route("GET", r"/debug/pprof/threads")
    def debug_pprof_threads(req: Request) -> Response:
        return Response({"role": role(), "threads": prof_mod.threads_dump()})

    @service.route("GET", r"/debug/metrics/history")
    def debug_metrics_history(req: Request) -> Response:
        hist = history_mod.default_history()
        try:
            window = float(req.query.get("window", hist.retention_seconds))
            max_samples = int(req.query.get("samples", 16))
            if not math.isfinite(window) or window <= 0:
                raise ValueError(window)
            since = _since_param(req.query)
        except ValueError:
            return Response(
                {"error": "window/samples/since must be finite numbers"},
                400,
            )
        hist.ensure_fresh()
        family = req.query.get("family") or None
        return Response({
            "interval": hist.interval,
            "slots": hist.slots,
            "window": window,
            "scrapes": hist.scrapes_total,
            # unrounded: a rounded-down watermark could sit below the stored
            # timestamp of the scrape it names and re-ship its samples
            "watermark": hist.last_scrape,
            "proc": prof_mod.PROCESS_TOKEN,  # cluster.top dedup key
            "series": hist.snapshot(
                family=family, window=window,
                max_samples=max(0, max_samples), since=since,
            ),
            # histogram exemplars ride here, not in the 0.0.4 text format:
            # per (labels, upper bucket), the freshest sample's trace id
            "exemplars": default_registry().exemplars(family=family),
        })

    @service.route("GET", r"/debug/alerts")
    def debug_alerts(req: Request) -> Response:
        window = req.query.get("window")
        try:
            if window is not None:
                window = float(window)
                if not math.isfinite(window) or window <= 0:
                    raise ValueError(window)
        except ValueError:
            return Response(
                {"error": "window must be a positive finite number"}, 400
            )
        out = alerts_mod.engine().status(window=window)
        out["proc"] = prof_mod.PROCESS_TOKEN
        return Response(out)

    @service.route("GET", r"/debug/events")
    def debug_events(req: Request) -> Response:
        """The events journal (stats/events.py), filtered by ?type= /
        ?volume= / ?trace= / ?collection= / ?since= (+ ?limit=).
        cluster.why fans this out across every node."""
        q = req.query
        try:
            limit = int(q.get("limit", 256))
            volume = int(q["volume"]) if "volume" in q else None
            since = _since_param(q)
        except ValueError:
            return Response(
                {"error": "limit/volume/since must be finite numbers"}, 400
            )
        type_ = q.get("type") or None
        if type_ is not None and type_ not in events_mod.EVENT_TYPES:
            return Response(
                {"error": f"unknown event type {type_!r}",
                 "types": sorted(events_mod.EVENT_TYPES)}, 400
            )
        rec = events_mod.recorder()
        return Response({
            "proc": prof_mod.PROCESS_TOKEN,  # cluster.why dedup key
            "role": role(),
            "enabled": rec.enabled,
            "capacity": rec.capacity,
            "recorded": rec.recorded_total,
            "dropped": rec.dropped_total,
            # unrounded, like the history watermark
            "watermark": rec.last_wall,
            "events": rec.events(type=type_, volume=volume,
                                 trace=q.get("trace") or None,
                                 since=since,
                                 collection=q.get("collection") or None,
                                 limit=limit),
        })

    def n_param(query: dict):
        n = int(query["n"]) if "n" in query else None
        if n is not None and n < 1:
            raise ValueError(n)
        return n

    @service.route("GET", r"/debug/usage")
    def debug_usage(req: Request) -> Response:
        """The bounded-cardinality tenant accountant (stats/usage.py):
        top-K collections by requests/bytes/errors, the `_other` fold,
        and the sketch's exported error bound. ?n= caps the tenant rows."""
        try:
            n = n_param(req.query)
        except ValueError:
            return Response({"error": "n must be a positive integer"}, 400)
        out = usage_mod.accountant().snapshot(n=n)
        out["proc"] = prof_mod.PROCESS_TOKEN
        out["role"] = role()
        return Response(out)

    @service.route("GET", r"/debug/heat")
    def debug_heat(req: Request) -> Response:
        """The heat engine's view (stats/heat.py): per-volume heat
        scores, per-node/dir days-to-full forecasts, and — on a master —
        the heartbeat-fed collection/node rollup. ?n= caps each list."""
        try:
            n = n_param(req.query)
        except ValueError:
            return Response({"error": "n must be a positive integer"}, 400)
        out = heat_mod.engine().snapshot()
        rollup_colls, rollup_nodes = [], []
        for ru in heat_mod.rollups():
            snap = ru.snapshot()
            rollup_colls.extend(snap["collections"])
            rollup_nodes.extend(snap["nodes"])
        if rollup_colls or rollup_nodes:
            out["collections"] = rollup_colls
            out["nodes"] = rollup_nodes
        if n is not None:
            for k in ("volumes", "forecast", "collections", "nodes"):
                if k in out:
                    out[k] = out[k][:n]
        out["proc"] = prof_mod.PROCESS_TOKEN
        out["role"] = role()
        return Response(out)

    @service.route("GET", r"/qos/limits")
    def qos_limits_get(req: Request) -> Response:
        """This process's admission-control state (qos/admission.py):
        limits, gates, queue bounds, admitted/queued/shed counters and
        live bucket levels. `/debug/qos` is the same payload."""
        out = qos_mod.controller().status()
        a = act_mod.actuator()
        out["actuator"] = None if a is None else {
            "level": a.level, "burn": round(a.last_burn, 3),
            "fast_burn": a.fast_burn,
        }
        out["proc"] = prof_mod.PROCESS_TOKEN
        out["role"] = role()
        return Response(out)

    service.route("GET", r"/debug/qos")(qos_limits_get)

    @service.route("POST", r"/qos/limits")
    def qos_limits_post(req: Request) -> Response:
        """Runtime limit updates for THIS process — the cluster.qos verb
        fans this out across discovered gateways. Body (all optional):
          {"limits": {"tenant-a": 100, "tenant-b": [50, 200]},
           "default": 25, "queue_depth": 32, "queue_wait": 0.25,
           "spec": "tenant-a=100,*=25"}
        `limits`/`spec` replace the whole table (declarative, like the
        CLI flag); values are rps or [rps, burst]. Posting any config
        arms admission on a metered server."""
        p = req.json()
        ctl = qos_mod.controller()
        try:
            limits, default = p.get("limits"), p.get("default")
            if "spec" in p:
                limits, default = qos_mod.parse_limits_spec(p["spec"])
            ctl.set_limits(limits=limits, default=default,
                           queue_depth=p.get("queue_depth"),
                           queue_wait=p.get("queue_wait"))
            qos_mod.enable()
        except (ValueError, TypeError) as e:
            return Response({"error": str(e)}, 400)
        status = ctl.status()
        return Response({"ok": True, "armed": ctl.armed,
                         "limits": status["limits"],
                         "default": status["default"]})

    @service.route("GET", r"/debug/pprof/device")
    def debug_pprof_device(req: Request) -> Response:
        try:
            seconds = prof_mod.clamp_seconds(req.query.get("seconds", 2))
        except ValueError:
            return Response({"error": "seconds must be a finite number"}, 400)
        try:
            data = prof_mod.device_trace(seconds)
        except prof_mod.DeviceProfilerUnavailable as e:
            return Response({"error": str(e)}, 501)
        except prof_mod.ProfilerBusy as e:
            return Response({"error": str(e)}, 429)
        except Exception as e:  # noqa: BLE001 - the capture failed; profiler is off
            return Response({"error": f"device trace failed: {e}"}, 500)
        return Response(
            data,
            content_type="application/gzip",
            headers={
                "Content-Disposition":
                    'attachment; filename="torch-trace.json.gz"'
            },
        )


class MetricsService(HTTPService):
    """Standalone /metrics listener (with the debug routes) for a server
    whose main port has a catch-all namespace (the filer): the reference's
    `-metricsPort`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.route("GET", r"/metrics")(_metrics_route(default_registry()))
        self.serve_debug_routes()


def peer_url(hostport: str) -> str:
    """Scheme-qualify another node's advertised host:port. Heartbeats and
    lookups carry bare addresses; when process-wide mTLS is configured
    (`security.tls`), every peer listener is TLS too."""
    if hostport.startswith(("http://", "https://")):
        return hostport
    scheme = "https" if _tls.client_context() is not None else "http"
    return f"{scheme}://{hostport}"


_TLS_OPENER: tuple = (None, None)  # (client context, urllib opener over it)


def _opener_for(url: str):
    """urllib's opener for a URL: an `https` one presents the process's
    client certificate (the default context when mTLS is off)."""
    if not url.startswith("https:"):
        return _OPENER
    global _TLS_OPENER
    ctx = _tls.client_context()
    cached_ctx, opener = _TLS_OPENER
    if opener is None or cached_ctx is not ctx:
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}), urllib.request.HTTPSHandler(context=ctx))
        _TLS_OPENER = (ctx, opener)
    return opener


# --- tiny client helpers ----------------------------------------------------
def http_request(
    method: str,
    url: str,
    body: bytes | None = None,
    headers: dict | None = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> tuple[int, dict, bytes]:
    headers = trace_mod.with_trace_headers(headers)
    if url.startswith("http+unix://"):
        return _unix_http_request(method, url, body, headers, timeout)
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with _opener_for(url).open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class _UnixConnection(http.client.HTTPConnection):
    """An HTTPConnection over a unix domain socket."""

    def __init__(self, sock_path: str, timeout: float) -> None:
        super().__init__("localhost", timeout=timeout)
        self.sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self.sock_path)
        self.sock = s


def _unix_http_request(
    method: str, url: str, body: bytes | None, headers: dict | None,
    timeout: float,
) -> tuple[int, dict, bytes]:
    """HTTP over a unix domain socket. URL form
    `http+unix://<percent-encoded-socket-path><request-path>` — the same
    convention requests-unix-socket/docker clients use. Server side:
    HTTPService.enable_unix_socket (`-filer.localSocket`)."""
    rest = url[len("http+unix://"):]
    sock_quoted, _, path_qs = rest.partition("/")
    conn = _UnixConnection(urllib.parse.unquote(sock_quoted), timeout)
    try:
        conn.request(method, "/" + path_qs, body=body,
                     headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


class HTTPStatusError(IOError):
    """A JSON call answered with an error status: `status` and the
    decoded error body `data`, for callers that route on its `error`."""

    def __init__(self, message: str, status: int, data) -> None:
        super().__init__(message)
        self.status = status
        self.data = data if isinstance(data, dict) else {}


def get_json(url: str, timeout: float = DEFAULT_TIMEOUT) -> dict:
    status, _, body = http_request("GET", url, timeout=timeout)
    data = json.loads(body) if body else {}
    if status >= 400:
        raise HTTPStatusError(f"GET {url} -> {status}: {data}", status, data)
    return data


def post_json(url: str, payload: dict | None = None,
              timeout: float = DEFAULT_TIMEOUT) -> dict:
    body = json.dumps(payload or {}).encode()
    status, _, out = http_request(
        "POST", url, body, {"Content-Type": "application/json"}, timeout
    )
    data = json.loads(out) if out else {}
    if status >= 400:
        raise HTTPStatusError(f"POST {url} -> {status}: {data}", status, data)
    return data


# what a write to, or a read from, a keep-alive socket the peer closed
# while it sat idle raises (RemoteDisconnected is a ConnectionResetError;
# over TLS the close may read as an EOF of the TLS stream)
_IDLE_CLOSED = (ConnectionResetError, BrokenPipeError, ConnectionAbortedError,
                ssl.SSLEOFError, ssl.SSLZeroReturnError)


class PooledHTTP:
    """Thread-local keep-alive connections per endpoint.

    urllib opens (and tears down) a TCP connection per call, so hot
    small-request paths (the filer's assigns, chunk uploads and chunk
    fetches) would measure connection setup instead of the server. The
    reference's Go clients all reuse connections; this is the equivalent
    for the data-plane hot paths. Over TCP (an `https` URL presents the
    process's mTLS client certificate) or, for an `http+unix://` URL, a
    unix domain socket."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT) -> None:
        self._tl = threading.local()
        self.timeout = timeout
        # weak: a dead handler thread's conns must not be pinned forever —
        # GC of its thread-local dict lets the sockets finalize
        self._all = weakref.WeakSet()
        self._all_mu = threading.Lock()

    def request(
        self,
        method: str,
        url: str,
        body: bytes | None = None,
        headers: dict | None = None,
        idempotent: bool = False,
    ) -> tuple[int, dict, bytes]:
        headers = trace_mod.with_trace_headers(headers)
        u = urllib.parse.urlsplit(url)
        key = f"{u.scheme}://{u.netloc}"
        pool = getattr(self._tl, "conns", None)
        if pool is None:
            pool = self._tl.conns = {}
        path = u.path + (f"?{u.query}" if u.query else "")
        # a re-send only when a re-send cannot duplicate a side effect
        # (GET/HEAD always; writes only when the caller declares them
        # idempotent: fid-addressed chunk uploads are), and only for a
        # reused keep-alive socket the peer closed while it sat idle, seen
        # before any answer. A timeout is never re-sent: the peer is slow,
        # not gone, and a second wait would hide the stall from the caller.
        may_resend = method in ("GET", "HEAD") or idempotent
        for _ in (0, 1):  # the second try is on a new socket: it never re-sends
            conn = pool.get(key)
            if conn is None:
                if u.scheme == "http+unix":
                    conn = _UnixConnection(urllib.parse.unquote(u.netloc), self.timeout)
                elif u.scheme == "https":
                    ctx = _tls.client_context() or ssl.create_default_context()
                    conn = http.client.HTTPSConnection(u.netloc, timeout=self.timeout,
                                                       context=ctx)
                else:
                    conn = http.client.HTTPConnection(u.netloc, timeout=self.timeout)
                pool[key] = conn
                with self._all_mu:
                    self._all.add(conn)
            reused, answered = conn.sock is not None, False
            try:
                if conn.sock is None:
                    conn.connect()
                    if conn.sock.family != socket.AF_UNIX:
                        # headers and body go out as separate writes; without
                        # TCP_NODELAY Nagle + delayed ACK adds ~40ms a request
                        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                answered = True
                data = resp.read()
                return resp.status, dict(resp.headers), data
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                pool.pop(key, None)
                with self._all_mu:
                    self._all.discard(conn)
                if not (may_resend and reused and not answered
                        and isinstance(e, _IDLE_CLOSED)):
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        """Close every connection this pool ever opened, across threads
        (worker threads exit without closing their thread-locals)."""
        with self._all_mu:
            conns = list(self._all)
            self._all = weakref.WeakSet()
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass
        pool = getattr(self._tl, "conns", None)
        if pool:
            pool.clear()
