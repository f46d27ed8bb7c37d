"""The port's Sentry reporter (`seaweedfs_tpu_torch/util/sentry.py`): the
three `TestSentry` cases of `tests/test_backends_sentry.py` over the port,
against an in-process fake ingest, then parity with the JAX reporter: the
same exception gives the same event body in both packages, apart from
`event_id` and `timestamp`, and the port's HTTP 500 path reports with the
same `extra` as the JAX one."""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import seaweedfs_tpu.util.sentry as ref_sentry
from seaweedfs_tpu_torch.util import sentry as sentry_mod


@pytest.fixture()
def fake_sentry(monkeypatch):
    """A store-API ingest on an ephemeral port; records (path, headers,
    body) of every event. Both packages' reporters and the excepthook they
    chain are restored after the test."""
    events: list[tuple[str, dict, dict]] = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n))
            events.append((self.path, dict(self.headers), body))
            out = b'{"id": "1"}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setitem(sentry_mod._state, "client", None)
    monkeypatch.setitem(ref_sentry._state, "client", None)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield events, srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def wait_events(events, n=1):
    for _ in range(100):
        if len(events) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"{len(events)} of {n} events arrived")


def raise_and_capture(mod, **extra):
    """Raise the same exception at the same line for either package."""
    try:
        raise RuntimeError("volume 3 exploded")
    except RuntimeError as e:
        mod.capture_exception(e, **extra)


class TestSentry:
    def test_capture_exception_ships_event(self, fake_sentry):
        events, port = fake_sentry
        dsn = f"http://pubkey123@127.0.0.1:{port}/42"
        assert sentry_mod.init_sentry(dsn, environment="test") is True
        raise_and_capture(sentry_mod, volume=3)
        sentry_mod._state["client"].flush()
        wait_events(events)
        path, headers, body = events[0]
        assert path == "/api/42/store/"
        assert "sentry_key=pubkey123" in headers["X-Sentry-Auth"]
        exc = body["exception"]["values"][0]
        assert exc["type"] == "RuntimeError"
        assert exc["value"] == "volume 3 exploded"
        assert exc["stacktrace"]["frames"]
        assert body["extra"] == {"volume": 3}
        assert body["environment"] == "test"

    def test_http_500_path_reports(self, fake_sentry):
        """The port's uniform 500 handler feeds the reporter."""
        from seaweedfs_tpu_torch.server.httpd import (
            HTTPService,
            Request,
            Response,
            http_request,
        )

        events, port = fake_sentry
        assert sentry_mod.init_sentry(f"http://k@127.0.0.1:{port}/7") is True
        svc = HTTPService(port=0)

        @svc.route("GET", r"/boom")
        def boom(req: Request) -> Response:
            raise ValueError("kaboom")

        svc.start()
        try:
            st, _, body = http_request("GET", svc.url + "/boom")
            assert st == 500 and b"kaboom" in body
            sentry_mod._state["client"].flush()
            wait_events(events)
            assert events[0][2]["extra"]["path"] == "/boom"
        finally:
            svc.stop()

    def test_bad_dsn_rejected(self):
        assert sentry_mod.init_sentry("") is False
        assert sentry_mod.init_sentry("not-a-dsn") is False


def _strip(body: dict) -> dict:
    out = dict(body)
    out.pop("event_id")
    out.pop("timestamp")
    for fr in out["exception"]["values"][0]["stacktrace"]["frames"]:
        fr["filename"] = fr["filename"].rsplit("/", 1)[-1]
    return out


def test_event_body_equals_reference(fake_sentry):
    """One exception through each package's reporter: the bodies are equal
    apart from `event_id` and `timestamp` (and headers carry the same
    auth line)."""
    events, port = fake_sentry
    dsn = f"http://pubkey9@127.0.0.1:{port}/5"
    assert ref_sentry.init_sentry(dsn, environment="stage", release="r1")
    assert sentry_mod.init_sentry(dsn, environment="stage", release="r1")
    raise_and_capture(ref_sentry, volume=7, op="read")
    ref_sentry._state["client"].flush()
    wait_events(events, 1)
    raise_and_capture(sentry_mod, volume=7, op="read")
    sentry_mod._state["client"].flush()
    wait_events(events, 2)
    (p_ref, h_ref, b_ref), (p_port, h_port, b_port) = events
    assert p_ref == p_port == "/api/5/store/"
    assert h_ref["X-Sentry-Auth"] == h_port["X-Sentry-Auth"]
    assert set(b_ref) == set(b_port)
    assert len(b_port["event_id"]) == 32
    assert _strip(b_ref) == _strip(b_port)


def test_http_500_extra_equals_reference(fake_sentry):
    """A route that raises behind each package's HTTPService reports the
    same exception type, value and `extra` (path and method)."""
    from seaweedfs_tpu.server import httpd as ref_httpd
    from seaweedfs_tpu_torch.server import httpd

    events, port = fake_sentry
    dsn = f"http://k@127.0.0.1:{port}/8"
    assert ref_sentry.init_sentry(dsn)
    assert sentry_mod.init_sentry(dsn)
    bodies = []
    for mod, sm in ((ref_httpd, ref_sentry), (httpd, sentry_mod)):
        svc = mod.HTTPService(port=0)

        @svc.route("POST", r"/v/(\d+)")
        def boom(req):
            raise KeyError("needle 5")

        svc.start()
        try:
            st, _, _ = mod.http_request("POST", svc.url + "/v/3", b"x")
            assert st == 500
            sm._state["client"].flush()
            wait_events(events, len(bodies) + 1)
            bodies.append(events[len(bodies)][2])
        finally:
            svc.stop()
    ref_exc, port_exc = (b["exception"]["values"][0] for b in bodies)
    assert (ref_exc["type"], ref_exc["value"]) == \
        (port_exc["type"], port_exc["value"]) == ("KeyError", "'needle 5'")
    assert bodies[0]["extra"] == bodies[1]["extra"] == \
        {"path": "/v/3", "method": "POST"}
