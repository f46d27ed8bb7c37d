"""Sentry error reporting over the plain store-API protocol.

The reference links getsentry/sentry-go and initializes it from a DSN in
each long-running command (`go.mod: github.com/getsentry/sentry-go`).
Sentry's ingestion is just HTTP: POST a JSON event to
`{scheme}://{host}/api/{project}/store/` with an `X-Sentry-Auth` header
carrying the DSN's public key. That's implemented here directly —
`init_sentry(dsn)` hooks `sys.excepthook` and exposes
`capture_exception()` for servers' catch-all error paths.

Events are sent from a daemon thread so a slow/unreachable ingest host
never stalls a request path; failures are dropped silently (error
reporting must never become an error source). The port's copy of
`seaweedfs_tpu/util/sentry.py`: it sends through the port's
`server/httpd.http_request`, so an `https` ingest host gets the process's
mTLS context as every other hop does. The port's HTTP 500 path
(`HTTPService`'s route dispatch) reports through `capture_exception`.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
import traceback
import urllib.parse
import uuid

_state: dict = {"client": None}


class _SentryClient:
    def __init__(self, dsn: str, environment: str = "",
                 release: str = "") -> None:
        # DSN: {scheme}://{public_key}@{host}[:port]/{project_id}
        parsed = urllib.parse.urlparse(dsn)
        if not parsed.username or not parsed.path.strip("/"):
            raise ValueError(f"malformed sentry DSN")
        self.public_key = parsed.username
        self.project = parsed.path.strip("/")
        if not parsed.hostname:
            raise ValueError("sentry DSN has no host")
        netloc = parsed.hostname + (
            f":{parsed.port}" if parsed.port else ""
        )
        self.store_url = f"{parsed.scheme}://{netloc}/api/{self.project}/store/"
        self.environment = environment
        self.release = release
        self._q: queue.Queue = queue.Queue(maxsize=100)
        self._pending = 0           # queued + in-flight sends
        self._pending_mu = threading.Condition()
        threading.Thread(target=self._sender, daemon=True).start()

    def _auth_header(self) -> str:
        return (
            "Sentry sentry_version=7, sentry_client=seaweedfs-tpu/1.0, "
            f"sentry_key={self.public_key}"
        )

    def capture(self, exc: BaseException, extra: dict | None = None) -> None:
        frames = [
            {
                "filename": f.filename,
                "function": f.name,
                "lineno": f.lineno,
                "context_line": f.line,
            }
            for f in traceback.extract_tb(exc.__traceback__)
        ]
        event = {
            "event_id": uuid.uuid4().hex,
            "timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime()
            ),
            "platform": "python",
            "level": "error",
            "environment": self.environment or "production",
            "release": self.release,
            "exception": {
                "values": [
                    {
                        "type": type(exc).__name__,
                        "value": str(exc),
                        "stacktrace": {"frames": frames},
                    }
                ]
            },
            "extra": extra or {},
        }
        try:
            with self._pending_mu:
                self._q.put_nowait(event)
                self._pending += 1
        except queue.Full:
            pass  # shed load: reporting must not block or grow unbounded

    def _sender(self) -> None:  # pragma: no cover - daemon loop timing
        from seaweedfs_tpu_torch.server.httpd import http_request

        while True:
            event = self._q.get()
            try:
                http_request(
                    "POST",
                    self.store_url,
                    json.dumps(event).encode(),
                    {
                        "Content-Type": "application/json",
                        "X-Sentry-Auth": self._auth_header(),
                    },
                    timeout=10,
                )
            except Exception:
                pass
            finally:
                with self._pending_mu:
                    self._pending -= 1
                    self._pending_mu.notify_all()

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until queued AND in-flight events are sent (the excepthook
        depends on this covering the send itself, not just the queue)."""
        deadline = time.time() + timeout
        with self._pending_mu:
            while self._pending > 0:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._pending_mu.wait(remaining)


def init_sentry(dsn: str, environment: str = "", release: str = "") -> bool:
    """Install the reporter (reference: sentry.Init in each command's
    startup). Returns False when the DSN is empty/invalid."""
    if not dsn:
        return False
    try:
        client = _SentryClient(dsn, environment, release)
    except (ValueError, TypeError):
        return False
    _state["client"] = client
    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            client.capture(exc)
            client.flush(2.0)
        except Exception:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
    return True


def capture_exception(exc: BaseException, **extra) -> None:
    """Report an exception if a client is configured; no-op otherwise —
    the hook servers call from their catch-all error paths."""
    client = _state.get("client")
    if client is not None:
        client.capture(exc, extra or None)
