"""Request-concurrency circuit breaker: global and per-bucket limits on
simultaneous requests (and bytes) per action type; over-limit requests get
503 SlowDown. Reference: `weed/s3api/s3api_circuit_breaker.go`.

The port's copy of `seaweedfs_tpu/s3api/circuit_breaker.py`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from .auth import err


class CircuitBreaker:
    def __init__(
        self,
        global_limits: dict[str, int] | None = None,
        bucket_limits: dict[str, dict[str, int]] | None = None,
    ) -> None:
        # limits: {"Read": max_concurrent, "Write": ...}; 0/missing = unlimited
        self.global_limits = global_limits or {}
        self.bucket_limits = bucket_limits or {}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def _inc(self, key: str, limit: int) -> bool:
        if limit <= 0:
            return True
        with self._lock:
            cur = self._counts.get(key, 0)
            if cur >= limit:
                return False
            self._counts[key] = cur + 1
            return True

    def _dec(self, key: str) -> None:
        with self._lock:
            cur = self._counts.get(key, 0)
            if cur <= 1:
                self._counts.pop(key, None)
            else:
                self._counts[key] = cur - 1

    @contextmanager
    def limit(self, action: str, bucket: str):
        acquired: list[str] = []
        try:
            gkey = f"global:{action}"
            if not self._inc(gkey, self.global_limits.get(action, 0)):
                raise err("SlowDown", f"too many concurrent {action} requests")
            acquired.append(gkey)
            if bucket:
                bkey = f"bucket:{bucket}:{action}"
                blimit = self.bucket_limits.get(bucket, {}).get(action, 0)
                if not self._inc(bkey, blimit):
                    raise err(
                        "SlowDown", f"too many concurrent {action} on {bucket}"
                    )
                acquired.append(bkey)
            yield
        finally:
            for key in acquired:
                self._dec(key)
