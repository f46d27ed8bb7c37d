"""In-memory append log with time-based flush — the filer's metadata event
pipe (reference: `weed/util/log_buffer/log_buffer.go:30`).

Entries are (ts_ns, payload bytes). The buffer keeps a bounded in-memory
window; when the entries not yet flushed exceed `flush_bytes`, or every
`flush_interval`, a flush function persists the batch (the filer writes dated segment files under
`/topics/.system/log/...`, `weed/filer/filer_notify.go:62`). Readers pull
from the in-memory window when their start timestamp is inside it and fall
back to the flushed segments otherwise (ReadFromBuffer semantics). The
port's copy of `seaweedfs_tpu/util/log_buffer.py`, whose byte trigger
counts the whole window, flushed entries included: once the window holds
`flush_bytes`, every append there wakes a flush of a segment or two
entries long.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class LogBuffer:
    def __init__(
        self,
        flush_fn: Callable[[int, int, list[tuple[int, bytes]]], None] | None = None,
        flush_bytes: int = 4 * 1024 * 1024,
        flush_interval: float = 2.0,
        keep: int = 10_000,
    ) -> None:
        self._entries: list[tuple[int, bytes]] = []  # sorted by ts_ns
        self._unflushed_bytes = 0  # appended since the last flush's batch
        self._lock = threading.Condition()
        # serializes flushers; flush_fn runs OUTSIDE _lock — it may re-enter
        # locks held by appenders (the filer writes segments through its own
        # store), so nesting it under _lock would be an AB-BA deadlock
        self._flush_mutex = threading.Lock()
        # appenders must not flush synchronously either: an appender may hold
        # the filer's entry lock, and flush_fn (segment write → _insert_quiet)
        # takes that same lock — appender(filer lock → _flush_mutex) vs
        # flusher(_flush_mutex → filer lock) deadlocks. Byte-threshold flushes
        # instead wake the flusher thread early via this event.
        self._flush_wake = threading.Event()
        self._flush_fn = flush_fn
        self._flush_bytes = flush_bytes
        self._flush_interval = flush_interval
        self._keep = keep
        self._flushed_until_ns = 0  # everything <= this ts has been flushed
        self._dropped_until_ns = 0  # everything <= this ts left the window
        self._last_ts = 0
        self._closed = False
        self._flusher: threading.Thread | None = None
        if flush_fn is not None and flush_interval > 0:
            self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
            self._flusher.start()

    # --- write ------------------------------------------------------------------
    def append(self, payload: bytes, ts_ns: int | None = None) -> int:
        return self.append_with(lambda ts: payload, ts_ns)

    def append_with(
        self, payload_fn: Callable[[int], bytes], ts_ns: int | None = None
    ) -> int:
        """Append with the payload built from the FINAL timestamp — callers
        that embed ts in the payload stay consistent with the monotonic bump."""
        with self._lock:
            ts = ts_ns or time.time_ns()
            if ts <= self._last_ts:
                ts = self._last_ts + 1  # strictly monotonic, ties broken by +1ns
            self._last_ts = ts
            payload = payload_fn(ts)
            self._entries.append((ts, payload))
            self._unflushed_bytes += len(payload)
            self._lock.notify_all()
            # the window keeps up to `keep` flushed entries for readers, so
            # it is the bytes not yet flushed that call a flush early
            need_flush = (
                self._flush_fn is not None
                and self._unflushed_bytes >= self._flush_bytes
            )
        if need_flush:
            if self._flusher is not None:
                self._flush_wake.set()
            else:
                self.flush()
        return ts

    def flush(self) -> None:
        if self._flush_fn is None:
            return
        with self._flush_mutex:
            with self._lock:
                batch = [
                    (ts, p) for ts, p in self._entries
                    if ts > self._flushed_until_ns
                ]
            if not batch:
                return
            self._flush_fn(batch[0][0], batch[-1][0], batch)
            with self._lock:
                self._flushed_until_ns = batch[-1][0]
                self._unflushed_bytes -= sum(len(p) for _, p in batch)
                # trim the in-memory window but keep a tail for fast readers
                if len(self._entries) > self._keep:
                    dropped = self._entries[: -self._keep]
                    self._entries = self._entries[-self._keep :]
                    self._dropped_until_ns = dropped[-1][0]

    def _flush_loop(self) -> None:
        while not self._closed:
            self._flush_wake.wait(self._flush_interval)
            self._flush_wake.clear()
            try:
                self.flush()
            except Exception:
                pass

    def close(self) -> None:
        self._closed = True
        if self._flush_fn is not None:
            self.flush()

    # --- read -------------------------------------------------------------------
    @property
    def earliest_ts_ns(self) -> int:
        with self._lock:
            return self._entries[0][0] if self._entries else 0

    @property
    def latest_ts_ns(self) -> int:
        with self._lock:
            return self._last_ts

    def read_since(
        self, ts_ns: int, limit: int = 1 << 31
    ) -> tuple[list[tuple[int, bytes]], bool]:
        """Entries with ts > ts_ns. Returns (batch, resumable): resumable is
        False when ts_ns predates the in-memory window AND data was flushed —
        the caller must read the flushed segments first."""
        with self._lock:
            return self._read_since_locked(ts_ns, limit)

    def wait_since(
        self, ts_ns: int, timeout: float, limit: int = 1 << 31
    ) -> tuple[list[tuple[int, bytes]], bool]:
        """Long-poll read: block until an entry newer than ts_ns arrives or
        timeout elapses."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                batch, ok = self._read_since_locked(ts_ns, limit)
                if batch or not ok:
                    return batch, ok
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], True
                self._lock.wait(remaining)

    def _read_since_locked(self, ts_ns, limit):
        # resumable iff no entry in (ts_ns, now] has been trimmed from memory
        if ts_ns < self._dropped_until_ns:
            return [], False
        return [(t, p) for t, p in self._entries if t > ts_ns][:limit], True
