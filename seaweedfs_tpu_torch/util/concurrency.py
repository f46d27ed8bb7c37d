"""Concurrency/IO helpers: bounded executors, buffer pools, retry.

Mirrors `weed/util`'s LimitedConcurrentExecutor, bytes pools, and
`retry.go`'s Retry/RetryForever backoff loop.

The port's copy of `seaweedfs_tpu/util/concurrency.py`.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, TypeVar

T = TypeVar("T")


class LimitedConcurrentExecutor:
    """At most `limit` tasks in flight; submit blocks when full
    (`weed/util/limited_executor.go`)."""

    def __init__(self, limit: int) -> None:
        self._pool = ThreadPoolExecutor(max_workers=limit)
        self._sem = threading.Semaphore(limit)

    def execute(self, fn: Callable[..., T], *args, **kwargs) -> Future:
        self._sem.acquire()

        def run():
            try:
                return fn(*args, **kwargs)
            finally:
                self._sem.release()

        return self._pool.submit(run)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)


class BytesBufferPool:
    """Reusable fixed-size buffers for the upload fan-out (the reference
    bounds in-flight chunk buffers at 4, `filer_server_handlers_write_upload.go:52`)."""

    def __init__(self, size: int, count: int) -> None:
        self.size = size
        self._free: list[bytearray] = [bytearray(size) for _ in range(count)]
        self._cond = threading.Condition()

    def acquire(self) -> bytearray:
        with self._cond:
            while not self._free:
                self._cond.wait()
            return self._free.pop()

    def release(self, buf: bytearray) -> None:
        with self._cond:
            self._free.append(buf)
            self._cond.notify()


def retry(name: str, fn: Callable[[], T], *, attempts: int = 3,
          base_delay: float = 0.05, max_delay: float = 2.0,
          retriable: Callable[[Exception], bool] | None = None) -> T:
    """`util.Retry`: exponential backoff, re-raise the last error."""
    delay = base_delay
    last: Exception | None = None
    for _ in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - mirror Retry's catch-all
            if retriable is not None and not retriable(e):
                raise
            last = e
            time.sleep(delay)
            delay = min(delay * 2, max_delay)
    assert last is not None
    raise last
