"""Upload-path batch hash service: MD5 + CRC32C through the batch kernels.
The port's counterpart of `seaweedfs_tpu/ops/hash_service.py`.

The reference hashes every uploaded blob — an MD5 tee in the filer
(`weed/server/filer_server_handlers_write_upload.go:48-49`) and a CRC32C per
needle on the volume server (`weed/storage/needle/needle.go:52`,
`crc.go:12`). Here one-shot blob hashing funnels through this service:

* concurrent requests' blobs are bucketed by length, and each bucket is
  hashed as ONE batch: on cuda it is copied to the card once, through a
  pinned staging buffer, and both kernels (`md5_kernel.md5_batch_kernel`,
  `crc32c_kernel.crc32c_batch_kernel`) run on that one copy; on cpu (which
  a caller must ask for) the same wrappers run their plain versions;
* a linger window (default 0.5 ms) gives in-flight requests a chance to
  coalesce; a lone blob on an idle service, and a bucket under `min_batch`,
  hash on the host (hashlib + the host CRC), as the JAX package routes
  them. That is the routing rule, not a fallback: a batch that fails fails
  every future of its bucket (`HashResult.wait()` raises) and is counted in
  `failed_blobs`; it is never hashed again elsewhere.

The device is fixed at construction: `HashService()` runs on cuda or
raises. There is no backend pick, rate calibration or override. Counters:
`batch_blobs` (hashed by the batch path), `host_blobs`, `failed_blobs`.

The dedup write path's span methods, `span_keys`, `md5_spans` and
`hash_spans`, are synchronous host code on either device, as in the JAX
package (span batches are host-resident and latency-bound, the worst case
for a device round trip): one call into the port's host libraries
(`seaweedfs_tpu_torch.native`) per batch of spans of one buffer. Keys are
SW128 with the "x" prefix, equal to the JAX package's for the same seed.
The JAX package's "f" (MD5) keys exist only for when its native library is
absent; the port never lacks its host library (a failed build raises), so
it has no such fallback.
"""

from __future__ import annotations

import binascii
import hashlib
import threading
import time

import numpy as np
import torch

from .. import native
from ..storage import crc as crc_mod
from .crc32c_kernel import crc32c_batch_kernel
from .md5_kernel import md5_batch_kernel
from .rs_kernel import _as_tensor, resolve_device

_MIN_BATCH = 4  # below this, batching buys nothing — hash synchronously
_MAX_BATCH = 8192
_LINGER_S = 0.0005


class HashResult:
    """Future for one submitted blob. `done_at` is the perf_counter time at
    which its result (or error) was set. The futures of one service share
    one condition, notified once per flushed batch, not an event each."""

    __slots__ = ("_done", "_cv", "md5", "crc", "error", "done_at")

    def __init__(self, cv: threading.Condition) -> None:
        self._done = False
        self._cv = cv
        self.md5: bytes = b""
        self.crc: int = 0
        self.error: BaseException | None = None
        self.done_at = 0.0

    def _set(self, md5: bytes, crc: int) -> None:
        """Set the result; the setter notifies the condition afterwards."""
        self.md5 = md5
        self.crc = crc
        self.done_at = time.perf_counter()
        self._done = True

    def _fail(self, error: BaseException) -> None:
        self.error = error
        self.done_at = time.perf_counter()
        self._done = True

    def wait(self, timeout: float = 30.0) -> "HashResult":
        if not self._done:
            deadline = time.monotonic() + timeout
            with self._cv:
                while not self._done:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError("hash batch never flushed")
                    self._cv.wait(left)
        if self.error is not None:
            raise RuntimeError(f"hash batch failed: {self.error!r}") from self.error
        return self

    def md5_hex(self) -> str:
        self.wait()
        return binascii.hexlify(self.md5).decode()


def _hash_one(data) -> tuple[bytes, int]:
    return hashlib.md5(data).digest(), crc_mod.crc32c(data)


class HashService:
    def __init__(
        self,
        device=None,
        linger_s: float = _LINGER_S,
        min_batch: int = _MIN_BATCH,
        max_batch: int = _MAX_BATCH,
    ) -> None:
        self.device = resolve_device(device)
        self.linger_s = linger_s
        self.min_batch = min_batch
        self.max_batch = max_batch
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # length -> list of (data, HashResult)
        self._buckets: dict[int, list[tuple[bytes, HashResult]]] = {}
        self._queued = 0  # blobs in _buckets
        self._done_cv = threading.Condition()  # every future of this service waits here
        self._active_sync = 0  # submits hashing on the caller's thread
        self._stop = False
        self._thread: threading.Thread | None = None
        self._stream = None
        self._staging: torch.Tensor | None = None  # pinned; used by the flusher only
        self._count_mu = threading.Lock()
        self.batch_blobs = 0
        self.host_blobs = 0
        self.failed_blobs = 0

    def _count(self, batch: int = 0, host: int = 0, failed: int = 0) -> None:
        with self._count_mu:
            self.batch_blobs += batch
            self.host_blobs += host
            self.failed_blobs += failed

    # --- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._flusher, name="hash-batcher", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # --- API -----------------------------------------------------------------
    def submit(self, data: bytes) -> HashResult:
        """Enqueue one blob; returns a future. A lone blob on an idle server
        (nothing queued, no other submit in flight) hashes synchronously on
        the caller's thread — no linger/wakeup tax; the queue engages only
        under genuinely concurrent load."""
        r = HashResult(self._done_cv)
        if self._thread is None or len(data) == 0:
            r._set(*_hash_one(data))
            self._count(host=1)
            return r
        with self._cv:
            idle = not self._buckets and self._active_sync == 0
            if idle:
                self._active_sync += 1
            else:
                blob = data if isinstance(data, bytes) else bytes(data)
                self._buckets.setdefault(len(data), []).append((blob, r))
                self._queued += 1
                if self._queued == 1 or self._queued >= self.max_batch:
                    self._cv.notify_all()  # wake the flusher, or end its linger
        if idle:
            try:
                r._set(*_hash_one(data))
                self._count(host=1)
            finally:
                with self._cv:
                    self._active_sync -= 1
        return r

    def submit_many(self, blobs) -> list[HashResult]:
        """Enqueue a burst from one caller (e.g. every piece of a chunked
        upload) as a group: unlike N submit() calls, the burst always goes
        through the queue so same-length pieces coalesce into batch-kernel
        calls — the idle fast path would otherwise hash each piece on the
        host back-to-back."""
        results = [HashResult(self._done_cv) for _ in blobs]
        if self._thread is None:
            for data, r in zip(blobs, results):
                r._set(*_hash_one(data))
            self._count(host=len(results))
            return results
        with self._cv:
            for data, r in zip(blobs, results):
                if len(data) == 0:
                    r._set(*_hash_one(data))
                    self._count(host=1)
                    continue
                blob = data if isinstance(data, bytes) else bytes(data)
                self._buckets.setdefault(len(blob), []).append((blob, r))
                self._queued += 1
            self._cv.notify_all()
        return results

    def hash_now(self, data: bytes) -> tuple[str, int]:
        """Synchronous convenience: (md5 hex, crc32c), on the host."""
        md5, crc = _hash_one(data)
        self._count(host=1)
        return binascii.hexlify(md5).decode(), crc

    def span_keys(self, buf, cuts, seed: bytes = b"") -> list[str]:
        """Dedup identity keys per CDC span (cuts are exclusive ends):
        "x<hex32>", SW128 keyed by the caller's per-store 16-byte seed."""
        if len(cuts) == 0:
            return []
        return ["x" + d.tobytes().hex() for d in native.fast128_spans(buf, cuts, seed)]

    def md5_spans(self, buf, ranges: list[tuple[int, int]]) -> list[str]:
        """MD5 hex per (offset, length) span of one buffer, in one batch.
        The dedup path hashes its index MISSES only (their upload ETags)."""
        if not ranges:
            return []
        digests = native.md5_spans(buf, [r[0] for r in ranges], [r[1] for r in ranges])
        return [d.tobytes().hex() for d in digests]

    def hash_spans(self, buf, cuts) -> list[tuple[str, int]]:
        """[(md5 hex, crc32c)] per CDC span of one buffer, cuts being
        exclusive ends, in one batch with no per-span copies."""
        if len(cuts) == 0:
            return []
        digests, crcs = native.md5_crc_batch_spans(buf, cuts)
        return [(d.tobytes().hex(), int(c)) for d, c in zip(digests, crcs.tolist())]

    # --- internals -----------------------------------------------------------
    def _flusher(self) -> None:
        while True:
            with self._cv:
                if not self._buckets and not self._stop:
                    self._cv.wait(0.05)
                if self._stop and not self._buckets:
                    return
                if not self._buckets:
                    continue
                deadline = time.monotonic() + self.linger_s
                while (
                    not self._stop
                    and time.monotonic() < deadline
                    and self._queued < self.max_batch
                ):
                    self._cv.wait(max(deadline - time.monotonic(), 0.0))
                work = self._buckets
                self._buckets = {}
                self._queued = 0
            for length, items in work.items():
                for s in range(0, len(items), self.max_batch):
                    part = items[s : s + self.max_batch]
                    try:
                        self._flush_bucket(length, part)
                    except Exception as e:  # every future of the batch fails
                        self._count(failed=len(part))
                        for _, r in part:
                            r._fail(e)
                    with self._done_cv:
                        self._done_cv.notify_all()

    def _flush_bucket(self, length: int, items) -> None:
        if len(items) < self.min_batch:
            for data, r in items:
                r._set(*_hash_one(data))
            self._count(host=len(items))
            return
        digests, crcs = self._batch_hash(items, length)
        md5s, crc_list = digests.tobytes(), crcs.tolist()
        for i, (_, r) in enumerate(items):
            r._set(md5s[16 * i : 16 * i + 16], crc_list[i])
        self._count(batch=len(items))

    def _batch_hash(self, items, length: int) -> tuple[np.ndarray, np.ndarray]:
        """((n, 16) md5 digests, (n,) uint32 crcs) of a bucket's blobs."""
        n = len(items)
        if self.device.type == "cpu":
            blobs = np.frombuffer(b"".join(d for d, _ in items), dtype=np.uint8)
            x = _as_tensor(blobs).view(n, length)
            return md5_batch_kernel(x).numpy(), crc32c_batch_kernel(x).numpy()
        nbytes = n * length
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        staging = self._staging[:nbytes]
        mv = memoryview(staging.numpy())
        for i, (data, _) in enumerate(items):
            mv[i * length : (i + 1) * length] = data
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stream):
            x = staging.to(self.device, non_blocking=True).view(n, length)  # one copy
            md5 = md5_batch_kernel(x)
            crc = crc32c_batch_kernel(x)
            md5_host = torch.empty((n, 16), dtype=torch.uint8, pin_memory=True)
            crc_host = torch.empty(n, dtype=torch.int32, pin_memory=True)
            md5_host.copy_(md5, non_blocking=True)
            crc_host.copy_(crc.view(torch.int32), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()  # also frees the staging buffer for the next bucket
        return md5_host.numpy(), crc_host.numpy().view(np.uint32)


_SERVICE: HashService | None = None
_SERVICE_MU = threading.Lock()


def get_hash_service() -> HashService:
    """Process-wide singleton on cuda (raises without CUDA), started."""
    global _SERVICE
    with _SERVICE_MU:
        if _SERVICE is None:
            _SERVICE = HashService()
            _SERVICE.start()
        return _SERVICE
