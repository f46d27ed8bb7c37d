"""Chunked dirty-page write pipeline for the mount.

Behavioral port of `weed/mount/page_writer/upload_pipeline.go:42-220` +
`dirty_pages_chunked.go`: writes land in fixed-size in-memory page chunks;
a full chunk is sealed and handed to a bounded pool of async uploaders;
flush seals the remainder, waits for uploads, and returns the FileChunk
list (logical intervals) for the entry commit. Overlapping writes within
one chunk just overwrite the buffer; cross-chunk ordering is preserved by
ModifiedTsNs so the filer's visible-interval resolution (LSM-style
latest-wins) reads back exactly what was written.

The port's copy of `seaweedfs_tpu/mount/page_writer.py`.
"""

from __future__ import annotations

import threading
import time

from ..filer.entry import FileChunk
from ..util.concurrency import LimitedConcurrentExecutor


class PageChunk:
    """One chunk-size buffer holding dirty [start,stop) spans."""

    def __init__(self, logical_index: int, chunk_size: int) -> None:
        self.index = logical_index
        self.chunk_size = chunk_size
        self.buf = bytearray(chunk_size)
        self.spans: list[tuple[int, int]] = []  # in-chunk [start, stop)

    def write(self, in_chunk_offset: int, data: bytes) -> None:
        stop = in_chunk_offset + len(data)
        self.buf[in_chunk_offset:stop] = data
        merged = []
        new = (in_chunk_offset, stop)
        for s, e in sorted(self.spans + [new]):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self.spans = [(s, e) for s, e in merged]

    def intervals(self) -> list[tuple[int, bytes]]:
        """(in-chunk offset, bytes) for each dirty span."""
        return [(s, bytes(self.buf[s:e])) for s, e in self.spans]


class UploadPipeline:
    def __init__(self, upload_fn, chunk_size: int = 4 * 1024 * 1024,
                 concurrency: int = 4) -> None:
        """upload_fn(data: bytes) -> file_id (assign + POST to a volume)."""
        self.upload_fn = upload_fn
        self.chunk_size = chunk_size
        self._writable: dict[int, PageChunk] = {}
        self._sealed: list[PageChunk] = []  # uploading, still readable
        self._lock = threading.Lock()
        self._executor = LimitedConcurrentExecutor(concurrency)
        self._pending: list = []  # futures -> list[FileChunk]
        self._errors: list[Exception] = []

    def write(self, offset: int, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            abs_off = offset + pos
            idx = abs_off // self.chunk_size
            in_off = abs_off % self.chunk_size
            n = min(self.chunk_size - in_off, len(data) - pos)
            with self._lock:
                pc = self._writable.get(idx)
                if pc is None:
                    pc = PageChunk(idx, self.chunk_size)
                    self._writable[idx] = pc
                pc.write(in_off, data[pos:pos + n])
                # seal a fully-dirty chunk immediately (upload_pipeline.go
                # moveToSealed on full chunks)
                if pc.spans == [(0, self.chunk_size)]:
                    del self._writable[idx]
                    self._seal(pc)
            pos += n

    def read_back(self, offset: int, size: int) -> list[tuple[int, bytes]]:
        """Dirty spans overlapping [offset, offset+size) still buffered here
        — both writable chunks AND sealed chunks whose uploads haven't been
        committed to the entry yet (readback-before-upload)."""
        out = []
        with self._lock:
            chunks = self._sealed + list(self._writable.values())
        for pc in chunks:
            base = pc.index * self.chunk_size
            for s, data in pc.intervals():
                lo = base + s
                hi = lo + len(data)
                if hi <= offset or lo >= offset + size:
                    continue
                cut_lo = max(lo, offset)
                cut_hi = min(hi, offset + size)
                out.append((cut_lo, data[cut_lo - lo:cut_hi - lo]))
        return out

    def _seal(self, pc: PageChunk) -> None:
        ts_ns = time.time_ns()
        self._sealed.append(pc)  # caller holds _lock (or is single-owner)

        def do_upload():
            out = []
            base = pc.index * self.chunk_size
            for in_off, data in pc.intervals():
                fid = self.upload_fn(data)
                out.append(FileChunk(
                    file_id=fid, offset=base + in_off, size=len(data),
                    modified_ts_ns=ts_ns,
                ))
            return out

        self._pending.append(self._executor.execute(do_upload))

    def flush(self) -> list[FileChunk]:
        """Seal everything, wait for uploads, return accumulated chunks."""
        with self._lock:
            leftovers = list(self._writable.values())
            self._writable.clear()
            for pc in leftovers:
                self._seal(pc)
        chunks: list[FileChunk] = []
        pending, self._pending = self._pending, []
        errors = []
        for fut in pending:
            try:
                chunks.extend(fut.result(timeout=120))
            except Exception as e:  # surface on fsync like the reference
                errors.append(e)
        with self._lock:
            # sealed buffers are committed (or failed) — reads now come
            # from the entry's chunk list
            self._sealed.clear()
        if errors:
            raise errors[0]
        chunks.sort(key=lambda c: c.offset)
        return chunks

    def has_dirty(self) -> bool:
        with self._lock:
            return bool(self._writable) or bool(self._pending)
