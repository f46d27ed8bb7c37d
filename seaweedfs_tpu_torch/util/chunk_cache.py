"""Tiered chunk cache: bounded in-memory LRU + size-tiered on-disk layers.

Behavioral port of `weed/util/chunk_cache/chunk_cache.go:13,30`: reads
through the filer/mount keep recently used chunks in RAM and spill larger /
older ones to disk, tiered by chunk size so huge chunks do not evict many
small ones. The reference backs disk tiers with needle volumes; here each
tier is a directory of files with an LRU index — same bounds, simpler
machinery (no volume GC needed since chunks are immutable and keyed by fid).

The port's copy of `seaweedfs_tpu/util/chunk_cache.py`.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict


class MemChunkCache:
    """Bytes-bounded LRU (`chunk_cache_in_memory.go`)."""

    def __init__(self, limit_bytes: int = 64 * 1024 * 1024) -> None:
        self.limit = limit_bytes
        self._used = 0
        self._map: OrderedDict[str, bytes] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            data = self._map.get(key)
            if data is not None:
                self._map.move_to_end(key)
            return data

    def set(self, key: str, data: bytes) -> None:
        if len(data) > self.limit:
            return
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._used -= len(old)
            self._map[key] = data
            self._used += len(data)
            while self._used > self.limit:
                _, evicted = self._map.popitem(last=False)
                self._used -= len(evicted)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._used = 0


class DiskCacheLayer:
    """One on-disk tier: files under dir, LRU-evicted to stay under limit."""

    def __init__(self, dir_: str, limit_bytes: int) -> None:
        self.dir = dir_
        self.limit = limit_bytes
        os.makedirs(dir_, exist_ok=True)
        self._lock = threading.Lock()
        self._index: OrderedDict[str, int] = OrderedDict()  # key -> size
        self._used = 0
        for name in os.listdir(dir_):
            p = os.path.join(dir_, name)
            if name.endswith(".tmp"):  # crashed mid-set(); unservable
                try:
                    os.remove(p)
                except OSError:
                    pass
                continue
            if os.path.isfile(p):
                sz = os.path.getsize(p)
                self._index[name] = sz
                self._used += sz

    @staticmethod
    def _fname(key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest()

    def get(self, key: str) -> bytes | None:
        name = self._fname(key)
        with self._lock:
            if name not in self._index:
                return None
            self._index.move_to_end(name)
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def set(self, key: str, data: bytes) -> None:
        if len(data) > self.limit:
            return
        name = self._fname(key)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self.dir, name))
        with self._lock:
            old = self._index.pop(name, None)
            if old is not None:
                self._used -= old
            self._index[name] = len(data)
            self._used += len(data)
            while self._used > self.limit:
                victim, sz = self._index.popitem(last=False)
                self._used -= sz
                try:
                    os.remove(os.path.join(self.dir, victim))
                except OSError:
                    pass


# tier split thresholds (chunk_cache.go: onDiskCacheSizeLimit0/1)
SMALL_LIMIT = 256 * 1024
MEDIUM_LIMIT = 1024 * 1024


class TieredChunkCache:
    """Mem for hot small chunks; disk tiers by size class (`chunk_cache.go:30`
    NewTieredChunkCache)."""

    def __init__(self, mem_limit: int = 64 * 1024 * 1024,
                 disk_dir: str | None = None,
                 disk_limit: int = 1024 * 1024 * 1024) -> None:
        self.mem = MemChunkCache(mem_limit)
        self.disks: list[tuple[int, DiskCacheLayer]] = []
        if disk_dir:
            # small/medium/large tiers split the budget 1:2:5 like the
            # reference's default volume-count ratios
            for name, limit, share in (
                ("small", SMALL_LIMIT, 0.125),
                ("medium", MEDIUM_LIMIT, 0.25),
                ("large", 1 << 62, 0.625),
            ):
                self.disks.append(
                    (limit, DiskCacheLayer(os.path.join(disk_dir, name),
                                           max(1, int(disk_limit * share))))
                )

    def get_chunk(self, file_id: str) -> bytes | None:
        data = self.mem.get(file_id)
        if data is not None:
            return data
        for _, layer in self.disks:
            data = layer.get(file_id)
            if data is not None:
                self.mem.set(file_id, data)
                return data
        return None

    def set_chunk(self, file_id: str, data: bytes) -> None:
        self.mem.set(file_id, data)
        for limit, layer in self.disks:
            if len(data) <= limit:
                layer.set(file_id, data)
                return
