"""Embedded log-structured KV filer store — the slot the reference fills
with goleveldb (`weed/filer/leveldb/leveldb_store.go`, leveldb2/leveldb3).

Design: a binary write-ahead log + periodic sorted snapshot (an L0-style
compaction). Writes append a length-prefixed record to the WAL and update
the in-memory table; open() loads the snapshot then replays the WAL
(tolerating a torn final record, as after a crash). When the WAL exceeds
`compact_bytes` the whole table is rewritten as a new snapshot atomically
and the WAL truncated.

Entry keys are `<directory>\\x00<name>` so one sorted scan yields a
directory listing in name order (the same trick as the reference's
leveldb key layout: `genKey` dir+name).

The port's copy of `seaweedfs_tpu/filer/kvstore.py`.
"""

from __future__ import annotations

import bisect
import json
import os
import struct
import threading
from typing import Iterator

from .entry import Entry
from .filerstore import FilerStore

_PUT = 1
_DEL = 2
_HDR = struct.Struct("<BII")  # op, key_len, value_len


class LocalKV:
    """Sorted in-memory table + WAL + snapshot files."""

    def __init__(self, dir_path: str, compact_bytes: int = 8 * 1024 * 1024) -> None:
        os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self.wal_path = os.path.join(dir_path, "wal.log")
        self.snap_path = os.path.join(dir_path, "snapshot.db")
        self.compact_bytes = compact_bytes
        self._table: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted view of _table keys
        self._lock = threading.RLock()
        self._load()
        self._wal = open(self.wal_path, "ab")

    # --- persistence ------------------------------------------------------------
    def _load(self) -> None:
        if os.path.exists(self.snap_path):
            with open(self.snap_path, "rb") as f:
                data = f.read()
            self._replay(data)
        if os.path.exists(self.wal_path):
            with open(self.wal_path, "rb") as f:
                self._replay(f.read())
        self._keys = sorted(self._table)

    def _replay(self, data: bytes) -> None:
        off = 0
        n = len(data)
        while off + _HDR.size <= n:
            op, klen, vlen = _HDR.unpack_from(data, off)
            off += _HDR.size
            if off + klen + vlen > n or op not in (_PUT, _DEL):
                break  # torn tail record (crash mid-append) — stop replay
            key = data[off : off + klen]
            off += klen
            value = data[off : off + vlen]
            off += vlen
            if op == _PUT:
                self._table[key] = value
            else:
                self._table.pop(key, None)

    def _append(self, op: int, key: bytes, value: bytes) -> None:
        rec = _HDR.pack(op, len(key), len(value)) + key + value
        self._wal.write(rec)
        self._wal.flush()
        if self._wal.tell() >= self.compact_bytes:
            self._compact()

    def _compact(self) -> None:
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            for key in self._keys:
                value = self._table[key]
                f.write(_HDR.pack(_PUT, len(key), len(value)) + key + value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        self._wal.close()
        self._wal = open(self.wal_path, "wb")  # truncate

    # --- ops --------------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._table:
                bisect.insort(self._keys, key)
            self._table[key] = value
            self._append(_PUT, key, value)

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._table.get(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._table:
                del self._table[key]
                i = bisect.bisect_left(self._keys, key)
                if i < len(self._keys) and self._keys[i] == key:
                    del self._keys[i]
            self._append(_DEL, key, b"")

    def scan(self, start: bytes, end: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) for start <= key < end in key order."""
        with self._lock:
            i = bisect.bisect_left(self._keys, start)
            keys = []
            while i < len(self._keys) and self._keys[i] < end:
                keys.append(self._keys[i])
                i += 1
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def close(self) -> None:
        with self._lock:
            self._wal.close()


class LocalKVStore(FilerStore):
    """FilerStore over LocalKV (the reference's `leveldb` store kind)."""

    name = "leveldb"

    def __init__(self, path: str) -> None:
        self.path = path
        self.kv = LocalKV(os.path.join(path, "filermeta"))
        self.kv_extra = LocalKV(os.path.join(path, "filerkv"))

    @staticmethod
    def _key(full_path: str) -> bytes:
        if full_path == "/":
            return b"\x00/"
        d, _, n = full_path.rpartition("/")
        return (d or "/").encode() + b"\x00" + n.encode()

    def insert_entry(self, entry: Entry) -> None:
        self.kv.put(
            self._key(entry.full_path), json.dumps(entry.to_dict()).encode()
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        raw = self.kv.get(self._key(full_path))
        return Entry.from_dict(json.loads(raw)) if raw else None

    def delete_entry(self, full_path: str) -> None:
        self.kv.delete(self._key(full_path))

    def list_entries(
        self, dir_path: str, start_from: str, inclusive: bool, limit: int
    ) -> Iterator[Entry]:
        d = dir_path.rstrip("/") or "/"
        prefix = d.encode() + b"\x00"
        # seek straight to the page cursor: inclusive starts AT start_from,
        # exclusive starts just past it (\x00 is the smallest suffix)
        start = prefix + start_from.encode()
        if start_from and not inclusive:
            start += b"\x00"
        count = 0
        for key, raw in self.kv.scan(start, prefix + b"\xff\xff\xff\xff"):
            if count >= limit:
                return
            count += 1
            yield Entry.from_dict(json.loads(raw))

    def kv_put(self, key: str, value: bytes) -> None:
        self.kv_extra.put(key.encode(), value)

    def kv_get(self, key: str) -> bytes | None:
        return self.kv_extra.get(key.encode())

    def close(self) -> None:
        self.kv.close()
        self.kv_extra.close()
