"""LSM-tree embedded ordered-KV filer store — the leveldb-class slot
(`weed/filer/leveldb/leveldb_store.go`; goleveldb is itself an LSM tree).

Unlike `kvstore.LocalKV` (whole table resident + snapshot rewrite), this is
a real log-structured merge design, so cold metadata does not live in RAM:

    writes  -> WAL append + memtable (dict)
    flush   -> memtable sorted into an immutable SSTable file (L0)
    reads   -> memtable, then SSTables newest-to-oldest (sparse index +
               block binary search; only the sparse index is resident)
    deletes -> tombstone records that shadow older tables
    compact -> when tables pile up, k-way merge all into one table and
               drop shadowed values + tombstones

SSTable file layout (all little-endian):

    [record]*      record = klen u32 | vlen u32 | key | value
                   (vlen == 0xFFFFFFFF marks a tombstone)
    [index]        every INDEX_EVERY-th record: klen u32 | key | off u64
    footer         index_off u64 | index_count u32 | magic "SWT1"

Keys are `<directory>\x00<name>` so one range scan lists a directory in
name order (the reference's leveldb genKey layout).

The port's copy of `seaweedfs_tpu/filer/lsm.py`.
"""

from __future__ import annotations

import heapq
import json
import os
import struct
import threading
from typing import Iterator

from .entry import Entry
from .filerstore import FilerStore

_HDR = struct.Struct("<II")
_IDX = struct.Struct("<I")
_OFF = struct.Struct("<Q")
_FOOTER = struct.Struct("<QI4s")
_MAGIC = b"SWT1"
_TOMBSTONE_LEN = 0xFFFFFFFF

INDEX_EVERY = 16  # sparse index density: 1 resident key per 16 records
_WAL_HDR = struct.Struct("<BII")
_PUT = 1
_DEL = 2


class SSTable:
    """One immutable sorted table; only the sparse index is resident."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "rb")
        size = os.path.getsize(path)
        self._f.seek(size - _FOOTER.size)
        index_off, count, magic = _FOOTER.unpack(self._f.read(_FOOTER.size))
        if magic != _MAGIC:
            raise IOError(f"{path}: bad sstable footer")
        self._f.seek(index_off)
        self._index_keys: list[bytes] = []
        self._index_offs: list[int] = []
        for _ in range(count):
            (klen,) = _IDX.unpack(self._f.read(_IDX.size))
            self._index_keys.append(self._f.read(klen))
            (off,) = _OFF.unpack(self._f.read(_OFF.size))
            self._index_offs.append(off)
        self._data_end = index_off
        self._lock = threading.Lock()

    @staticmethod
    def write(path: str, items: Iterator[tuple[bytes, bytes | None]]) -> None:
        """items: sorted (key, value-or-None-tombstone). Atomic via tmp+rename."""
        tmp = path + ".tmp"
        index: list[tuple[bytes, int]] = []
        with open(tmp, "wb") as f:
            n = 0
            for key, value in items:
                if n % INDEX_EVERY == 0:
                    index.append((key, f.tell()))
                if value is None:
                    f.write(_HDR.pack(len(key), _TOMBSTONE_LEN) + key)
                else:
                    f.write(_HDR.pack(len(key), len(value)) + key + value)
                n += 1
            index_off = f.tell()
            for key, off in index:
                f.write(_IDX.pack(len(key)) + key + _OFF.pack(off))
            f.write(_FOOTER.pack(index_off, len(index), _MAGIC))
        os.replace(tmp, path)

    def _read_record(self) -> tuple[bytes, bytes | None] | None:
        if self._f.tell() >= self._data_end:
            return None
        hdr = self._f.read(_HDR.size)
        if len(hdr) < _HDR.size:
            return None
        klen, vlen = _HDR.unpack(hdr)
        key = self._f.read(klen)
        if vlen == _TOMBSTONE_LEN:
            return key, None
        return key, self._f.read(vlen)

    def get(self, key: bytes) -> tuple[bool, bytes | None]:
        """(found, value_or_None-for-tombstone)."""
        import bisect

        i = bisect.bisect_right(self._index_keys, key) - 1
        if i < 0:
            return False, None
        with self._lock:
            self._f.seek(self._index_offs[i])
            for _ in range(INDEX_EVERY):
                rec = self._read_record()
                if rec is None:
                    break
                if rec[0] == key:
                    return True, rec[1]
                if rec[0] > key:
                    break
        return False, None

    def scan(self, start: bytes, end: bytes) -> Iterator[tuple[bytes, bytes | None]]:
        """All records with start <= key < end, incl. tombstones (the merge
        layer needs them to shadow older tables)."""
        import bisect

        i = max(0, bisect.bisect_right(self._index_keys, start) - 1)
        if not self._index_keys:
            return
        out = []
        with self._lock:
            self._f.seek(self._index_offs[i])
            while True:
                rec = self._read_record()
                if rec is None or rec[0] >= end:
                    break
                if rec[0] >= start:
                    out.append(rec)
        yield from out

    def all_records(self) -> list[tuple[bytes, bytes | None]]:
        with self._lock:
            self._f.seek(0)
            out = []
            while True:
                rec = self._read_record()
                if rec is None:
                    break
                out.append(rec)
        return out

    def close(self) -> None:
        self._f.close()


class LsmKV:
    """Memtable + WAL + SSTable levels with full-merge compaction."""

    def __init__(
        self,
        dir_path: str,
        memtable_bytes: int = 4 * 1024 * 1024,
        max_tables: int = 6,
    ) -> None:
        os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self.memtable_bytes = memtable_bytes
        self.max_tables = max_tables
        self.wal_path = os.path.join(dir_path, "wal.log")
        self._mem: dict[bytes, bytes | None] = {}
        self._mem_bytes = 0
        self._lock = threading.RLock()
        self._tables: list[SSTable] = []  # oldest .. newest
        self._seq = 0
        self.manifest_path = os.path.join(dir_path, "MANIFEST")
        names = None
        if os.path.exists(self.manifest_path):
            try:
                names = json.loads(open(self.manifest_path).read())
            except ValueError:
                names = None
        if names is None:
            names = sorted(
                n for n in os.listdir(dir_path) if n.endswith(".sst")
            )
        for name in names:
            path = os.path.join(dir_path, name)
            if os.path.exists(path):
                self._tables.append(SSTable(path))
                self._seq = max(self._seq, int(name.split(".")[0]) + 1)
        # orphans outside the manifest (crash between manifest write and
        # old-table unlink) are dead: remove so they never resurrect
        # tombstoned keys on a later manifest-less open
        for name in os.listdir(dir_path):
            if name.endswith(".sst") and name not in names:
                try:
                    os.unlink(os.path.join(dir_path, name))
                except OSError:
                    pass
        self._replay_wal()
        self._wal = open(self.wal_path, "ab")

    def _write_manifest(self) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump([os.path.basename(t.path) for t in self._tables], f)
        os.replace(tmp, self.manifest_path)

    # --- WAL ----------------------------------------------------------------
    def _replay_wal(self) -> None:
        if not os.path.exists(self.wal_path):
            return
        data = open(self.wal_path, "rb").read()
        i = 0
        while i + _WAL_HDR.size <= len(data):
            op, klen, vlen = _WAL_HDR.unpack_from(data, i)
            i += _WAL_HDR.size
            if i + klen + vlen > len(data):
                break  # torn tail after a crash
            key = data[i : i + klen]
            i += klen
            value = data[i : i + vlen]
            i += vlen
            if op == _PUT:
                self._mem[key] = value
                self._mem_bytes += klen + vlen
            else:
                self._mem[key] = None
                self._mem_bytes += klen

    def _append_wal(self, op: int, key: bytes, value: bytes) -> None:
        self._wal.write(_WAL_HDR.pack(op, len(key), len(value)) + key + value)
        self._wal.flush()

    # --- flush / compaction --------------------------------------------------
    def _flush_memtable(self) -> None:
        if not self._mem:
            return
        path = os.path.join(self.dir, f"{self._seq:08d}.sst")
        self._seq += 1
        SSTable.write(path, iter(sorted(self._mem.items())))
        self._tables.append(SSTable(path))
        self._write_manifest()
        self._mem.clear()
        self._mem_bytes = 0
        self._wal.close()
        self._wal = open(self.wal_path, "wb")  # truncate: state is durable
        if len(self._tables) > self.max_tables:
            self._compact()

    def _compact(self) -> None:
        """Full merge: newest record per key wins; tombstones drop out."""
        merged: dict[bytes, bytes | None] = {}
        for table in self._tables:  # oldest..newest: later overwrite earlier
            for key, value in table.all_records():
                merged[key] = value
        path = os.path.join(self.dir, f"{self._seq:08d}.sst")
        self._seq += 1
        SSTable.write(
            path,
            iter(sorted(
                (k, v) for k, v in merged.items() if v is not None
            )),
        )
        olds = self._tables
        self._tables = [SSTable(path)]
        self._write_manifest()  # atomic switch BEFORE unlinking the olds:
        for table in olds:      # a crash here leaves ignorable orphans only
            table.close()
            try:
                os.unlink(table.path)
            except OSError:
                pass

    # --- API ----------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._append_wal(_PUT, key, value)
            self._mem[key] = value
            self._mem_bytes += len(key) + len(value)
            if self._mem_bytes >= self.memtable_bytes:
                self._flush_memtable()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._append_wal(_DEL, key, b"")
            self._mem[key] = None
            self._mem_bytes += len(key)

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            for table in reversed(self._tables):
                found, value = table.get(key)
                if found:
                    return value
        return None

    def scan(self, start: bytes, end: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Sorted live (non-tombstone) records in [start, end)."""
        with self._lock:
            sources: list[Iterator] = [
                iter(sorted(
                    (k, v) for k, v in self._mem.items() if start <= k < end
                ))
            ]
            # newer sources first; heapq tie-breaks by source rank
            for table in reversed(self._tables):
                sources.append(table.scan(start, end))
            def tag(src, rank):  # bind rank now — genexps close over the var
                for key, value in src:
                    yield key, rank, value

            merged = heapq.merge(
                *(tag(src, rank) for rank, src in enumerate(sources))
            )
            last_key = None
            for key, _rank, value in merged:
                if key == last_key:
                    continue  # newer source already decided this key
                last_key = key
                if value is not None:
                    yield key, value

    def flush(self) -> None:
        with self._lock:
            self._flush_memtable()

    def close(self) -> None:
        with self._lock:
            self._wal.close()
            for t in self._tables:
                t.close()

    def resident_bytes(self) -> int:
        """Approximate resident footprint: memtable + sparse indexes only."""
        idx = sum(
            sum(len(k) + 8 for k in t._index_keys) for t in self._tables
        )
        return self._mem_bytes + idx


class LsmStore(FilerStore):
    """FilerStore over LsmKV (the leveldb_store.go slot)."""

    name = "lsm"
    _KV_PREFIX = b"@kv\x00"

    def __init__(self, path: str) -> None:
        self.path = path
        self.kv = LsmKV(path)

    @staticmethod
    def _key(full_path: str) -> bytes:
        if full_path == "/":
            return b"\x00/"  # before every dir prefix: root never lists itself
        d, _, name = full_path.rpartition("/")
        return (d or "/").encode() + b"\x00" + name.encode()

    def insert_entry(self, entry: Entry) -> None:
        self.kv.put(
            self._key(entry.full_path), json.dumps(entry.to_dict()).encode()
        )

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, full_path: str) -> Entry | None:
        blob = self.kv.get(self._key(full_path))
        return Entry.from_dict(json.loads(blob)) if blob else None

    def delete_entry(self, full_path: str) -> None:
        self.kv.delete(self._key(full_path))

    def list_entries(
        self, dir_path: str, start_from: str, inclusive: bool, limit: int
    ) -> Iterator[Entry]:
        prefix = (dir_path.encode() if dir_path != "/" else b"/") + b"\x00"
        start = prefix + start_from.encode()
        if start_from and not inclusive:
            start += b"\x01"
        count = 0
        for _key, blob in self.kv.scan(start if start_from else prefix,
                                       prefix + b"\xff"):
            if count >= limit:
                return
            yield Entry.from_dict(json.loads(blob))
            count += 1

    def kv_put(self, key: str, value: bytes) -> None:
        self.kv.put(self._KV_PREFIX + key.encode(), value)

    def kv_get(self, key: str) -> bytes | None:
        return self.kv.get(self._KV_PREFIX + key.encode())

    def kv_delete(self, key: str) -> None:
        self.kv.delete(self._KV_PREFIX + key.encode())

    def close(self) -> None:
        self.kv.close()
