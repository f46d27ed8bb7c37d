"""Per-volume needle index: id -> (offset, size), backed by the .idx file.

Mirrors the reference's NeedleMapper semantics
(`weed/storage/needle_map.go:23-37`, `needle_map_memory.go`): an in-memory
map hydrated by replaying the .idx; every put/delete appends an entry
(deletes append (key, tombstone_offset, -1)); bookkeeping tracks file/deleted
counts and byte totals for heartbeats.

Three implementations behind one interface:

* `CompactNeedleMap` (default) — the reference's CompactMap design point
  (`weed/storage/needle_map/compact_map.go:28,198`: ~16 B/needle so a 30GB
  volume of millions of small needles doesn't eat RAM) realized the
  numpy-first way: one key-sorted structured block (16 B/entry: u64 key,
  u32 offset in 8-byte units, i32 size) probed with vectorized binary
  search, plus a small dict of recent inserts that folds in by re-sort
  when it reaches a threshold. Replay of the .idx is fully vectorized
  (one stable sort instead of a million dict ops).
* `NeedleMap` — the plain-dict variant (reference
  `needle_map_memory.go:13`), kept for comparison tests and tiny volumes.
* `SortedFileNeedleMap` — the cold-volume variant (reference
  `needle_map_sorted_file.go`): entries live in a key-sorted `.sdx` file
  probed via mmap binary search, O(1) resident memory; deletes punch the
  size field in place.

The port's copy of `seaweedfs_tpu/storage/needle_map.py`, for 4-byte
offsets only (16-byte entries), like the port's `types.py`. Not ported:
the fastlane engine's memory-only updates and the memory-footprint probe.
"""

from __future__ import annotations

import mmap
import os
from dataclasses import dataclass

import numpy as np

from . import idx as idx_mod
from .types import (
    NEEDLE_MAP_ENTRY_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    offset_to_bytes,
    size_is_valid,
)

# entry layout: key[0:8] | offset units[8:12] | size (4B signed)
_ENTRY = NEEDLE_MAP_ENTRY_SIZE
_SZ_AT = 8 + OFFSET_SIZE
_OFF_DTYPE = np.uint32


@dataclass
class MapMetrics:
    file_count: int = 0
    deleted_count: int = 0
    deleted_bytes: int = 0
    maximum_key: int = 0


class NeedleMap:
    """In-memory map + append-only .idx writer."""

    def __init__(self, idx_path: str | None = None) -> None:
        self._map: dict[int, tuple[int, int]] = {}
        self.metrics = MapMetrics()
        self._idx_path = idx_path
        self._idx_file = None
        if idx_path is not None:
            exists = os.path.exists(idx_path)
            if exists:
                self._replay(idx_path)
            self._idx_file = open(idx_path, "ab")

    def _replay(self, path: str) -> None:
        for key, offset, size in idx_mod.walk_index_file(path):
            self._apply(key, offset, size)

    def _apply(self, key: int, offset: int, size: int) -> None:
        self.metrics.maximum_key = max(self.metrics.maximum_key, key)
        if offset > 0 and size_is_valid(size):
            old = self._map.get(key)
            if old is not None:
                self.metrics.deleted_count += 1
                self.metrics.deleted_bytes += old[1]
            else:
                self.metrics.file_count += 1
            self._map[key] = (offset, size)
        else:
            old = self._map.pop(key, None)
            if old is not None:
                self.metrics.deleted_count += 1
                self.metrics.deleted_bytes += old[1]

    # --- public API ---------------------------------------------------------
    def get(self, key: int) -> tuple[int, int] | None:
        return self._map.get(key)

    def put(self, key: int, offset: int, size: int) -> None:
        self._apply(key, offset, size)
        if self._idx_file is not None:
            self._idx_file.write(idx_mod.entry_to_bytes(key, offset, size))
            self._idx_file.flush()

    def delete(self, key: int, tombstone_offset: int = 0) -> None:
        self._apply(key, 0, TOMBSTONE_FILE_SIZE)
        if self._idx_file is not None:
            self._idx_file.write(
                idx_mod.entry_to_bytes(key, tombstone_offset, TOMBSTONE_FILE_SIZE)
            )
            self._idx_file.flush()

    def ascending_visit(self):
        for key in sorted(self._map):
            offset, size = self._map[key]
            yield key, offset, size

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: int) -> bool:
        return key in self._map

    def content_size(self) -> int:
        return sum(s for _, s in self._map.values())

    def close(self) -> None:
        if self._idx_file is not None:
            self._idx_file.close()
            self._idx_file = None


def read_index_arrays(path: str):
    """Vectorized .idx parse -> (keys u64, offset units, sizes i32), one
    numpy pass over the whole file of 16-byte entries."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // _ENTRY
    a = raw[: n * _ENTRY].reshape(n, _ENTRY)
    keys = a[:, :8].copy().view(">u8").ravel().astype(np.uint64)
    offs = a[:, 8:12].copy().view(">u4").ravel().astype(_OFF_DTYPE)
    sizes = (
        a[:, _SZ_AT : _SZ_AT + 4].copy().view(">i4").ravel().astype(np.int32)
    )
    return keys, offs, sizes


class CompactNeedleMap:
    """Sorted numpy block + overflow dict; ~16-18 B/needle steady state.

    In-place semantics: updates and deletes of keys already in the sorted
    block mutate its offset/size slots directly (size 0 marks a hole —
    valid sizes are strictly positive, `types.size_is_valid`); only
    genuinely new keys enter the overflow dict, which is folded into the
    block by one concatenate+argsort when it reaches MERGE_THRESHOLD."""

    MERGE_THRESHOLD = 32768
    _HOLE = 0

    def __init__(self, idx_path: str | None = None) -> None:
        import threading

        # readers (Volume.read_needle, fsck visits) run concurrently with
        # writers; _merge() reallocates all three arrays, so unlike the
        # GIL-atomic dict map every access must hold the lock
        self._mu = threading.RLock()
        self._keys = np.empty(0, dtype=np.uint64)
        self._offs = np.empty(0, dtype=_OFF_DTYPE)  # 8-byte units
        self._sizes = np.empty(0, dtype=np.int32)
        self._overflow: dict[int, tuple[int, int]] = {}  # key -> (off_u, size)
        self._live = 0
        self.metrics = MapMetrics()
        self._idx_path = idx_path
        self._idx_file = None
        if idx_path is not None:
            if os.path.exists(idx_path):
                self._replay_vectorized(idx_path)
            self._idx_file = open(idx_path, "ab")

    # --- replay -------------------------------------------------------------
    def _replay_vectorized(self, path: str) -> None:
        keys, offs, sizes = read_index_arrays(path)
        n = keys.size
        if n == 0:
            return
        valid = (offs > 0) & (sizes > 0)
        order = np.argsort(keys, kind="stable")
        k = keys[order]
        v = valid[order]
        sz = sizes[order]
        of = offs[order]
        same_prev = np.empty(n, dtype=bool)
        same_prev[0] = False
        same_prev[1:] = k[1:] == k[:-1]
        prev_valid = np.zeros(n, dtype=bool)
        prev_valid[1:] = v[:-1] & same_prev[1:]
        # exact parity with the sequential _apply bookkeeping:
        # an entry that directly follows a live value supersedes it
        self.metrics.deleted_count = int(np.count_nonzero(prev_valid))
        idxs = np.flatnonzero(prev_valid)
        self.metrics.deleted_bytes = int(sz[idxs - 1].sum()) if idxs.size else 0
        self.metrics.file_count = int(np.count_nonzero(v & ~prev_valid))
        self.metrics.maximum_key = int(k[-1])
        last = np.empty(n, dtype=bool)
        last[:-1] = k[:-1] != k[1:]
        last[-1] = True
        live = last & v
        self._keys = np.ascontiguousarray(k[live])
        self._offs = np.ascontiguousarray(of[live])
        self._sizes = np.ascontiguousarray(sz[live])
        self._live = int(self._keys.size)

    # --- internals ----------------------------------------------------------
    def _sorted_slot(self, key: int) -> int:
        """Index of key in the sorted block, or -1."""
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < self._keys.size and int(self._keys[i]) == key:
            return i
        return -1

    def _merge(self) -> None:
        if not self._overflow:
            return
        ok = np.fromiter(self._overflow.keys(), dtype=np.uint64,
                         count=len(self._overflow))
        ov = np.array(list(self._overflow.values()), dtype=np.int64)
        keys = np.concatenate([self._keys, ok])
        offs = np.concatenate([self._offs, ov[:, 0].astype(_OFF_DTYPE)])
        sizes = np.concatenate([self._sizes, ov[:, 1].astype(np.int32)])
        order = np.argsort(keys, kind="stable")
        self._keys = np.ascontiguousarray(keys[order])
        self._offs = np.ascontiguousarray(offs[order])
        self._sizes = np.ascontiguousarray(sizes[order])
        self._overflow.clear()

    def _set_live(self, key: int, offset: int, size: int) -> bool:
        """Insert/update; returns True if the key was already live."""
        off_u = offset // 8
        old = self._overflow.get(key)
        if old is not None:
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += old[1]
            self._overflow[key] = (off_u, size)
            return True
        i = self._sorted_slot(key)
        if i >= 0:
            was_hole = int(self._sizes[i]) == self._HOLE
            if not was_hole:
                self.metrics.deleted_count += 1
                self.metrics.deleted_bytes += int(self._sizes[i])
            self._offs[i] = off_u
            self._sizes[i] = size
            return not was_hole
        self._overflow[key] = (off_u, size)
        if len(self._overflow) >= self.MERGE_THRESHOLD:
            self._merge()
        return False

    # --- public API (same shape as NeedleMap) -------------------------------
    def get(self, key: int) -> tuple[int, int] | None:
        with self._mu:
            v = self._overflow.get(key)
            if v is not None:
                return (v[0] * 8, v[1])
            i = self._sorted_slot(key)
            if i >= 0 and int(self._sizes[i]) != self._HOLE:
                return (int(self._offs[i]) * 8, int(self._sizes[i]))
            return None

    def put(self, key: int, offset: int, size: int) -> None:
        with self._mu:
            self.metrics.maximum_key = max(self.metrics.maximum_key, key)
            if offset > 0 and size_is_valid(size):
                if not self._set_live(key, offset, size):
                    self.metrics.file_count += 1
                    self._live += 1
            else:
                self._delete_state(key)
            if self._idx_file is not None:
                self._idx_file.write(idx_mod.entry_to_bytes(key, offset, size))
                self._idx_file.flush()

    def _delete_state(self, key: int) -> None:
        old = self._overflow.pop(key, None)
        if old is not None:
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += old[1]
            self._live -= 1
            return
        i = self._sorted_slot(key)
        if i >= 0 and int(self._sizes[i]) != self._HOLE:
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += int(self._sizes[i])
            self._sizes[i] = self._HOLE
            self._live -= 1

    def delete(self, key: int, tombstone_offset: int = 0) -> None:
        with self._mu:
            self.metrics.maximum_key = max(self.metrics.maximum_key, key)
            self._delete_state(key)
            if self._idx_file is not None:
                self._idx_file.write(
                    idx_mod.entry_to_bytes(
                        key, tombstone_offset, TOMBSTONE_FILE_SIZE
                    )
                )
                self._idx_file.flush()

    def ascending_visit(self):
        with self._mu:
            self._merge()
            live = self._sizes != self._HOLE
            keys = self._keys[live].copy()
            offs = self._offs[live].copy()
            sizes = self._sizes[live].copy()
        for key, off_u, size in zip(keys, offs, sizes):
            yield int(key), int(off_u) * 8, int(size)

    def live_keys_sizes(self):
        """Live (keys, sizes) as numpy columns — the needle_set_digest
        fast path (no per-entry Python objects on the heartbeat)."""
        with self._mu:
            self._merge()
            live = self._sizes != self._HOLE
            return self._keys[live].copy(), self._sizes[live].copy()

    def __len__(self) -> int:
        return self._live

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def content_size(self) -> int:
        with self._mu:
            block = (
                int(np.maximum(self._sizes, 0).sum()) if self._sizes.size else 0
            )
            return block + sum(s for _, s in self._overflow.values())

    def close(self) -> None:
        if self._idx_file is not None:
            self._idx_file.close()
            self._idx_file = None


class SortedFileNeedleMap:
    """Cold-volume map: key-sorted `.sdx` file (16B entries, same layout as
    `.idx`) probed via mmap binary search — O(1) resident memory
    (reference `weed/storage/needle_map_sorted_file.go`). Deletes punch
    the size field to the tombstone value in place; puts of new keys are
    unsupported (cold/readonly volumes only)."""

    def __init__(self, base_name: str) -> None:
        self.sdx_path = base_name + ".sdx"
        if not os.path.exists(self.sdx_path):
            self._build(base_name + ".idx")
        self._f = open(self.sdx_path, "r+b")
        size = os.path.getsize(self.sdx_path)
        self._n = size // _ENTRY
        self._mm = (
            mmap.mmap(self._f.fileno(), size) if size else None
        )
        self.metrics = MapMetrics()
        # zero-copy key view straight over the mmap (O(1) resident memory —
        # the design point of this map): each 16B row is two aligned
        # big-endian u64s, so a strided view works
        self._keys = None
        if self._mm is not None and self._n:
            buf = np.frombuffer(self._mm, dtype=np.uint8)
            self._keys = buf.reshape(self._n, _ENTRY).view(">u8")[:, 0]
            # metrics scan: chunked pass, nothing retained
            live = 0
            step = 1 << 16
            for lo in range(0, self._n, step):
                hi = min(self._n, lo + step)
                a = buf[lo * _ENTRY : hi * _ENTRY].reshape(hi - lo, _ENTRY)
                sizes = a[:, _SZ_AT : _SZ_AT + 4].copy().view(">i4").ravel()
                live += int(np.count_nonzero(sizes > 0))
            self.metrics.file_count = live
            self.metrics.maximum_key = idx_mod.entry_from_bytes(
                self._mm, (self._n - 1) * _ENTRY
            )[0]

    def _build(self, idx_path: str) -> None:
        """Write the .sdx: latest entry per key, keys ascending, holes
        (tombstoned/unwritten keys) dropped."""
        keys, offs, sizes = read_index_arrays(idx_path)
        n = keys.size
        out = np.empty((0, _ENTRY), dtype=np.uint8)
        if n:
            valid = (offs > 0) & (sizes > 0)
            order = np.argsort(keys, kind="stable")
            k, v, sz, of = keys[order], valid[order], sizes[order], offs[order]
            last = np.empty(n, dtype=bool)
            last[:-1] = k[:-1] != k[1:]
            last[-1] = True
            live = last & v
            k, sz, of = k[live], sz[live], of[live]
            out = np.empty((k.size, _ENTRY), dtype=np.uint8)
            out[:, :8] = k.astype(">u8")[:, None].view(np.uint8)
            out[:, 8:12] = of.astype(">u4")[:, None].view(np.uint8)
            out[:, _SZ_AT : _SZ_AT + 4] = sz.astype(">i4")[:, None].view(
                np.uint8
            )
        with open(self.sdx_path, "wb") as f:
            f.write(out.tobytes())

    def _key_at(self, i: int) -> int:
        return int.from_bytes(self._mm[i * _ENTRY : i * _ENTRY + 8], "big")

    def _slot(self, key: int) -> int:
        if self._n == 0:
            return -1
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < self._n and self._key_at(i) == key:
            return i
        return -1

    def get(self, key: int) -> tuple[int, int] | None:
        i = self._slot(key)
        if i < 0:
            return None
        _, offset, size = idx_mod.entry_from_bytes(self._mm, i * _ENTRY)
        if not size_is_valid(size):
            return None
        return offset, size

    def delete(self, key: int, tombstone_offset: int = 0) -> None:
        i = self._slot(key)
        if i < 0:
            return
        _, _, size = idx_mod.entry_from_bytes(self._mm, i * _ENTRY)
        if size_is_valid(size):
            self.metrics.deleted_count += 1
            self.metrics.deleted_bytes += size
            self.metrics.file_count -= 1
            self._mm[i * _ENTRY + _SZ_AT : i * _ENTRY + _SZ_AT + 4] = (
                TOMBSTONE_FILE_SIZE & 0xFFFFFFFF
            ).to_bytes(4, "big")

    def put(self, key: int, offset: int, size: int) -> None:
        i = self._slot(key)
        if i < 0:
            raise NotImplementedError(
                "SortedFileNeedleMap is for cold volumes: new keys require"
                " the in-memory map"
            )
        self._mm[i * _ENTRY + 8 : i * _ENTRY + _SZ_AT] = offset_to_bytes(offset)
        self._mm[i * _ENTRY + _SZ_AT : i * _ENTRY + _SZ_AT + 4] = (
            size & 0xFFFFFFFF
        ).to_bytes(4, "big")

    def ascending_visit(self):
        for i in range(self._n):
            key, offset, size = idx_mod.entry_from_bytes(
                self._mm, i * _ENTRY
            )
            if size_is_valid(size):
                yield key, offset, size

    def __len__(self) -> int:
        return self.metrics.file_count

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def content_size(self) -> int:
        return sum(s for _, _, s in self.ascending_visit())

    def close(self) -> None:
        self._keys = None  # release the numpy view exported over the mmap
        if self._mm is not None:
            self._mm.flush()
            self._mm.close()
            self._mm = None
        self._f.close()


# the empty set's fold: a REAL digest (so an empty replica still
# diverges from populated peers) but one the detector recognizes — an
# append-only replica with no history can never be the source of truth
EMPTY_NEEDLE_DIGEST = "0" * 16


def needle_set_digest(entries) -> str:
    """Order-independent digest over live (needle_id, size) pairs — the
    anti-entropy fingerprint riding heartbeats (maintenance/scrub.py).

    Two replicas holding the same logical content — regardless of append
    order, vacuum history, or on-disk offsets — produce the same digest;
    a missed write or missed delete changes it. XOR- and ADD-folds of a
    mixed 64-bit hash per entry (both folds together so swapped pairs
    can't cancel). Returns 16 hex chars; the empty set folds to all
    zeros — a REAL digest, not "", so a replica that silently missed
    every write still diverges from its populated peers ("" is reserved
    for "digest not reported"). `entries` may be a (key, offset, size)
    iterable OR a nm instance exposing live_keys_sizes() — the
    CompactNeedleMap fast path hands over its numpy columns directly,
    so a million-needle volume's heartbeat never pays a Python loop."""
    if hasattr(entries, "live_keys_sizes"):
        k, s = entries.live_keys_sizes()
        k = k.astype(np.uint64, copy=False)
        s = s.astype(np.uint64, copy=False)
    else:
        keys, sizes = [], []
        for key, _off, size in entries:
            keys.append(key)
            sizes.append(size)
        k = np.asarray(keys, dtype=np.uint64)
        s = np.asarray(sizes, dtype=np.uint64)
    if k.size == 0:
        return EMPTY_NEEDLE_DIGEST
    with np.errstate(over="ignore"):
        h = (k + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15)
        h ^= (s + np.uint64(1)) * np.uint64(0xC2B2AE3D27D4EB4F)
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        xor_fold = np.bitwise_xor.reduce(h)
        add_fold = np.add.reduce(h)
    return (f"{int(xor_fold) & 0xFFFFFFFF:08x}"
            f"{int(add_fold) & 0xFFFFFFFF:08x}")
