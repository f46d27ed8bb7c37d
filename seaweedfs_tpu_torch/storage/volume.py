"""Volume: one append-only .dat (+ .idx) pair holding millions of needles.

The port's copy of `seaweedfs_tpu/storage/volume.py` (after
`weed/storage/volume.go` + `volume_read.go` + `volume_write.go` +
`volume_loading.go` + `volume_checking.go` + `volume_vacuum.go` +
`volume_backup.go`):

  - superblock at offset 0; needles appended 8-byte aligned
  - write: append needle, idx entry; duplicate-content writes detected
  - read: map lookup -> positional read -> parse + cookie check + TTL expiry;
    a read that fails on a torn or unreadable record is served from the
    volume's EC redundancy (open online parity, else sealed shards)
  - delete: append zero-data tombstone needle + tombstone idx entry
  - vacuum: copy live needles to .cpd/.cpx shadow files, then atomic rename
    with compaction-revision bump
  - integrity check on load: last idx entry's needle must verify against .dat
  - incremental backup: binary search needles by AppendAtNs

Not ported: remote tiering (a volume whose `.vif` lists a remote file
does not open), replication reconfiguration, the native fastlane hook,
fault points, events and metrics. Thread-safety: one writer lock; reads use positional os.pread.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import crc as crc_mod
from . import idx as idx_mod
from .backend import DiskFile, get_backend
from .needle import CURRENT_VERSION, Needle, get_actual_size
from .needle_map import CompactNeedleMap, needle_set_digest
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import (
    NEEDLE_HEADER_SIZE,
    NEEDLE_PADDING_SIZE,
    TOMBSTONE_FILE_SIZE,
    TTL,
    ReplicaPlacement,
    get_u64,
    size_is_valid,
)


class VolumeError(Exception):
    pass


class NotFound(VolumeError):
    pass


def volume_file_name(dir_: str, collection: str, vid: int) -> str:
    base = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(dir_, base)


class Volume:
    def __init__(
        self,
        dir_: str,
        collection: str,
        volume_id: int,
        replica_placement: ReplicaPlacement | None = None,
        ttl: TTL | None = None,
        version: int = CURRENT_VERSION,
        device=None,
    ) -> None:
        self.dir = dir_
        # where a degraded read's GF math runs when no online writer (with
        # its own codec) is attached: cuda unless "cpu" is passed
        self.device = device
        self.collection = collection
        self.id = volume_id
        self.base_name = volume_file_name(dir_, collection, volume_id)
        self._write_lock = threading.Lock()
        # OnlineEcWriter streaming this volume's appends through the RS
        # encoder (erasure_coding/online.py), attached by the Store when
        # the volume's policy is ec_online; None = classic volume
        self.online_ec = None
        self.readonly = False
        self.last_append_at_ns = 0
        # bumped by commit_compact's swap: readers that straddle it retry
        # against the post-swap (nm, dat) pair instead of failing spuriously
        self._compact_gen = 0
        self._digest_cache = None

        tier = self._load_tier_info()
        if tier is not None:  # the .dat lives in a remote backend
            get_backend(tier["backend_id"])  # raises: tiering is not ported
        dat_path = self.base_name + ".dat"
        is_new = not os.path.exists(dat_path)
        if is_new:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL(),
            )
            with open(dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
        self._dat = DiskFile(dat_path)
        try:
            if not is_new:
                header = self._dat.read_at(SUPER_BLOCK_SIZE, 0)
                self.super_block = SuperBlock.from_bytes(header)
            self.nm = CompactNeedleMap(self.base_name + ".idx")
        except BaseException:
            self._dat.close()
            raise
        self._size = self._dat.file_size()
        if not is_new:
            try:
                self._check_idx_integrity()
                self._load_last_append_at_ns()
            except BaseException:
                self.nm.close()
                self._dat.close()
                raise

    def __enter__(self) -> "Volume":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- loading / integrity -------------------------------------------------
    def _check_idx_integrity(self) -> None:
        """verifyIndexFileIntegrity equivalent (`volume_checking.go:91,152`):
        the last live idx entry's needle must parse at its offset."""
        idx_path = self.base_name + ".idx"
        size = os.path.getsize(idx_path)
        if size == 0:
            return
        with open(idx_path, "rb") as f:
            f.seek(size - 16)
            key, offset, esize = idx_mod.entry_from_bytes(f.read(16))
        if offset == 0 or not size_is_valid(esize):
            return
        blob = self._dat.read_at(get_actual_size(esize, self.version()), offset)
        n = Needle.from_bytes(blob, size=esize, version=self.version())
        if n.id != key:
            raise VolumeError(
                f"volume {self.id}: idx tail mismatch id {n.id:x} != {key:x}"
            )

    def _load_last_append_at_ns(self) -> None:
        entry = None
        max_off = 0
        for key, offset, size in self.nm.ascending_visit():
            if offset > max_off:
                max_off = offset
                entry = (key, offset, size)
        if entry is None:
            return
        _, offset, size = entry
        version = self.version()
        if version == 3:
            blob = self._dat.read_at(get_actual_size(size, version), offset)
            if len(blob) >= get_actual_size(size, version):
                ts_off = NEEDLE_HEADER_SIZE + size + 4
                self.last_append_at_ns = get_u64(blob, ts_off)

    def version(self) -> int:
        return self.super_block.version

    def close(self) -> None:
        if self.online_ec is not None:
            self.online_ec.close()
            self.online_ec = None
        self.nm.close()
        self._dat.close()

    # --- stats ---------------------------------------------------------------
    def size(self) -> int:
        return self._size

    def file_count(self) -> int:
        return self.nm.metrics.file_count

    def deleted_count(self) -> int:
        return self.nm.metrics.deleted_count

    def deleted_bytes(self) -> int:
        return self.nm.metrics.deleted_bytes

    def max_needle_id(self) -> int:
        return self.nm.metrics.maximum_key

    def garbage_level(self) -> float:
        if self._size <= SUPER_BLOCK_SIZE:
            return 0.0
        return self.nm.metrics.deleted_bytes / self._size

    def content_size(self) -> int:
        return self.nm.content_size()

    def needle_map_digest(self) -> str:
        """Order-independent digest of the live (needle_id, size) set that
        rides every heartbeat (`needle_map.needle_set_digest`), cached
        against the (size, file_count, deleted_count) triple."""
        key = (
            self._size,
            self.nm.metrics.file_count,
            self.nm.metrics.deleted_count,
        )
        cached = self._digest_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        digest = needle_set_digest(self.nm)
        self._digest_cache = (key, digest)
        return digest

    # --- write path ----------------------------------------------------------
    def _is_unchanged(self, n: Needle) -> bool:
        """Duplicate-write suppression (`volume_write.go:32`): same id, same
        cookie, same checksum+data."""
        nv = self.nm.get(n.id)
        if nv is None or not size_is_valid(nv[1]):
            return False
        try:
            old = self._read_at(nv[0], nv[1])
        except Exception:
            # an unreadable/corrupt old record is by definition NOT
            # unchanged: overwriting it with the incoming clean copy repairs it
            return False
        return (
            old.cookie == n.cookie
            and old.checksum == crc_mod.crc32c(n.data)
            and old.data == n.data
        )

    def write_needle(self, n: Needle, check_cookie: bool = False) -> tuple[int, int]:
        """Append a needle; returns (offset, size). (`volume_write.go:137`)"""
        if self.readonly:
            raise VolumeError(f"volume {self.id} is read only")
        with self._write_lock:
            if check_cookie:
                nv = self.nm.get(n.id)
                if nv is not None and size_is_valid(nv[1]):
                    existing = self._read_at(nv[0], nv[1])
                    if existing.cookie != n.cookie:
                        raise VolumeError("cookie mismatch on overwrite")
            if self._is_unchanged(n):
                return self.nm.get(n.id)[0], n.size
            n.update_append_at_ns(self.last_append_at_ns)
            offset = self._append(n)
            self.last_append_at_ns = n.append_at_ns
            if n.size > 0 or self.version() == 1:
                self.nm.put(n.id, offset, n.size)
            return offset, n.size

    def _append(self, n: Needle) -> int:
        offset = self._size
        if offset % NEEDLE_PADDING_SIZE != 0:
            offset += NEEDLE_PADDING_SIZE - offset % NEEDLE_PADDING_SIZE
        blob = n.to_bytes(self.version())
        self._dat.write_at(blob, offset)
        self._size = offset + len(blob)
        return offset

    def delete_needle(self, n: Needle) -> int:
        """Returns the freed size, 0 if absent (`volume_write.go:216`)."""
        if self.readonly:
            raise VolumeError(f"volume {self.id} is read only")
        with self._write_lock:
            nv = self.nm.get(n.id)
            if nv is None or not size_is_valid(nv[1]):
                return 0
            freed = nv[1]
            n.data = b""
            n.update_append_at_ns(self.last_append_at_ns)
            offset = self._append(n)
            self.last_append_at_ns = n.append_at_ns
            self.nm.delete(n.id, offset)
            return freed

    # --- read path -----------------------------------------------------------
    def _read_at(self, offset: int, size: int) -> Needle:
        total = get_actual_size(size, self.version())
        blob = self._dat.read_at(total, offset)
        if len(blob) < total:
            raise VolumeError(
                f"volume {self.id}: short read {len(blob)} < {total} at {offset}"
            )
        return Needle.from_bytes(blob, size=size, version=self.version())

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        # Reads run lock-free against (nm, dat); commit_compact swaps both
        # under the write lock. When the compaction generation moved
        # mid-read, retry against the now-consistent pair instead of
        # surfacing a 404/500 for a live needle.
        while True:
            gen = self._compact_gen
            if gen & 1:  # seqlock: odd = swap in flight, wait it out
                time.sleep(0.001)
                continue
            try:
                n = self._read_needle_once(needle_id, cookie)
            except NotFound:
                if self._compact_gen == gen:
                    raise  # a real miss, not a swap race
                continue
            except Exception as e:
                if self._compact_gen != gen:
                    continue
                # a real corruption/IO failure (torn .dat, bad CRC) — not
                # a miss: reconstruct from EC redundancy
                n = self._degraded_read(needle_id, cookie, e)
            if self._compact_gen == gen:
                return n

    def _degraded_read(
        self, needle_id: int, cookie: int | None, cause: Exception
    ) -> Needle:
        """Serve a needle whose direct .dat read failed by rebuilding its
        on-disk record from surviving redundancy: the open online-EC
        parity (+ intact .dat columns) when this volume streams EC on
        ingest, else sealed EC shards sitting alongside the .dat. Raises
        the ORIGINAL error when no redundancy can produce a verifying
        record."""
        nv = self.nm.get(needle_id)
        if nv is None or not size_is_valid(nv[1]):
            raise NotFound(f"needle {needle_id:x} not found") from cause
        offset, size = nv
        blob = None
        w = self.online_ec
        if w is not None:
            blob = w.reconstruct_range(
                offset, get_actual_size(size, self.version())
            )
        if blob is None:
            blob = self._reconstruct_from_sealed(offset, size)
        if blob is None:
            raise cause
        try:  # from_bytes CRC-verifies: reconstruction must prove itself
            n = Needle.from_bytes(blob, size=size, version=self.version())
        except Exception:
            raise cause
        if n.id != needle_id:
            raise cause
        self._validate_needle(n, needle_id, cookie)
        return n

    def _reconstruct_from_sealed(self, offset: int, size: int) -> bytes | None:
        """Rebuild a needle record from sealed EC shards sharing this
        volume's base name (post-seal, pre-delete) via the standard
        interval ladder — local shards, then reconstruction through the
        online writer's codec, else one on the volume's device."""
        if not os.path.exists(self.base_name + ".ecx"):
            return None
        from ..ops.rs_kernel import RSCodec
        from .erasure_coding.ec_volume import EcVolume

        w = self.online_ec
        codec = w.codec if w is not None else RSCodec(device=self.device)
        try:
            ev = EcVolume(self.dir, self.collection, self.id, codec=codec)
        except Exception:
            return None
        try:
            return b"".join(
                ev._read_interval(iv)
                for iv in ev.locate_intervals(offset, size)
            )
        except Exception:
            return None
        finally:
            ev.close()

    def _validate_needle(
        self, n: Needle, needle_id: int, cookie: int | None
    ) -> None:
        """Cookie + TTL-expiry validation shared by the direct and
        degraded read paths."""
        if cookie is not None and n.cookie != cookie:
            raise NotFound("cookie mismatch")
        if n.has_ttl() and n.ttl.minutes() > 0 and n.has_last_modified():
            expires = n.last_modified + n.ttl.minutes() * 60
            if expires < time.time():
                raise NotFound("needle expired")

    def _read_needle_once(self, needle_id: int, cookie: int | None) -> Needle:
        nv = self.nm.get(needle_id)
        if nv is None or not size_is_valid(nv[1]):
            raise NotFound(f"needle {needle_id:x} not found")
        n = self._read_at(nv[0], nv[1])
        if n.id != needle_id:  # wrong record at this offset (torn read)
            raise NotFound(f"needle {needle_id:x} not found at offset")
        self._validate_needle(n, needle_id, cookie)
        return n

    def read_needle_blob(self, offset: int, size: int) -> bytes:
        return self._dat.read_at(get_actual_size(size, self.version()), offset)

    # --- vacuum --------------------------------------------------------------
    def compact(self) -> None:
        """Copy live needles to .cpd/.cpx shadow files (`volume_vacuum.go:67`
        Compact2). Writes landing after this snapshot are caught up by
        commit_compact's makeupDiff pass."""
        dst_dat = self.base_name + ".cpd"
        dst_idx = self.base_name + ".cpx"
        with self._write_lock:
            snapshot = list(self.nm.ascending_visit())
            revision = self.super_block.compaction_revision
            # how many .idx entries the snapshot covers, so the commit can
            # replay only what came after
            self._compact_idx_entries = (
                os.path.getsize(self.base_name + ".idx") // 16
            )
        sb = SuperBlock(
            version=self.version(),
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=revision + 1,
        )
        with open(dst_dat, "wb") as out_dat, open(dst_idx, "wb") as out_idx:
            out_dat.write(sb.to_bytes())
            pos = SUPER_BLOCK_SIZE
            for key, offset, size in snapshot:
                blob = self.read_needle_blob(offset, size)
                out_dat.write(blob)
                out_idx.write(idx_mod.entry_to_bytes(key, pos, size))
                pos += len(blob)

    def commit_compact(self) -> None:
        """makeupDiff + atomic swap of shadow files (`volume_vacuum.go:102,200`):
        under the write lock, writes/deletes that landed after the compact
        snapshot are replayed onto the shadow files, then both are renamed in."""
        dst_dat = self.base_name + ".cpd"
        dst_idx = self.base_name + ".cpx"
        if not os.path.exists(dst_dat):
            raise VolumeError("no compacted files to commit")
        with self._write_lock:
            self._makeup_diff(dst_dat, dst_idx)
            # rename, build the NEW handles, flip the references, and only
            # then close the old ones: a reader mid-lookup keeps a
            # consistent (nm, dat) pair
            os.replace(dst_dat, self.base_name + ".dat")
            os.replace(dst_idx, self.base_name + ".idx")
            new_dat = DiskFile(self.base_name + ".dat")
            header = new_dat.read_at(SUPER_BLOCK_SIZE, 0)
            new_nm = CompactNeedleMap(self.base_name + ".idx")
            old_nm, old_dat = self.nm, self._dat
            # seqlock around the reference flips (see read_needle); the
            # finally returns the generation to even even if a flip raises
            self._compact_gen += 1
            try:
                self.super_block = SuperBlock.from_bytes(header)
                self.nm = new_nm
                self._dat = new_dat
                self._size = os.path.getsize(self.base_name + ".dat")
            finally:
                self._compact_gen += 1
            old_nm.close()
            old_dat.close()
            self._digest_cache = None
        # compaction rewrote every .dat offset: any online-EC parity is
        # stale — restart the stripe watermark (counted vacuum_reset)
        if self.online_ec is not None:
            self.online_ec.reset()

    def _makeup_diff(self, dst_dat: str, dst_idx: str) -> None:
        """Replay idx entries appended after the compact snapshot onto the
        shadow files. Caller holds the write lock."""
        start = getattr(self, "_compact_idx_entries", None)
        if start is None:
            return
        with open(self.base_name + ".idx", "rb") as f:
            f.seek(start * 16)
            tail = f.read()
        if not tail:
            return
        with open(dst_dat, "r+b") as out_dat, open(dst_idx, "ab") as out_idx:
            out_dat.seek(0, 2)
            pos = out_dat.tell()
            for key, offset, size in idx_mod.walk_index_blob(tail):
                if offset > 0 and size_is_valid(size):
                    blob = self.read_needle_blob(offset, size)
                    out_dat.write(blob)
                    out_idx.write(idx_mod.entry_to_bytes(key, pos, size))
                    pos += len(blob)
                else:
                    out_idx.write(
                        idx_mod.entry_to_bytes(key, 0, TOMBSTONE_FILE_SIZE)
                    )
        self._compact_idx_entries = None

    def cleanup_compact(self) -> None:
        for ext in (".cpd", ".cpx"):
            p = self.base_name + ext
            if os.path.exists(p):
                os.remove(p)

    # --- incremental backup --------------------------------------------------
    def binary_search_by_append_at_ns(self, since_ns: int) -> int:
        """Offset of the first needle with AppendAtNs > since_ns
        (`volume_backup.go:171`). Scans via the sorted-by-offset entries."""
        entries = sorted(
            ((off, size) for _, off, size in self.nm.ascending_visit()),
            key=lambda x: x[0],
        )
        lo, hi = 0, len(entries)
        version = self.version()
        while lo < hi:
            mid = (lo + hi) // 2
            off, size = entries[mid]
            blob = self._dat.read_at(get_actual_size(size, version), off)
            ts = get_u64(blob, NEEDLE_HEADER_SIZE + size + 4)
            if ts > since_ns:
                hi = mid
            else:
                lo = mid + 1
        return entries[lo][0] if lo < len(entries) else self._size

    def _load_tier_info(self) -> dict | None:
        """Remote-file record from the `.vif`, if this volume is tiered."""
        vif = self.base_name + ".vif"
        if not os.path.exists(vif):
            return None
        try:
            with open(vif) as f:
                info = json.load(f)
        except (OSError, ValueError):
            return None
        files = info.get("files") or []
        return files[0] if files else None

    def destroy(self) -> None:
        # an UNSEALED online-EC volume owns its partial parity shards;
        # a sealed one's shards belong to the EC volume and stay
        drop_parity = (
            self.online_ec is not None and not self.online_ec.sealed
        )
        self.close()
        exts = [".dat", ".idx", ".cpd", ".cpx", ".ecp"]
        if drop_parity:
            exts += [f".ec{i:02d}" for i in range(10, 14)]
        # keep the .vif when EC shards share this base name — the EC volume
        # still needs it after the source volume is deleted
        if not any(
            os.path.exists(self.base_name + f".ec{i:02d}") for i in range(14)
        ) and not os.path.exists(self.base_name + ".ecx"):
            exts.append(".vif")
        for ext in exts:
            p = self.base_name + ext
            if os.path.exists(p):
                os.remove(p)
