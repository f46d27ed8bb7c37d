"""EcVolume: serve reads/deletes from striped shard files.

The port's counterpart of `seaweedfs_tpu/storage/erasure_coding/ec_volume.py`
(after `weed/storage/erasure_coding/ec_volume.go` and the local half of
`weed/storage/store_ec.go`): needle lookup by binary search over the sorted
.ecx, interval math to shard reads, the local -> remote -> reconstruct
ladder of a read (a shard this server lacks comes through the
`shard_fetcher` the volume server attaches; a shard no one serves is
reconstructed, first through the `partial_fetcher`, which moves one
GF-scaled partial per remote holder, then from 10 surviving shards, local
first, then remote, through the codec's kernel: a degraded read), and
deletion via .ecx tombstone + .ecj journal append.

A local shard read passes the `volume.ec.shard.read` fault point: an
injected error there counts as a missing shard, so the read goes remote or
is rebuilt through the codec; `corrupt` flips a byte of what was read.
A reconstructed interval counts
`SeaweedFS_volume_degraded_reads_total{reason="ec_reconstruct"}` and
journals a `degraded_read` event with its shard and route (`partial_fanin`
or `full_decode`); the partial step also keeps plain counters
(`partial_served`, `partial_fallbacks` by reason). All file access uses
positional os.pread/os.pwrite, so concurrent reads and read+delete are
safe.
"""

from __future__ import annotations

import http.client
import os
import threading

import numpy as np

from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.types import (
    NEEDLE_ID_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    put_u32,
    put_u64,
    size_is_deleted,
    size_to_u32,
)
from seaweedfs_tpu_torch.stats import events as events_mod
from seaweedfs_tpu_torch.storage.volume import NotFound, degraded_reads_counter
from seaweedfs_tpu_torch.util import faults

from . import encoder
from .geometry import (
    DATA_SHARDS_COUNT,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS_COUNT,
    Interval,
    locate_data,
    to_ext,
)


_FP_SHARD_READ = faults.register("volume.ec.shard.read")


class NeedleNotFound(NotFound):
    pass


# transport failures of a remote fetch: a refused or dropped connection
# (OSError), a malformed answer (ValueError), a holder that dies
# mid-response (http.client.HTTPException, e.g. IncompleteRead)
TRANSPORT_ERRORS = (OSError, ValueError, http.client.HTTPException)


class PartialDeclined(Exception):
    """A partial fetcher cannot serve this interval; `reason` says why
    (counted into `EcVolume.partial_fallbacks`). The read falls to the
    classic fan-in ladder."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class PartialCodecFailed(RuntimeError):
    """A remote holder's codec failed while scaling its partial: not a
    transport failure, so the read fails instead of falling back."""


def ec_shard_file_name(collection: str, dir_: str, vid: int) -> str:
    base = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(dir_, base)


class EcVolume:
    def __init__(
        self,
        dir_: str,
        collection: str,
        volume_id: int,
        dir_idx: str | None = None,
        codec: RSCodec | None = None,
        large_block_size: int = LARGE_BLOCK_SIZE,
        small_block_size: int = SMALL_BLOCK_SIZE,
    ) -> None:
        self.dir = dir_
        self.dir_idx = dir_idx or dir_
        self.collection = collection
        self.volume_id = volume_id
        self.codec = codec or RSCodec()
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        # optional remote sourcing hooks, set by the server layer:
        # shard_fetcher(shard_id, offset, size) -> bytes | None mirrors the
        # remote half of `store_ec.go` (readRemoteEcShardInterval);
        # partial_fetcher(missing_shard, offset, size) -> bytes reconstructs
        # an interval moving ONE coefficient-scaled partial per remote
        # holder instead of one full range per shard, or raises
        # PartialDeclined with its reason
        self.shard_fetcher = None
        self.partial_fetcher = None
        self.partial_served = 0
        self.partial_fallbacks: dict[str, int] = {}
        self._count_lock = threading.Lock()
        self._closed = False
        self._ecj_lock = threading.Lock()
        self.data_base = ec_shard_file_name(collection, self.dir, volume_id)
        self.index_base = ec_shard_file_name(collection, self.dir_idx, volume_id)
        if not os.path.exists(self.index_base + ".ecx"):
            raise FileNotFoundError(self.index_base + ".ecx")
        self._ecx_fd = os.open(self.index_base + ".ecx", os.O_RDWR)
        self.ecx_file_size = os.path.getsize(self.index_base + ".ecx")
        self.ecj_path = self.index_base + ".ecj"
        if not os.path.exists(self.ecj_path):
            open(self.ecj_path, "wb").close()

        info = encoder.load_volume_info(self.data_base + ".vif")
        self.version = int(info.get("version", 3)) or 3
        if not info:
            encoder.save_volume_info(self.data_base + ".vif", version=self.version)
        # a .vif that records a block geometry is authoritative over the
        # constructor defaults
        if "large_block_size" in info:
            self.large_block_size = int(info["large_block_size"])
        if "small_block_size" in info:
            self.small_block_size = int(info["small_block_size"])

        self.shards: dict[int, int] = {}
        self.shard_size = 0
        for shard_id in range(TOTAL_SHARDS_COUNT):
            p = self.data_base + to_ext(shard_id)
            if os.path.exists(p):
                self.shards[shard_id] = os.open(p, os.O_RDONLY)
                self.shard_size = max(self.shard_size, os.path.getsize(p))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        os.close(self._ecx_fd)
        for fd in self.shards.values():
            os.close(fd)
        self.shards.clear()

    def __enter__(self) -> "EcVolume":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- index ----------------------------------------------------------------
    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """Binary search the sorted .ecx (`ec_volume.go:236-263`).
        Returns (offset, size); raises NeedleNotFound."""
        found, _, offset, size = self._search(needle_id)
        if not found:
            raise NeedleNotFound(f"needle {needle_id:x}")
        return offset, size

    def _search(self, needle_id: int) -> tuple[bool, int, int, int]:
        lo, hi = 0, self.ecx_file_size // NEEDLE_MAP_ENTRY_SIZE
        while lo < hi:
            mid = (lo + hi) // 2
            buf = os.pread(
                self._ecx_fd, NEEDLE_MAP_ENTRY_SIZE, mid * NEEDLE_MAP_ENTRY_SIZE
            )
            key, offset, size = idx_mod.entry_from_bytes(buf)
            if key == needle_id:
                return True, mid, offset, size
            if key < needle_id:
                lo = mid + 1
            else:
                hi = mid
        return False, -1, 0, 0

    # --- reads ------------------------------------------------------------------
    def locate_intervals(self, offset: int, size: int) -> list[Interval]:
        return locate_data(
            self.large_block_size,
            self.small_block_size,
            DATA_SHARDS_COUNT * self.shard_size,
            offset,
            get_actual_size(size, self.version),
        )

    def _pread_shard(self, shard_id: int, off: int, size: int) -> bytes | None:
        """Full-length positional read, or None if the shard can't serve it
        (absent or truncated — both are 'missing' to the erasure code)."""
        try:
            _FP_SHARD_READ.hit(volume=self.volume_id)
        except (faults.FaultInjected, OSError):
            return None  # an injected local failure = a missing shard
        fd = self.shards.get(shard_id)
        if fd is None:
            return None
        data = os.pread(fd, size, off)
        if len(data) != size:
            return None
        # `corrupt` mode: silent bit flip on the shard-read seam — the
        # needle CRC (or the scrubber's parity recompute) must catch it
        return _FP_SHARD_READ.mangle(data, volume=self.volume_id)

    def _fetch_remote(self, shard_id: int, off: int, size: int) -> bytes | None:
        """A shard range from another holder, or None when no holder
        serves it. A transport error counts as no answer: a refused or
        dropped connection (OSError), a malformed answer (ValueError), or
        a holder that dies mid-response (http.client.HTTPException, e.g.
        IncompleteRead or BadStatusLine)."""
        if self.shard_fetcher is None:
            return None
        try:
            data = self.shard_fetcher(shard_id, off, size)
        except TRANSPORT_ERRORS:
            return None
        if data is not None and len(data) != size:
            return None
        return data

    def _read_interval(self, interval: Interval) -> bytes:
        """local shard -> remote shard -> reconstruct, the `store_ec.go`
        readOneEcShardInterval ladder."""
        shard_id, off = interval.to_shard_id_and_offset(
            self.large_block_size, self.small_block_size
        )
        data = self._pread_shard(shard_id, off, interval.size)
        if data is not None:
            return data
        data = self._fetch_remote(shard_id, off, interval.size)
        if data is not None:
            return data
        return self._recover_interval(shard_id, off, interval.size)

    def _recover_interval(self, missing_shard: int, off: int, size: int) -> bytes:
        """Reconstruct one interval from >= 10 surviving shards, local first
        then remote fan-in (`store_ec.go:339-395`
        recoverOneRemoteEcShardInterval). When the server layer attached a
        partial_fetcher, it goes first: one GF-scaled partial per holder
        instead of a full range per shard, byte-identical. It falls to the
        classic ladder below only when the fetcher declines
        (PartialDeclined), fails in transport or answers the wrong length,
        each counted by reason.
        The codec runs on its device; an error there, or a holder's codec
        failure (PartialCodecFailed), propagates to the caller."""
        if self.partial_fetcher is not None:
            data = self._fetch_partial(missing_shard, off, size)
            if data is not None:
                self._count_degraded(missing_shard, "partial_fanin")
                return data
        present: dict[int, np.ndarray] = {}
        for shard_id in self.shards:
            if shard_id == missing_shard:
                continue
            data = self._pread_shard(shard_id, off, size)
            if data is None:
                continue
            present[shard_id] = np.frombuffer(data, dtype=np.uint8)
            if len(present) >= DATA_SHARDS_COUNT:
                break
        if len(present) < DATA_SHARDS_COUNT:
            for shard_id in range(TOTAL_SHARDS_COUNT):
                if shard_id == missing_shard or shard_id in present:
                    continue
                data = self._fetch_remote(shard_id, off, size)
                if data is None:
                    continue
                present[shard_id] = np.frombuffer(data, dtype=np.uint8)
                if len(present) >= DATA_SHARDS_COUNT:
                    break
        if len(present) < DATA_SHARDS_COUNT:
            raise IOError(
                f"cannot recover shard {missing_shard}: only {len(present)} present"
            )
        out = self.codec.reconstruct(present, targets=[missing_shard])
        self._count_degraded(missing_shard, "full_decode")
        return out[missing_shard].tobytes()

    def _count_degraded(self, missing_shard: int, via: str) -> None:
        """Count and journal one sealed-EC reconstruction (a cold path:
        it runs only once a shard read already failed)."""
        degraded_reads_counter().labels("ec_reconstruct").inc()
        events_mod.emit("degraded_read", volume=self.volume_id,
                        reason="ec_reconstruct", shard=missing_shard, via=via,
                        collection=self.collection or "default")

    def _fetch_partial(self, missing_shard: int, off: int, size: int) -> bytes | None:
        try:
            data, reason = self.partial_fetcher(missing_shard, off, size), None
        except PartialDeclined as e:
            data, reason = None, e.reason
        except TRANSPORT_ERRORS:
            data, reason = None, "transport"
        if data is not None and len(data) != size:
            data, reason = None, "length"
        with self._count_lock:
            if data is not None:
                self.partial_served += 1
            else:
                self.partial_fallbacks[reason] = self.partial_fallbacks.get(reason, 0) + 1
        return data

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        offset, size = self.find_needle_from_ecx(needle_id)
        if size_is_deleted(size):
            raise NeedleNotFound(f"needle {needle_id:x} deleted")
        blob = b"".join(
            self._read_interval(iv) for iv in self.locate_intervals(offset, size)
        )
        n = Needle.from_bytes(blob, size=size, version=self.version)
        if cookie is not None and n.cookie != cookie:
            raise NeedleNotFound("cookie mismatch")
        return n

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    # --- deletes ----------------------------------------------------------------
    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in .ecx + append id to .ecj (`ec_volume_delete.go:27-49`)."""
        found, pos, _, _ = self._search(needle_id)
        if not found:
            return
        os.pwrite(
            self._ecx_fd,
            put_u32(size_to_u32(TOMBSTONE_FILE_SIZE)),
            pos * NEEDLE_MAP_ENTRY_SIZE + NEEDLE_ID_SIZE + OFFSET_SIZE,
        )
        with self._ecj_lock:
            with open(self.ecj_path, "ab") as f:
                f.write(put_u64(needle_id))
