"""Volume append path: one .dat (+ .idx) pair, written needle by needle.

The port's counterpart of the write half of `seaweedfs_tpu/storage/volume.py`
(`Volume.write_needle`, itself after `weed/storage/volume_write.go:137`):

  - superblock at offset 0 of a new .dat (an existing one is read back);
  - each needle appended 8-byte aligned as its full padded record;
  - one 16-byte .idx entry per needle with data (every needle on v1).

Only the append path is ported so far: no needle map, duplicate-write
suppression, reads, deletes, vacuum or tiering. The files it writes are the
reference's formats, so the JAX package's `Volume` opens them.
"""

from __future__ import annotations

import os
import threading

from . import idx as idx_mod
from .needle import CURRENT_VERSION, Needle
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import NEEDLE_PADDING_SIZE, TTL, ReplicaPlacement


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
    ) -> None:
        self.dir = dir_
        self.collection = collection
        self.id = volume_id
        self.base_name = volume_file_name(dir_, collection, volume_id)
        self._write_lock = threading.Lock()
        self.last_append_at_ns = 0
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
        self._dat_fd = os.open(dat_path, os.O_RDWR)
        try:
            if not is_new:
                self.super_block = SuperBlock.from_bytes(
                    os.pread(self._dat_fd, SUPER_BLOCK_SIZE, 0)
                )
            self._size = os.fstat(self._dat_fd).st_size
            self._idx = open(self.base_name + ".idx", "ab")
        except BaseException:
            os.close(self._dat_fd)
            raise

    def version(self) -> int:
        return self.super_block.version

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        self._idx.close()
        os.close(self._dat_fd)

    def __enter__(self) -> "Volume":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write_needle(self, n: Needle) -> tuple[int, int]:
        """Append a needle; returns (offset, size)."""
        with self._write_lock:
            n.update_append_at_ns(self.last_append_at_ns)
            offset = self._size
            if offset % NEEDLE_PADDING_SIZE != 0:
                offset += NEEDLE_PADDING_SIZE - offset % NEEDLE_PADDING_SIZE
            blob = n.to_bytes(self.version())
            os.pwrite(self._dat_fd, blob, offset)
            self._size = offset + len(blob)
            self.last_append_at_ns = n.append_at_ns
            if n.size > 0 or self.version() == 1:
                self._idx.write(idx_mod.entry_to_bytes(n.id, offset, n.size))
                self._idx.flush()
            return offset, n.size
