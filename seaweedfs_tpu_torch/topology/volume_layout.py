"""VolumeLayout: writable-volume tracking per (collection, rp, ttl)
(reference: `weed/topology/volume_layout.go:108,290`).

The port's copy of `seaweedfs_tpu/topology/volume_layout.py`, whole: the
write pick draws from the module-level `random`."""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

from ..storage.types import ReplicaPlacement

from .node import DataNode, VolumeInfo


class NoWritableVolume(Exception):
    pass


@dataclass
class VolumeLayout:
    replica_placement: ReplicaPlacement
    ttl_u32: int
    volume_size_limit: int = 30 * 1024 * 1024 * 1024
    locations: dict[int, list[DataNode]] = field(default_factory=dict)
    writables: set[int] = field(default_factory=set)
    readonly: set[int] = field(default_factory=set)
    oversized: set[int] = field(default_factory=set)
    # volumes whose heartbeat reports online-EC: durability is parity,
    # not replicas — one live holder is a full complement
    ec_online: set[int] = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def register_volume(self, v: VolumeInfo, node: DataNode) -> None:
        with self._lock:
            locs = self.locations.setdefault(v.id, [])
            if node not in locs:
                locs.append(node)
            if v.read_only:
                self.readonly.add(v.id)
            else:
                self.readonly.discard(v.id)
            if v.ec_online:
                self.ec_online.add(v.id)
            else:
                self.ec_online.discard(v.id)  # fell back to replication
            if v.size >= self.volume_size_limit:
                self.oversized.add(v.id)
            else:
                self.oversized.discard(v.id)  # vacuum shrank it back
            self._refresh_writable(v.id)

    def unregister_volume(self, vid: int, node: DataNode) -> None:
        with self._lock:
            locs = self.locations.get(vid, [])
            if node in locs:
                locs.remove(node)
            if not locs:
                self.locations.pop(vid, None)
                self.writables.discard(vid)
                self.readonly.discard(vid)
                self.oversized.discard(vid)
                self.ec_online.discard(vid)
            else:
                self._refresh_writable(vid)

    def _required_copies(self, vid: int) -> int:
        """Online-EC volumes ack on local durability + parity emit: one
        live holder is a full complement regardless of the placement's
        replica demand (the parity shards are the redundancy)."""
        if vid in self.ec_online:
            return 1
        return self.replica_placement.copy_count()

    def _refresh_writable(self, vid: int) -> None:
        """Writable iff full replica count present, not oversized, not RO
        (`volume_layout.go:enoughCopies`)."""
        locs = self.locations.get(vid, [])
        ok = (
            len(locs) >= self._required_copies(vid)
            and vid not in self.readonly
            and vid not in self.oversized
        )
        if ok:
            self.writables.add(vid)
        else:
            self.writables.discard(vid)

    def pick_for_write(
        self, data_center: str = "",
        shard: tuple[int, int] | None = None,
    ) -> tuple[int, list[DataNode]]:
        """Random writable volume, optionally constrained to a DC
        (`volume_layout.go:290` PickForWrite). `shard=(i, n)` prefers
        vids where vid % n == i — the gateway lease-pool vid-space
        partition. The constraint is SOFT: an empty slice falls back to
        the whole writable set (a small cluster must still assign), so
        it removes contention when volumes are plentiful and costs
        nothing when they are not."""
        with self._lock:
            candidates = list(self.writables)
            if data_center:
                candidates = [
                    vid
                    for vid in candidates
                    if any(
                        n.dc_name() == data_center for n in self.locations[vid]
                    )
                ]
            if shard is not None and shard[1] > 1:
                sliced = [vid for vid in candidates
                          if vid % shard[1] == shard[0]]
                if sliced:
                    candidates = sliced
            if not candidates:
                raise NoWritableVolume(
                    f"no writable volumes (rp={self.replica_placement}, "
                    f"dc={data_center or 'any'})"
                )
            vid = random.choice(candidates)
            return vid, list(self.locations[vid])

    def lookup(self, vid: int) -> list[DataNode]:
        return list(self.locations.get(vid, []))

    def set_oversized_if(self, vid: int, size: int) -> None:
        if size >= self.volume_size_limit:
            with self._lock:
                self.oversized.add(vid)
                self._refresh_writable(vid)

    def under_replicated(self) -> list[tuple[int, int]]:
        """[(vid, live replica count)] for volumes with fewer live replicas
        than the placement demands — the master-side health view that
        `SeaweedFS_master_volumes_underreplicated` and `cluster.check`
        render (`volume_layout.go` enoughCopies, inverted)."""
        with self._lock:
            return sorted(
                (vid, len(locs))
                for vid, locs in self.locations.items()
                if len(locs) < self._required_copies(vid)
            )

    def active_volume_count(self, data_center: str = "") -> int:
        if not data_center:
            return len(self.writables)
        return sum(
            1
            for vid in self.writables
            if any(n.dc_name() == data_center for n in self.locations.get(vid, []))
        )

    def volume_ids(self) -> list[int]:
        return sorted(self.locations)
