"""Store: all volumes + EC shards on one volume server.

The port's copy of `seaweedfs_tpu/storage/store.py` (after
`weed/storage/store.go` + `disk_location.go` + `store_ec.go`, local parts):
disk locations host regular volumes and EC volumes; the store routes
reads/writes/deletes by volume id, tracks readonly state and free space,
and assembles heartbeat messages (plain dicts) for the master.

A store has one device, `cuda` unless the caller passes `device="cpu"`
(with neither nor CUDA, construction raises before any volume is
loaded). Every codec it makes, for an online-EC writer, an EC volume or
a degraded read, runs there. Each volume it opens gets the store's
host:port as its `fault_key`, the spec key of its `volume.write.dat` seam.
Each volume-state change journals a `volume_state` event (created,
deleted, readonly, writable, mounted, unmounted, ec_mounted,
ec_unmounted) and a shard-set refresh a `remount_swap`, as in the JAX
store.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from ..ops.rs_kernel import RSCodec, resolve_device
from ..stats import events as events_mod
from .erasure_coding.ec_volume import EcVolume, ec_shard_file_name
from .needle import Needle
from .types import TTL, ReplicaPlacement
from .volume import NotFound, Volume, VolumeError, volume_file_name


@dataclass
class DiskLocation:
    """One data directory (`weed/storage/disk_location.go:22`)."""

    directory: str
    device: object = None  # the store's resolved device
    fault_key: str | None = None  # the store's host:port, the write seam's key
    max_volume_count: int = 0  # 0 = unlimited (auto)
    min_free_space_bytes: int = 0
    volumes: dict[int, Volume] = field(default_factory=dict)
    ec_volumes: dict[int, EcVolume] = field(default_factory=dict)

    def load_existing_volumes(self) -> None:
        """Scan the directory for .dat/.idx pairs and .ecx files
        (`disk_location.go:188` loads concurrently; sequential is fine here).
        A volume whose .vif carries an unsealed `ec_online` policy gets its
        OnlineEcWriter re-attached, which replays the partial-stripe
        journal (crash recovery: re-encode from the durable watermark)."""
        if not os.path.isdir(self.directory):
            os.makedirs(self.directory, exist_ok=True)
            return
        for name in sorted(os.listdir(self.directory)):
            base, ext = os.path.splitext(name)
            if ext == ".dat":
                collection, vid = _parse_base(base)
                if vid is None or vid in self.volumes:
                    continue
                try:
                    v = Volume(self.directory, collection, vid,
                               device=self.device)
                except Exception:
                    continue  # unloadable volume: skip, like the reference logs+skips
                v.fault_key = self.fault_key
                try:
                    _attach_online_ec(v)
                except Exception:
                    pass  # degraded to classic; heartbeat stops advertising
                self.volumes[vid] = v
            elif ext == ".ecx":
                collection, vid = _parse_base(base)
                if vid is None or vid in self.ec_volumes:
                    continue
                try:
                    self.ec_volumes[vid] = EcVolume(
                        self.directory, collection, vid,
                        codec=RSCodec(device=self.device))
                except Exception:
                    continue

    def is_disk_space_low(self) -> bool:
        if self.min_free_space_bytes <= 0:
            return False
        st = os.statvfs(self.directory)
        return st.f_bavail * st.f_frsize < self.min_free_space_bytes


def _attach_online_ec(v: Volume, block_size: int | None = None,
                      create: bool = False) -> None:
    """(Re)attach the online-EC stripe writer when the volume's .vif
    records an unsealed ec_online policy — or force-create one for a
    freshly-allocated volume (`create=True`). The writer's codec runs on
    the volume's device."""
    from .erasure_coding.online import OnlineEcWriter, online_info

    if v.online_ec is not None or v.readonly:
        return
    if not create:
        oe = online_info(v.base_name)
        if oe is None or oe.get("sealed"):
            return
        block_size = block_size or oe.get("block_size")
    v.online_ec = OnlineEcWriter(v, block_size=block_size, device=v.device)


def _parse_base(base: str) -> tuple[str, int | None]:
    if "_" in base:
        collection, _, vid_s = base.rpartition("_")
    else:
        collection, vid_s = "", base
    try:
        return collection, int(vid_s)
    except ValueError:
        return "", None


class Store:
    def __init__(
        self,
        directories: list[str],
        ip: str = "localhost",
        port: int = 8080,
        public_url: str = "",
        min_free_space_bytes: int = 0,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.locations = [
            DiskLocation(d, device=self.device, fault_key=f"{ip}:{port}",
                         min_free_space_bytes=min_free_space_bytes)
            for d in directories
        ]
        self._lock = threading.Lock()
        for loc in self.locations:
            loc.load_existing_volumes()

    # --- lookup ---------------------------------------------------------------
    def get_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def get_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            v = loc.ec_volumes.get(vid)
            if v is not None:
                return v
        return None

    def has_volume(self, vid: int) -> bool:
        return self.get_volume(vid) is not None

    def volume_ids(self) -> list[int]:
        out: list[int] = []
        for loc in self.locations:
            out.extend(loc.volumes)
        return sorted(out)

    # --- volume lifecycle -----------------------------------------------------
    def add_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        ttl: str = "",
        ec_online: bool = False,
        ec_online_block: int | None = None,
    ) -> Volume:
        with self._lock:
            if self.has_volume(vid):
                raise VolumeError(f"volume {vid} already exists")
            loc = self._pick_location()
            v = Volume(
                loc.directory,
                collection,
                vid,
                replica_placement=ReplicaPlacement.parse(replica_placement),
                ttl=TTL.parse(ttl),
                device=self.device,
            )
            v.fault_key = loc.fault_key
            if ec_online:
                try:
                    _attach_online_ec(v, block_size=ec_online_block,
                                      create=True)
                except BaseException:
                    v.close()
                    raise
            loc.volumes[vid] = v
        events_mod.emit("volume_state", volume=vid, state="created",
                        collection=collection, ec_online=bool(ec_online))
        return v

    def _pick_location(self) -> DiskLocation:
        candidates = [l for l in self.locations if not l.is_disk_space_low()]
        if not candidates:
            raise VolumeError("all disk locations are low on space")
        return min(candidates, key=lambda l: len(l.volumes))

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.destroy()
                    events_mod.emit("volume_state", volume=vid,
                                    state="deleted")
                    return
        raise VolumeError(f"volume {vid} not found")

    def mark_readonly(self, vid: int, readonly: bool = True) -> None:
        v = self.get_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        v.readonly = readonly
        events_mod.emit("volume_state", volume=vid,
                        state="readonly" if readonly else "writable")

    # --- data ops -------------------------------------------------------------
    def write(self, vid: int, n: Needle, check_cookie: bool = False) -> tuple[int, int]:
        v = self.get_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        return v.write_needle(n, check_cookie=check_cookie)

    def read(self, vid: int, needle_id: int, cookie: int | None = None) -> Needle:
        v = self.get_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie=cookie)
        ev = self.get_ec_volume(vid)
        if ev is not None:
            return ev.read_needle(needle_id, cookie=cookie)
        raise NotFound(f"volume {vid} not found")

    def delete(self, vid: int, n: Needle) -> int:
        v = self.get_volume(vid)
        if v is None:
            ev = self.get_ec_volume(vid)
            if ev is not None:
                ev.delete_needle(n.id)
                return 0
            raise VolumeError(f"volume {vid} not found")
        return v.delete_needle(n)

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        """Load an existing .dat/.idx pair that arrived out-of-band (volume
        copy) into the store (`volume_grpc_admin.go VolumeMount`)."""
        with self._lock:
            if self.has_volume(vid):
                raise VolumeError(f"volume {vid} already mounted")
            for loc in self.locations:
                if os.path.exists(
                    volume_file_name(loc.directory, collection, vid) + ".dat"
                ):
                    v = Volume(loc.directory, collection, vid,
                               device=self.device)
                    v.fault_key = loc.fault_key
                    loc.volumes[vid] = v
                    events_mod.emit("volume_state", volume=vid,
                                    state="mounted", collection=collection)
                    return v
        raise VolumeError(f"no local .dat for volume {vid}")

    def unmount_volume(self, vid: int) -> None:
        """Close + forget, keeping files on disk (`VolumeUnmount`)."""
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    events_mod.emit("volume_state", volume=vid,
                                    state="unmounted")
                    return
        raise VolumeError(f"volume {vid} not found")

    # --- EC shard hosting -----------------------------------------------------
    def mount_ec_volume(self, vid: int, collection: str = "") -> EcVolume:
        for loc in self.locations:
            base = ec_shard_file_name(collection, loc.directory, vid)
            if os.path.exists(base + ".ecx"):
                ev = EcVolume(loc.directory, collection, vid,
                              codec=RSCodec(device=self.device))
                loc.ec_volumes[vid] = ev
                events_mod.emit("volume_state", volume=vid,
                                state="ec_mounted", shards=ev.shard_ids())
                return ev
        raise VolumeError(f"no local .ecx for ec volume {vid}")

    def unmount_ec_volume(self, vid: int) -> None:
        for loc in self.locations:
            ev = loc.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.close()
                events_mod.emit("volume_state", volume=vid,
                                state="ec_unmounted")
                return

    def remount_ec_volume(
        self, vid: int, collection: str = "", grace: float = 2.0
    ) -> EcVolume | None:
        """Atomic shard-set refresh (rebuild commit, shard delete/copy):
        the NEW EcVolume is built while the old keeps serving, swapped in
        under the lock, and the old instance closed only after `grace`
        seconds — an in-flight positional read on the old fds finishes
        instead of 500ing on EBADF (the commit_compact seqlock lesson,
        applied to shard remounts; close() is idempotent so shutdown can
        race the timer). Returns None (and unmounts) when no .ecx
        remains."""
        with self._lock:
            old_loc, old = None, None
            for loc in self.locations:
                if vid in loc.ec_volumes:
                    old_loc, old = loc, loc.ec_volumes[vid]
                    break
            new = None
            for loc in self.locations:
                base = ec_shard_file_name(collection, loc.directory, vid)
                if os.path.exists(base + ".ecx"):
                    new = EcVolume(loc.directory, collection, vid,
                                   codec=RSCodec(device=self.device))
                    if old_loc is not None and loc is not old_loc:
                        old_loc.ec_volumes.pop(vid, None)
                    loc.ec_volumes[vid] = new
                    break
            if new is None and old_loc is not None:
                old_loc.ec_volumes.pop(vid, None)
        events_mod.emit("remount_swap", volume=vid,
                        shards=new.shard_ids() if new is not None else [],
                        had_old=old is not None)
        if old is not None:
            if grace > 0:
                t = threading.Timer(grace, old.close)
                t.daemon = True
                t.start()
            else:
                old.close()
        return new

    # --- heartbeat ------------------------------------------------------------
    def collect_heartbeat(self) -> dict:
        """Message shape mirrors master_pb.Heartbeat (`store.go:249`). It
        walks snapshots of each location's volume maps: a handler that adds
        or drops a volume while the pulse collects must not end the beat
        (iterating the live dict raised "dictionary changed size")."""
        volumes = []
        max_file_key = 0
        for loc in self.locations:
            for v in list(loc.volumes.values()):
                max_file_key = max(max_file_key, v.max_needle_id())
                volumes.append(
                    {
                        "id": v.id,
                        "collection": v.collection,
                        "size": v.size(),
                        "file_count": v.file_count(),
                        "delete_count": v.deleted_count(),
                        "deleted_byte_count": v.deleted_bytes(),
                        "read_only": v.readonly,
                        "replica_placement": v.super_block.replica_placement.to_byte(),
                        "ttl": v.super_block.ttl.to_u32(),
                        "version": v.version(),
                        # parity-only durability: the master's layout and
                        # the maintenance detectors must not flag this
                        # volume as under-replicated while it holds
                        "ec_online": bool(
                            v.online_ec is not None and v.online_ec.active
                        ),
                        # missing/torn parity shards audited against the
                        # durable watermark — a LIVE online volume whose
                        # parity was lost must surface as repairable
                        # (detect_ec_missing_shards' online branch), not
                        # read as healthy until seal time
                        "ec_online_parity_damaged": (
                            v.online_ec.parity_health()
                            if v.online_ec is not None else 0
                        ),
                        # anti-entropy fingerprint: the master compares
                        # replica digests to detect silent divergence
                        # (cached per (size, counts) so idle beats are
                        # free)
                        "needle_digest": v.needle_map_digest(),
                    }
                )
        ec_shards = []
        for loc in self.locations:
            for ev in list(loc.ec_volumes.values()):
                ec_shards.append(
                    {
                        "id": ev.volume_id,
                        "collection": ev.collection,
                        "ec_index_bits": sum(1 << s for s in ev.shard_ids()),
                    }
                )
        return {
            "ip": self.ip,
            "port": self.port,
            "public_url": self.public_url,
            "max_file_key": max_file_key,
            "max_volume_count": sum(
                loc.max_volume_count or 100 for loc in self.locations
            ),
            "volumes": volumes,
            "ec_shards": ec_shards,
        }

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
