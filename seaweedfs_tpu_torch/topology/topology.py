"""Topology: the master's cluster state machine (reference:
`weed/topology/topology.go:29-300`, `topology_event_handling.go`).

The port's copy of `seaweedfs_tpu/topology/topology.py`, whole. Fed by
volume-server heartbeats; answers assign/lookup; grows volumes when a
layout runs out of writable space; expires dead nodes. The write pick's
cookie and the growth's placement draw from the module-level `random`.
"""

from __future__ import annotations

import random
import threading
import time

from ..storage.erasure_coding import geometry
from ..storage.file_id import format_needle_id_cookie
from ..storage.types import TTL, ReplicaPlacement

from .node import DataCenter, DataNode, EcShardInfo, VolumeInfo
from .sequence import MemorySequencer
from .volume_growth import find_empty_slots, targets_per_growth
from .volume_layout import NoWritableVolume, VolumeLayout


class Topology:
    def __init__(
        self,
        volume_size_limit: int = 30 * 1024 * 1024 * 1024,
        pulse_seconds: int = 5,
        sequencer: MemorySequencer | None = None,
    ) -> None:
        self.data_centers: dict[str, DataCenter] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.sequencer = sequencer or MemorySequencer()
        self._layouts: dict[tuple[str, int, int], VolumeLayout] = {}
        self._max_volume_id = 0
        self.vid_allocator = None  # raft propose hook (set by MasterServer)
        self._lock = threading.Lock()
        # ec shard map: vid -> {shard_id -> [DataNode]}
        self.ec_shards: dict[int, dict[int, list[DataNode]]] = {}
        self.ec_collections: dict[int, str] = {}

    # --- structure ------------------------------------------------------------
    def get_or_create_dc(self, name: str) -> DataCenter:
        with self._lock:
            dc = self.data_centers.get(name)
            if dc is None:
                dc = DataCenter(name=name)
                self.data_centers[name] = dc
            return dc

    def layout(
        self, collection: str, rp: ReplicaPlacement, ttl_u32: int = 0
    ) -> VolumeLayout:
        key = (collection, rp.to_byte(), ttl_u32)
        with self._lock:
            lo = self._layouts.get(key)
            if lo is None:
                lo = VolumeLayout(
                    replica_placement=rp,
                    ttl_u32=ttl_u32,
                    volume_size_limit=self.volume_size_limit,
                )
                self._layouts[key] = lo
            return lo

    def all_nodes(self) -> list[DataNode]:
        out = []
        for dc in self.data_centers.values():
            for rack in dc.racks.values():
                out.extend(rack.nodes.values())
        return out

    def find_node(self, node_id: str) -> DataNode | None:
        for n in self.all_nodes():
            if n.id == node_id:
                return n
        return None

    # --- heartbeats -----------------------------------------------------------
    def sync_heartbeat(
        self,
        hb: dict,
        dc_name: str = "DefaultDataCenter",
        rack_name: str = "DefaultRack",
    ) -> DataNode:
        """Full-state heartbeat ingest (`master_grpc_server.go:62` SendHeartbeat
        — incremental deltas can layer on later; full sync is idempotent)."""
        dc = self.get_or_create_dc(hb.get("data_center") or dc_name)
        rack = dc.get_or_create_rack(hb.get("rack") or rack_name)
        node = rack.get_or_create_node(
            hb["ip"],
            int(hb["port"]),
            hb.get("public_url", ""),
            int(hb.get("max_volume_count", 100)),
        )
        node.last_seen = time.time()
        node.max_file_key = int(hb.get("max_file_key", 0))
        node.scrub_findings = list(hb.get("scrub_findings", []))
        node.scrub_active = {int(v) for v in hb.get("scrub_active", [])}
        self.sequencer.set_max(node.max_file_key)

        new_volumes = {int(v["id"]): VolumeInfo.from_dict(v) for v in hb.get("volumes", [])}
        # unregister volumes that disappeared
        for vid in list(node.volumes):
            if vid not in new_volumes:
                self._unregister_volume(node.volumes[vid], node)
        for vid, info in new_volumes.items():
            self._register_volume(info, node)
        node.volumes = new_volumes

        # ec shards
        new_ec = {
            int(s["id"]): EcShardInfo(
                id=int(s["id"]),
                collection=s.get("collection", ""),
                ec_index_bits=int(s.get("ec_index_bits", 0)),
            )
            for s in hb.get("ec_shards", [])
        }
        for vid in list(node.ec_shards):
            if vid not in new_ec:
                self._unregister_ec(vid, node)
        for vid, info in new_ec.items():
            # unregister-then-register: a node reporting the SAME ec volume
            # with FEWER shards (partial shard loss/move) must drop out of
            # the shard ids it no longer holds, or ec_missing_shards() keeps
            # counting the stale holder and the loss stays invisible
            if vid in node.ec_shards:
                self._unregister_ec(vid, node)
            self._register_ec(info, node)
        node.ec_shards = new_ec
        return node

    def _register_volume(self, v: VolumeInfo, node: DataNode) -> None:
        with self._lock:
            self._max_volume_id = max(self._max_volume_id, v.id)
        rp = ReplicaPlacement.from_byte(v.replica_placement)
        self.layout(v.collection, rp, v.ttl).register_volume(v, node)

    def _unregister_volume(self, v: VolumeInfo, node: DataNode) -> None:
        rp = ReplicaPlacement.from_byte(v.replica_placement)
        self.layout(v.collection, rp, v.ttl).unregister_volume(v.id, node)

    def _register_ec(self, info: EcShardInfo, node: DataNode) -> None:
        with self._lock:
            shard_map = self.ec_shards.setdefault(info.id, {})
            self.ec_collections[info.id] = info.collection
            for sid in info.shard_ids():
                nodes = shard_map.setdefault(sid, [])
                if node not in nodes:
                    nodes.append(node)

    def _unregister_ec(self, vid: int, node: DataNode) -> None:
        with self._lock:
            shard_map = self.ec_shards.get(vid, {})
            for sid in list(shard_map):
                if node in shard_map[sid]:
                    shard_map[sid].remove(node)
                if not shard_map[sid]:
                    del shard_map[sid]
            if not shard_map:
                self.ec_shards.pop(vid, None)
                self.ec_collections.pop(vid, None)

    def expire_dead_nodes(self, timeout_factor: float = 5.0) -> list[DataNode]:
        """Drop nodes silent for timeout_factor x pulse
        (`topology_event_handling.go`)."""
        cutoff = time.time() - timeout_factor * self.pulse_seconds
        dead = []
        for dc in self.data_centers.values():
            for rack in dc.racks.values():
                for key in list(rack.nodes):
                    node = rack.nodes[key]
                    if node.last_seen < cutoff:
                        for v in node.volumes.values():
                            self._unregister_volume(v, node)
                        for vid in list(node.ec_shards):
                            self._unregister_ec(vid, node)
                        del rack.nodes[key]
                        dead.append(node)
        return dead

    # --- assign / lookup --------------------------------------------------------
    def next_volume_id(self) -> int:
        # under raft the id allocation is a replicated command so every
        # master agrees (`master_grpc_server_raft.go`); vid_allocator is the
        # leader's propose hook, and the raft apply path calls
        # _next_volume_id_raw on every node
        if self.vid_allocator is not None:
            vid = self.vid_allocator()
            with self._lock:
                self._max_volume_id = max(self._max_volume_id, vid)
            return vid
        return self._next_volume_id_raw()

    def _next_volume_id_raw(self) -> int:
        with self._lock:
            self._max_volume_id += 1
            return self._max_volume_id

    def pick_for_write(
        self,
        count: int = 1,
        replication: str = "000",
        ttl: str = "",
        collection: str = "",
        data_center: str = "",
        shard: tuple[int, int] | None = None,
    ) -> tuple[str, int, list[DataNode]]:
        """-> (fid, count, replica locations) (`topology.go:248` PickForWrite).
        `shard=(i, n)` soft-constrains the pick to vids in a gateway's
        lease slice (vid % n == i) — see VolumeLayout.pick_for_write."""
        rp = ReplicaPlacement.parse(replication)
        ttl_u32 = TTL.parse(ttl).to_u32()
        lo = self.layout(collection, rp, ttl_u32)
        # no auto-grow here: growth requires contacting volume servers, which
        # is the master server's job (`MasterServer._grow_volumes`)
        vid, nodes = lo.pick_for_write(data_center, shard=shard)
        key = self.sequencer.next_file_id(count)
        cookie = random.randint(0, 0xFFFFFFFF)
        fid = f"{vid},{format_needle_id_cookie(key, cookie)}"
        return fid, count, nodes

    def grow(
        self,
        collection: str,
        rp: ReplicaPlacement,
        ttl_u32: int,
        data_center: str = "",
        target_count: int | None = None,
    ) -> list[tuple[int, list[DataNode]]]:
        """Allocate new volumes on picked servers (`volume_growth.go:243`).
        Returns [(vid, nodes)] — the caller (master server) instructs the
        volume servers to actually create them."""
        n = target_count or targets_per_growth(rp)
        grown = []
        for _ in range(n):
            try:
                nodes = find_empty_slots(self.data_centers, rp, data_center)
            except Exception:
                break
            vid = self.next_volume_id()
            grown.append((vid, nodes))
        if not grown:
            raise NoWritableVolume(
                f"failed to grow any volume for rp={rp} dc={data_center or 'any'}"
            )
        return grown

    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        for (coll, _, _), lo in list(self._layouts.items()):
            if collection and coll != collection:
                continue
            nodes = lo.lookup(vid)
            if nodes:
                return nodes
        # EC volumes: any node holding any shard can serve reads
        shard_map = self.ec_shards.get(vid)
        if shard_map:
            seen: list[DataNode] = []
            for nodes in shard_map.values():
                for n in nodes:
                    if n not in seen:
                        seen.append(n)
            return seen
        return []

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]] | None:
        return self.ec_shards.get(vid)

    # --- stats -----------------------------------------------------------------
    def under_replicated_volumes(self) -> list[tuple[str, int, int, int]]:
        """[(collection, vid, have, want)] across every layout — volumes
        whose live replica count is below their placement's demand."""
        with self._lock:
            layouts = list(self._layouts.items())
        out = []
        for (coll, _, _), lo in layouts:
            want = lo.replica_placement.copy_count()
            for vid, have in lo.under_replicated():
                out.append((coll, vid, have, want))
        return sorted(out, key=lambda t: (t[0], t[1]))

    def vacuum_candidates(
        self, garbage_threshold: float
    ) -> list[tuple[DataNode, int, float]]:
        """[(node, vid, garbage_ratio)] for writable, non-empty volumes whose
        deleted-bytes share crosses the threshold — the master's vacuum scan
        and the maintenance vacuum detector share this one view
        (`topology_vacuum.go:216` scanning semantics)."""
        out = []
        for node in self.all_nodes():
            held = getattr(node, "scrub_active", ())
            for vid, info in list(node.volumes.items()):
                if info.size == 0 or info.read_only:
                    continue
                if vid in held:
                    # a scrub pass holds this volume: compacting now
                    # would swap (nm, dat) under the scanner — wasting
                    # the pass at best, fabricating suspects at worst.
                    # The pass moves on within a beat or two; the
                    # garbage is still there next scan.
                    continue
                if info.ec_online:
                    # compaction rewrites every .dat offset and discards
                    # the streamed parity (vacuum_reset); online volumes
                    # reclaim garbage at seal time instead
                    continue
                ratio = info.deleted_byte_count / max(info.size, 1)
                if ratio > garbage_threshold:
                    out.append((node, vid, ratio))
        return out

    def ec_online_volumes(self) -> set[int]:
        """Volume ids whose latest heartbeat reports online-EC mode —
        parity-only durability by design, never an under-replication
        fault (maintenance detectors consult this)."""
        out: set[int] = set()
        with self._lock:
            layouts = list(self._layouts.values())
        for lo in layouts:
            with lo._lock:  # heartbeats mutate the set concurrently
                out |= lo.ec_online
        return out

    def ec_missing_shards(self) -> dict[int, int]:
        """vid -> number of EC shards with NO live holder."""
        total = geometry.TOTAL_SHARDS_COUNT
        with self._lock:
            shard_maps = {
                vid: sum(1 for nodes in sm.values() if nodes)
                for vid, sm in self.ec_shards.items()
            }
        return {
            vid: total - present
            for vid, present in shard_maps.items()
            if present < total
        }

    def to_dict(self) -> dict:
        return {
            "max_volume_id": self._max_volume_id,
            "data_centers": [
                {
                    "name": dc.name,
                    "racks": [
                        {
                            "name": rack.name,
                            "nodes": [
                                {
                                    "id": n.id,
                                    "url": n.url,
                                    "volumes": len(n.volumes),
                                    "ec_volumes": len(n.ec_shards),
                                    "max_volume_count": n.max_volume_count,
                                    "volume_infos": [
                                        {
                                            "id": v.id,
                                            "collection": v.collection,
                                            "size": v.size,
                                            "file_count": v.file_count,
                                            "delete_count": v.delete_count,
                                            "garbage": v.deleted_byte_count,
                                            "read_only": v.read_only,
                                            "replica_placement": v.replica_placement,
                                            "ttl": v.ttl,
                                            "ec_online": v.ec_online,
                                            "ec_online_parity_damaged":
                                                v.ec_online_parity_damaged,
                                            "needle_digest": v.needle_digest,
                                        }
                                        for v in n.volumes.values()
                                    ],
                                    "ec_shard_infos": [
                                        {
                                            "id": s.id,
                                            "collection": s.collection,
                                            "shards": s.shard_ids(),
                                        }
                                        for s in n.ec_shards.values()
                                    ],
                                }
                                for n in rack.nodes.values()
                            ],
                        }
                        for rack in dc.racks.values()
                    ],
                }
                for dc in self.data_centers.values()
            ],
        }
