"""Topology tree nodes (reference: `weed/topology/node.go`, `data_node.go`,
`rack.go`, `data_center.go`).

The port's copy of `seaweedfs_tpu/topology/node.py`, whole."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class VolumeInfo:
    """Master's view of one volume replica (master_pb VolumeInformationMessage)."""

    id: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: int = 0
    ttl: int = 0
    version: int = 3
    # volume streams its appends through the online RS encoder: its
    # durability is local-dat + parity shards, not replica fan-out
    ec_online: bool = False
    # missing-or-torn parity shards the holder audited against its
    # durable watermark — >0 means this LIVE online volume's redundancy
    # is damaged and an online ec_rebuild (re-arm + re-encode) is due
    ec_online_parity_damaged: int = 0
    # order-independent live-needle-set digest (anti-entropy): replica
    # holders reporting different digests for one volume have silently
    # diverged — the scrub detector re-syncs from the majority holder
    needle_digest: str = ""
    # cumulative native-op counters carried on the beat: the
    # master's heat rollup differentiates consecutive beats into
    # per-collection/per-node access rates
    read_ops: int = 0
    write_ops: int = 0
    read_bytes: int = 0
    write_bytes: int = 0

    @staticmethod
    def from_dict(d: dict) -> "VolumeInfo":
        return VolumeInfo(
            id=int(d["id"]),
            collection=d.get("collection", ""),
            size=int(d.get("size", 0)),
            file_count=int(d.get("file_count", 0)),
            delete_count=int(d.get("delete_count", 0)),
            deleted_byte_count=int(d.get("deleted_byte_count", 0)),
            read_only=bool(d.get("read_only", False)),
            replica_placement=int(d.get("replica_placement", 0)),
            ttl=int(d.get("ttl", 0)),
            version=int(d.get("version", 3)),
            ec_online=bool(d.get("ec_online", False)),
            ec_online_parity_damaged=int(
                d.get("ec_online_parity_damaged", 0)
            ),
            needle_digest=str(d.get("needle_digest", "")),
            read_ops=int(d.get("read_ops", 0)),
            write_ops=int(d.get("write_ops", 0)),
            read_bytes=int(d.get("read_bytes", 0)),
            write_bytes=int(d.get("write_bytes", 0)),
        )


@dataclass
class EcShardInfo:
    id: int
    collection: str = ""
    ec_index_bits: int = 0

    def shard_ids(self) -> list[int]:
        return [i for i in range(14) if self.ec_index_bits & (1 << i)]


@dataclass
class DataNode:
    ip: str
    port: int
    public_url: str = ""
    max_volume_count: int = 100
    rack: "Rack | None" = None
    volumes: dict[int, VolumeInfo] = field(default_factory=dict)
    ec_shards: dict[int, EcShardInfo] = field(default_factory=dict)
    last_seen: float = field(default_factory=time.time)
    max_file_key: int = 0
    # unresolved scrub findings the node's last heartbeat carried
    # (maintenance/scrub.py detect() turns them into repair tasks)
    scrub_findings: list = field(default_factory=list)
    # volumes a scrub pass on this node holds right now: vacuum defers
    # their compaction (heartbeat-fed, maintenance/scrub.py)
    scrub_active: set = field(default_factory=set)

    @property
    def id(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def url(self) -> str:
        return self.public_url or self.id

    def free_slots(self) -> int:
        ec_slots = sum(
            (len(s.shard_ids()) + 13) // 14 for s in self.ec_shards.values()
        )
        return self.max_volume_count - len(self.volumes) - ec_slots

    def dc_name(self) -> str:
        return self.rack.data_center.name if self.rack else ""

    def rack_name(self) -> str:
        return self.rack.name if self.rack else ""


@dataclass
class Rack:
    name: str
    data_center: "DataCenter"
    nodes: dict[str, DataNode] = field(default_factory=dict)

    def get_or_create_node(
        self, ip: str, port: int, public_url: str = "", max_volume_count: int = 100
    ) -> DataNode:
        key = f"{ip}:{port}"
        node = self.nodes.get(key)
        if node is None:
            node = DataNode(
                ip=ip, port=port, public_url=public_url,
                max_volume_count=max_volume_count, rack=self,
            )
            self.nodes[key] = node
        node.public_url = public_url or node.public_url
        if max_volume_count:
            node.max_volume_count = max_volume_count
        return node

    def free_slots(self) -> int:
        return sum(n.free_slots() for n in self.nodes.values())


@dataclass
class DataCenter:
    name: str
    racks: dict[str, Rack] = field(default_factory=dict)

    def get_or_create_rack(self, name: str) -> Rack:
        rack = self.racks.get(name)
        if rack is None:
            rack = Rack(name=name, data_center=self)
            self.racks[name] = rack
        return rack

    def free_slots(self) -> int:
        return sum(r.free_slots() for r in self.racks.values())
