"""Maintenance detectors: periodic scans of the master's live topology
that emit typed RepairTasks — the "detect" leg of detect → plan → heal.

The port's copy of `seaweedfs_tpu/maintenance/detectors.py`. Each
detector reads the heartbeat-fed state of the port's `Topology`
(`under_replicated_volumes()`, `ec_missing_shards()`, heartbeat ages,
per-volume deleted-byte counters, scrub findings) and turns a fault into
a `RepairTask` the scheduler can dedup, prioritize and throttle. The
reference runs the same scans inside the master
(`topology_vacuum.go:216`, `command_volume_fix_replication.go`,
`command_ec_rebuild.go`) but as operator verbs; detection here only
*emits* tasks, and pacing lives in scheduler.py. Host code: no device.

Difference from the JAX package: `scan` logs a detector's first failure
through `logging` (the JAX one through its `glog`).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from ..storage.erasure_coding import geometry

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class TaskSpec:
    """One registered maintenance task type. Names key the daemon's
    counters and the scheduler's caps (unique snake_case)."""

    name: str
    priority: int  # default priority, lower = more urgent
    concurrency: int  # per-type in-flight cap
    description: str


# the registry: detectors/executors key on these names
TASK_TYPES: dict[str, TaskSpec] = {
    spec.name: spec
    for spec in (
        TaskSpec("fix_replication", 0, 2,
                 "copy a replica of an under-replicated volume"),
        TaskSpec("ec_rebuild", 1, 1,
                 "rebuild missing RS(10,4) shards through gf256_matmul"),
        TaskSpec("evacuate", 2, 1,
                 "pre-copy replicas off a stale-heartbeat node"),
        TaskSpec("scrub", 2, 1,
                 "repair silent damage a scrub pass or digest"
                 " divergence proved (route per finding kind)"),
        TaskSpec("vacuum", 3, 1,
                 "compact a volume whose deleted-bytes crossed the"
                 " threshold"),
        TaskSpec("balance", 4, 1,
                 "even out volume counts across nodes"),
    )
}


@dataclass(frozen=True)
class RepairTask:
    """One unit of planned repair work. `key` is the dedup identity: the
    scheduler refuses a task whose key is already queued or in flight."""

    type: str
    volume_id: int | None = None
    collection: str = ""
    node: str = ""  # node id the repair primarily loads (per-node limits)
    priority: int = 10
    reason: str = ""
    params: dict = field(default_factory=dict, compare=False, hash=False)

    def __post_init__(self):
        if self.type not in TASK_TYPES:
            raise ValueError(f"unknown maintenance task type {self.type!r}")

    @property
    def key(self) -> tuple:
        # volume-scoped repairs dedup on the volume alone: the holder
        # node recorded for per-node limits follows topology iteration
        # order, and keying on it would let the SAME fault enqueue twice
        # when holders reorder between scans (double-replicating it).
        # Node-scoped tasks (evacuate, balance) dedup on the node.
        if self.volume_id is not None:
            return (self.type, self.volume_id)
        return (self.type, self.node)

    def to_dict(self) -> dict:
        return {
            "type": self.type, "volume_id": self.volume_id,
            "collection": self.collection, "node": self.node,
            "priority": self.priority, "reason": self.reason,
            "params": dict(self.params),
        }


def _task(type_: str, **kw) -> RepairTask:
    kw.setdefault("priority", TASK_TYPES[type_].priority)
    return RepairTask(type=type_, **kw)


def detect_under_replicated(master) -> list[RepairTask]:
    """topology.under_replicated_volumes(). Healthy online-EC
    volumes are parity-only BY DESIGN (the layout already excludes them;
    the explicit filter keeps a heartbeat-ordering race from queueing a
    copy of a volume whose redundancy is its parity shards — only a
    volume that FELL BACK to replication becomes a repair)."""
    online = master.topo.ec_online_volumes()
    tasks = []
    for coll, vid, have, want in master.topo.under_replicated_volumes():
        if vid in online:
            continue
        holders = master.topo.lookup(vid, coll)
        if not holders:
            continue  # nothing left to copy from
        tasks.append(_task(
            "fix_replication", volume_id=vid, collection=coll,
            node=holders[0].id,
            reason=f"{have}/{want} replicas",
            params={"have": have, "want": want},
        ))
    return tasks


def detect_ec_missing_shards(master) -> list[RepairTask]:
    """topology.ec_missing_shards(). Only recoverable volumes (>= 10
    shards survive) become tasks.
    Also scans LIVE online-EC volumes whose holder audits its parity as
    damaged (lost/torn shard vs the durable watermark): those were
    previously skipped as "healthy" because the layout treats
    holder+parity as fully replicated — the executor's online branch
    re-arms the striper and re-encodes from the .dat instead of waiting
    for seal + classic rebuild (the ROADMAP online-rebuild follow-up)."""
    total = geometry.TOTAL_SHARDS_COUNT
    data = geometry.DATA_SHARDS_COUNT
    tasks = []
    for node in master.topo.all_nodes():
        for vid, info in sorted(node.volumes.items()):
            if not info.ec_online or info.ec_online_parity_damaged <= 0:
                continue
            tasks.append(_task(
                "ec_rebuild", volume_id=vid, collection=info.collection,
                node=node.id,
                reason=(f"{info.ec_online_parity_damaged} damaged parity"
                        f" shard(s) on a live online-EC volume"),
                params={"online": True,
                        "damaged": info.ec_online_parity_damaged},
            ))
    for vid, missing in sorted(master.topo.ec_missing_shards().items()):
        present = total - missing
        if present < data:
            continue  # unrecoverable: rebuilding needs 10 of 14
        shard_map = master.topo.lookup_ec_shards(vid) or {}
        holders = sorted({n.id for nodes in shard_map.values() for n in nodes})
        if not holders:
            continue
        # the concrete missing shard ids: the scheduler's lazy-batching
        # fold widens a queued task's target set with these, so co-stripe
        # losses detected across scans coalesce into ONE chain pass
        present_ids = {
            int(s) for s, nodes in shard_map.items() if nodes
        }
        targets = sorted(set(range(total)) - present_ids)
        tasks.append(_task(
            "ec_rebuild", volume_id=vid,
            collection=master.topo.ec_collections.get(vid, ""),
            node=holders[0],
            reason=f"{missing} shard(s) without a live holder",
            params={"missing": missing, "present": present,
                    "targets": targets},
        ))
    return tasks


def detect_vacuum_candidates(master) -> list[RepairTask]:
    """Deleted-bytes share over the master's garbage threshold — the same
    scan the legacy auto-vacuum ran, now emitting schedulable tasks."""
    tasks = []
    seen: set[int] = set()
    threshold = master.garbage_threshold
    for node, vid, ratio in master.topo.vacuum_candidates(threshold):
        if vid in seen:  # one task per volume; the executor hits every holder
            continue
        seen.add(vid)
        tasks.append(_task(
            "vacuum", volume_id=vid, node=node.id,
            reason=f"garbage {ratio:.1%} > {threshold:.0%}",
            params={"garbage_ratio": round(ratio, 4)},
        ))
    return tasks


def detect_imbalance(master, slack: int = 2) -> list[RepairTask]:
    """Volume-count spread across nodes beyond `slack` emits one
    cluster-wide balance task (the executor plans the full move list)."""
    nodes = master.topo.all_nodes()
    if len(nodes) < 2:
        return []
    counts = {n.id: len(n.volumes) for n in nodes}
    lo, hi = min(counts.values()), max(counts.values())
    if hi - lo <= slack:
        return []
    busiest = max(counts, key=lambda k: counts[k])
    return [_task(
        "balance", node=busiest,
        reason=f"volume counts spread {lo}..{hi} (> {slack})",
        params={"min": lo, "max": hi},
    )]


def detect_stale_nodes(master) -> list[RepairTask]:
    """Nodes whose heartbeat is stale (3x pulse — the heartbeat_stale
    alert threshold) but not yet expired (5x pulse) are evacuation
    candidates: pre-copy their replicas from surviving holders before the
    master forgets the node entirely."""
    now = time.time()
    stale_after = 3 * max(master.topo.pulse_seconds, 1)
    tasks = []
    for node in master.topo.all_nodes():
        age = now - node.last_seen
        if age <= stale_after:
            continue
        tasks.append(_task(
            "evacuate", node=node.id,
            reason=f"heartbeat {age:.1f}s stale",
            params={"age": round(age, 1)},
        ))
    return tasks


def detect_scrub_findings(master) -> list[RepairTask]:
    """Heartbeat-reported scrub findings + anti-entropy digest
    divergence -> scrub tasks (the integrity loop's detect leg; the
    scanning itself runs on the volume servers — see scrub.py)."""
    from . import scrub as scrub_mod

    return scrub_mod.detect(master)


# task type -> detector; the daemon iterates this to scan
DETECTORS = {
    "fix_replication": detect_under_replicated,
    "ec_rebuild": detect_ec_missing_shards,
    "scrub": detect_scrub_findings,
    "vacuum": detect_vacuum_candidates,
    "balance": detect_imbalance,
    "evacuate": detect_stale_nodes,
}


_warned_detectors: set[str] = set()


def scan(master, types=None) -> list[RepairTask]:
    """Run the selected detectors (all by default) against the master's
    live topology. A broken detector must not sink the scan, but a
    silently dead repair class is worse — the first failure per detector
    is logged (the alerts push-loop convention)."""
    tasks: list[RepairTask] = []
    for name, fn in DETECTORS.items():
        if types is not None and name not in types:
            continue
        try:
            tasks.extend(fn(master))
            _warned_detectors.discard(name)
        except Exception as e:
            if name not in _warned_detectors:
                _warned_detectors.add(name)
                log.warning(
                    "maintenance detector %s failing (repair class idle"
                    " until it recovers): %s", name, e,
                )
    return tasks
