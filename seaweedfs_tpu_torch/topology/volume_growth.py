"""Replica-placement-aware volume growth (reference:
`weed/topology/volume_growth.go:42-300`).

Given an xyz replica placement, pick servers for one new volume's replicas:
a main DC with rp.diff_rack+1 eligible racks, a main rack with
rp.same_rack+1 eligible nodes, plus "other" racks/DCs — every picked node
needs a free slot. Randomized among eligible candidates (the reference
weights by free space; uniform random keeps the same invariants).

The port's copy of `seaweedfs_tpu/topology/volume_growth.py`, whole."""

from __future__ import annotations

import random

from ..storage.types import ReplicaPlacement

from .node import DataCenter, DataNode, Rack


class NoFreeSpace(Exception):
    pass


def find_empty_slots(
    data_centers: dict[str, DataCenter],
    rp: ReplicaPlacement,
    preferred_dc: str = "",
    rng: random.Random | None = None,
) -> list[DataNode]:
    """Nodes for one volume's rp.copy_count() replicas
    (`volume_growth.go:145` findEmptySlotsForOneVolume)."""
    rng = rng or random
    # main DC: needs rp.diff_rack_count+1 racks with capacity, plus
    # rp.diff_data_center_count other DCs with >= 1 slot
    main_dc_candidates = []
    for dc in data_centers.values():
        if preferred_dc and dc.name != preferred_dc:
            continue
        eligible_racks = [
            r for r in dc.racks.values() if _rack_eligible(r, rp)
        ]
        if len(eligible_racks) >= rp.diff_rack_count + 1:
            main_dc_candidates.append((dc, eligible_racks))
    if not main_dc_candidates:
        raise NoFreeSpace(
            f"no data center can host rp={rp} (preferred={preferred_dc or 'any'})"
        )
    other_dcs_needed = rp.diff_data_center_count
    for dc, eligible_racks in rng.sample(
        main_dc_candidates, len(main_dc_candidates)
    ):
        others = [
            d for d in data_centers.values()
            if d.name != dc.name and d.free_slots() >= 1
        ]
        if len(others) < other_dcs_needed:
            continue
        try:
            return _pick_in_dc(dc, eligible_racks, rp, rng) + [
                _pick_any_node(d, rng) for d in rng.sample(others, other_dcs_needed)
            ]
        except NoFreeSpace:
            continue
    raise NoFreeSpace(f"not enough data centers for rp={rp}")


def _rack_eligible(rack: Rack, rp: ReplicaPlacement) -> bool:
    nodes = [n for n in rack.nodes.values() if n.free_slots() >= 1]
    return len(nodes) >= rp.same_rack_count + 1


def _pick_in_dc(
    dc: DataCenter, eligible_racks: list[Rack], rp: ReplicaPlacement, rng
) -> list[DataNode]:
    for main_rack in rng.sample(eligible_racks, len(eligible_racks)):
        other_racks = [
            r for r in dc.racks.values()
            if r.name != main_rack.name and r.free_slots() >= 1
        ]
        if len(other_racks) < rp.diff_rack_count:
            continue
        nodes = [n for n in main_rack.nodes.values() if n.free_slots() >= 1]
        if len(nodes) < rp.same_rack_count + 1:
            continue
        picked = rng.sample(nodes, rp.same_rack_count + 1)
        picked += [
            _pick_any_node_in_rack(r, rng)
            for r in rng.sample(other_racks, rp.diff_rack_count)
        ]
        return picked
    raise NoFreeSpace(f"no rack in dc {dc.name} can host rp={rp}")


def _pick_any_node_in_rack(rack: Rack, rng) -> DataNode:
    nodes = [n for n in rack.nodes.values() if n.free_slots() >= 1]
    if not nodes:
        raise NoFreeSpace(f"rack {rack.name} has no free slots")
    return rng.choice(nodes)


def _pick_any_node(dc: DataCenter, rng) -> DataNode:
    racks = [r for r in dc.racks.values() if r.free_slots() >= 1]
    if not racks:
        raise NoFreeSpace(f"dc {dc.name} has no free slots")
    return _pick_any_node_in_rack(rng.choice(racks), rng)


def targets_per_growth(rp: ReplicaPlacement) -> int:
    """How many volumes to grow at once per replication level
    (`volume_growth.go:42-49` VolumeGrowStrategy)."""
    copies = rp.copy_count()
    if copies == 1:
        return 7
    if copies == 2:
        return 6
    if copies == 3:
        return 3
    return 1
