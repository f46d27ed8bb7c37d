"""The port's topology and master held against the JAX package.

The same seeded heartbeat dicts (volumes at several placements, EC shards,
three data centers of two racks of two nodes) go into both packages'
`Topology.sync_heartbeat`; `to_dict`, `lookup`, `lookup_ec_shards`,
`ec_missing_shards` and `expire_dead_nodes` (with `time` pinned) agree.
The seeded draws agree: `pick_for_write` with the module-level `random`
seeded alike, `grow` likewise, and `find_empty_slots` with
`random.Random(seed)`, at placements 000, 001, 010, 100 and 200. The
sequencers, the volume layout's writable set and the port master's routes
are checked too. Equality throughout (no tolerance).
"""

from __future__ import annotations

import random
import types

import numpy as np
import pytest

from seaweedfs_tpu.storage.types import ReplicaPlacement as RefRP
from seaweedfs_tpu.topology import sequence as ref_sequence
from seaweedfs_tpu.topology import topology as ref_topology_mod
from seaweedfs_tpu.topology import volume_growth as ref_growth
from seaweedfs_tpu.topology.node import VolumeInfo as RefVolumeInfo
from seaweedfs_tpu.topology.topology import Topology as RefTopology
from seaweedfs_tpu.topology.volume_layout import VolumeLayout as RefLayout
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage.types import ReplicaPlacement
from seaweedfs_tpu_torch.topology import sequence
from seaweedfs_tpu_torch.topology import topology as topology_mod
from seaweedfs_tpu_torch.topology import volume_growth
from seaweedfs_tpu_torch.topology.node import VolumeInfo
from seaweedfs_tpu_torch.topology.topology import Topology
from seaweedfs_tpu_torch.topology.volume_layout import NoWritableVolume, VolumeLayout

PLACEMENTS = ("000", "001", "010", "100", "200")
DCS = ("dc1", "dc2", "dc3")
RACKS = ("r1", "r2")
NODES_PER_RACK = 2


def nodes() -> list[tuple[str, str, int]]:
    """(dc, rack, port) of every node: 3 DCs x 2 racks x 2 nodes."""
    out = []
    port = 8080
    for dc in DCS:
        for rack in RACKS:
            for _ in range(NODES_PER_RACK):
                out.append((dc, rack, port))
                port += 1
    return out


def heartbeats(seed: int) -> list[dict]:
    """Seeded full-state heartbeats: volumes at every placement, each on as
    many nodes as the placement wants copies (some one short, so they are
    not writable), a few read-only or oversized, and EC shards of three
    volumes spread over the nodes with some shards held twice or by none."""
    rng = np.random.default_rng(seed)
    ns = nodes()
    hbs = [
        {"ip": "127.0.0.1", "port": port, "data_center": dc, "rack": rack,
         "public_url": f"127.0.0.1:{port}",
         "max_volume_count": int(rng.integers(4, 9)),
         "max_file_key": int(rng.integers(0, 5000)),
         "volumes": [], "ec_shards": []}
        for dc, rack, port in ns
    ]
    vid = 0
    for rp_s in PLACEMENTS:
        rp = RefRP.parse(rp_s)
        for _ in range(3):
            vid += 1
            copies = rp.copy_count() - int(rng.random() < 0.2)
            for i in rng.choice(len(ns), size=max(1, copies), replace=False):
                hbs[i]["volumes"].append({
                    "id": vid, "collection": "c" if vid % 4 == 0 else "",
                    "size": int(rng.integers(0, 80 << 20)),
                    "file_count": int(rng.integers(0, 100)),
                    "delete_count": int(rng.integers(0, 10)),
                    "deleted_byte_count": int(rng.integers(0, 1 << 20)),
                    "read_only": bool(rng.random() < 0.1),
                    "replica_placement": rp.to_byte(), "ttl": 0, "version": 3,
                })
    for ec_vid in (100, 101, 102):
        holders = [int(rng.integers(0, len(ns))) for _ in range(14)]
        holders.append(int(rng.integers(0, len(ns))))  # a second holder of shard 0
        for shard, i in enumerate(holders):
            shard %= 14
            if ec_vid == 102 and shard in (3, 12):
                continue  # shards no node holds
            for e in hbs[i]["ec_shards"]:
                if e["id"] == ec_vid:
                    e["ec_index_bits"] |= 1 << shard
                    break
            else:
                hbs[i]["ec_shards"].append(
                    {"id": ec_vid, "collection": "ec", "ec_index_bits": 1 << shard})
    return hbs


def both(seed: int, pulse: int = 5, **kw) -> tuple[Topology, RefTopology]:
    port = Topology(pulse_seconds=pulse, volume_size_limit=64 << 20, **kw)
    ref = RefTopology(pulse_seconds=pulse, volume_size_limit=64 << 20, **kw)
    for hb in heartbeats(seed):
        port.sync_heartbeat(dict(hb))
        ref.sync_heartbeat(dict(hb))
    return port, ref


def ids(nodes_) -> list[str]:
    return [n.id for n in nodes_]


# --- heartbeats and queries ------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_sync_heartbeat_state_equals_reference(seed):
    port, ref = both(seed)
    assert port.to_dict() == ref.to_dict()
    assert port.ec_missing_shards() == ref.ec_missing_shards()
    assert port.under_replicated_volumes() == ref.under_replicated_volumes()
    assert port.sequencer.peek() == ref.sequencer.peek()
    for vid in range(0, 110):
        for coll in ("", "c", "ec"):
            assert ids(port.lookup(vid, coll)) == ids(ref.lookup(vid, coll)), (vid, coll)
        got, want = port.lookup_ec_shards(vid), ref.lookup_ec_shards(vid)
        assert (got is None) == (want is None)
        if got is not None:
            assert {s: ids(n) for s, n in got.items()} == {s: ids(n) for s, n in want.items()}


@pytest.mark.parametrize("seed", range(2))
def test_partial_shard_loss_and_volume_drop_equal_reference(seed):
    """A node reporting fewer shards of an EC volume, and no longer
    reporting a volume, drops out of both maps alike."""
    port, ref = both(seed)
    hbs = heartbeats(seed)
    for hb in hbs[::3]:
        hb["volumes"] = hb["volumes"][1:]
        for e in hb["ec_shards"]:
            e["ec_index_bits"] &= e["ec_index_bits"] - 1  # drop the lowest shard
        port.sync_heartbeat(dict(hb))
        ref.sync_heartbeat(dict(hb))
    assert port.to_dict() == ref.to_dict()
    assert port.ec_missing_shards() == ref.ec_missing_shards()


@pytest.mark.parametrize("seed", range(2))
def test_expire_dead_nodes_equals_reference(seed, monkeypatch):
    clock = {"t": 1_700_000_000.0}
    pinned = types.SimpleNamespace(time=lambda: clock["t"])
    monkeypatch.setattr(topology_mod, "time", pinned)
    monkeypatch.setattr(ref_topology_mod, "time", pinned)
    port, ref = both(seed, pulse=1)
    clock["t"] += 3
    for hb in heartbeats(seed)[::2]:  # half the nodes beat again
        port.sync_heartbeat(dict(hb))
        ref.sync_heartbeat(dict(hb))
    clock["t"] += 2.5  # 5.5 s after the first beats, 2.5 s after the second
    dead = port.expire_dead_nodes()
    want = ref.expire_dead_nodes()
    assert ids(dead) == ids(want) and len(dead) == len(nodes()) // 2
    assert port.to_dict() == ref.to_dict()
    assert port.ec_missing_shards() == ref.ec_missing_shards()
    for vid in range(0, 110):
        assert ids(port.lookup(vid)) == ids(ref.lookup(vid))


# --- seeded draws ----------------------------------------------------------------
@pytest.mark.parametrize("kind", ("pick_for_write", "grow", "find_empty_slots"))
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_seeded_draws_equal_reference(placement, kind):
    port, ref = both(7)
    for seed in range(6):
        if kind == "pick_for_write":
            got, want = [], []
            for topo, out in ((port, got), (ref, want)):
                random.seed(seed)
                try:
                    fid, count, ns = topo.pick_for_write(2, placement, "", "")
                    out.append((fid, count, ids(ns)))
                except Exception as e:  # noqa: BLE001 - the type is compared
                    out.append(type(e).__name__)
            assert got == want
            assert got[0] != "NoWritableVolume" or placement in ("100", "200")
        elif kind == "grow":
            got, want = [], []
            for topo, out, rp in ((port, got, ReplicaPlacement.parse(placement)),
                                  (ref, want, RefRP.parse(placement))):
                random.seed(seed)
                try:
                    out.extend((vid, ids(ns)) for vid, ns in topo.grow("g", rp, 0))
                except Exception as e:  # noqa: BLE001 - the type is compared
                    out.append(type(e).__name__)
            assert got == want and got
        else:
            got = ids(volume_growth.find_empty_slots(
                port.data_centers, ReplicaPlacement.parse(placement),
                rng=random.Random(seed)))
            want = ids(ref_growth.find_empty_slots(
                ref.data_centers, RefRP.parse(placement), rng=random.Random(seed)))
            assert got == want
            assert len(got) == ReplicaPlacement.parse(placement).copy_count()


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_targets_per_growth_equals_reference(placement):
    assert volume_growth.targets_per_growth(ReplicaPlacement.parse(placement)) == \
        ref_growth.targets_per_growth(RefRP.parse(placement))


def test_find_empty_slots_refuses_like_reference():
    port, ref = both(1)
    for topo in (port, ref):
        for n in topo.all_nodes():
            n.max_volume_count = 0
    with pytest.raises(volume_growth.NoFreeSpace):
        volume_growth.find_empty_slots(port.data_centers, ReplicaPlacement.parse("000"))
    with pytest.raises(ref_growth.NoFreeSpace):
        ref_growth.find_empty_slots(ref.data_centers, RefRP.parse("000"))
    with pytest.raises(NoWritableVolume):
        port.grow("g", ReplicaPlacement.parse("000"), 0)


# --- sequencers and the layout ----------------------------------------------------
def test_memory_sequencer_equals_reference(tmp_path):
    port = sequence.MemorySequencer(str(tmp_path / "p.json"))
    ref = ref_sequence.MemorySequencer(str(tmp_path / "r.json"))
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(1, 100))
        if rng.random() < 0.3:
            port.set_max(n * 7)
            ref.set_max(n * 7)
        assert port.next_file_id(n) == ref.next_file_id(n)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    again = sequence.MemorySequencer(str(tmp_path / "p.json"))
    assert again.peek() == port.peek()


def test_snowflake_sequencer_equals_reference(monkeypatch):
    ms = [1_700_000_000.001] * 3 + [1_700_000_000.002] * 2  # three ids in one ms
    for mod in (sequence, ref_sequence):
        it = iter(ms)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda it=it: next(it)))
    port = sequence.SnowflakeSequencer(513)
    ref = ref_sequence.SnowflakeSequencer(513)
    assert [port.next_file_id() for _ in range(5)] == [ref.next_file_id() for _ in range(5)]


def test_volume_layout_writables_equal_reference():
    rng = np.random.default_rng(5)
    port_nodes = [types.SimpleNamespace(id=f"n{i}", dc_name=lambda: "dc") for i in range(4)]
    port = VolumeLayout(ReplicaPlacement.parse("001"), 0, volume_size_limit=1000)
    ref = RefLayout(RefRP.parse("001"), 0, volume_size_limit=1000)
    for _ in range(200):
        vid = int(rng.integers(1, 12))
        node = port_nodes[int(rng.integers(0, 4))]
        if rng.random() < 0.3:
            port.unregister_volume(vid, node)
            ref.unregister_volume(vid, node)
            continue
        d = {"id": vid, "size": int(rng.integers(0, 1200)),
             "read_only": bool(rng.random() < 0.1), "ec_online": bool(rng.random() < 0.1)}
        port.register_volume(VolumeInfo.from_dict(d), node)
        ref.register_volume(RefVolumeInfo.from_dict(d), node)
        assert port.writables == ref.writables
        assert port.under_replicated() == ref.under_replicated()
        assert port.volume_ids() == ref.volume_ids()
        assert port.active_volume_count("dc") == ref.active_volume_count("dc")


# --- the port master over HTTP ----------------------------------------------------
@pytest.fixture
def master():
    m = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64)
    m.start()
    yield m
    m.stop()


def test_master_heartbeats_and_status_equal_reference_topology(master):
    ref = RefTopology(pulse_seconds=1, volume_size_limit=64 << 20)
    for hb in heartbeats(11):
        out = post_json(f"{master.url}/heartbeat", hb)
        assert out == {"volume_size_limit": 64 << 20, "leader": master.url}
        ref.sync_heartbeat(dict(hb))
    assert get_json(f"{master.url}/dir/status")["Topology"] == ref.to_dict()
    for vid in (1, 5, 9, 100, 102, 999):
        status, _, _ = http_request("GET", f"{master.url}/dir/lookup?volumeId={vid}")
        want = ref.lookup(vid)
        assert (status == 200) == bool(want)
        if want:
            got = get_json(f"{master.url}/dir/lookup?volumeId={vid},0123")
            assert [loc["url"] for loc in got["locations"]] == ids(want)
    ec = get_json(f"{master.url}/dir/ec_lookup?volumeId=101")
    assert ec["shards"] == {
        str(s): [n.url for n in ns] for s, ns in ref.lookup_ec_shards(101).items()}
    status, _, _ = http_request("GET", f"{master.url}/dir/ec_lookup?volumeId=5")
    assert status == 404
    cs = get_json(f"{master.url}/cluster/status")
    assert cs == {"IsLeader": True, "Leader": master.url,
                  "MaxVolumeId": ref.to_dict()["max_volume_id"]}
    ps = get_json(f"{master.url}/cluster/ps")
    assert sorted(v["address"] for v in ps["volumeServers"]) == sorted(
        n.url for n in ref.all_nodes())
    cols = get_json(f"{master.url}/col/list")["collections"]
    assert {c["name"] for c in cols} == {"", "c"}


def test_master_assign_without_servers_fails_and_bad_shard_is_400(master):
    status, _, body = http_request("GET", f"{master.url}/dir/assign")
    assert status == 500 and b"cannot grow volumes" in body
    status, _, _ = http_request("GET", f"{master.url}/dir/assign?shard=3:2")
    assert status == 400
    status, _, _ = http_request("GET", f"{master.url}/dir/lookup?volumeId=x")
    assert status == 400


def test_master_admin_lock(master):
    assert post_json(f"{master.url}/cluster/lock", {"holder": "a"})["ok"]
    assert post_json(f"{master.url}/cluster/lock", {"holder": "a"})["ok"]  # re-entrant
    with pytest.raises(IOError, match="409"):
        post_json(f"{master.url}/cluster/lock", {"holder": "b"})
    with pytest.raises(IOError, match="409"):
        post_json(f"{master.url}/cluster/unlock", {"holder": "b"})
    assert post_json(f"{master.url}/cluster/unlock", {"holder": "a"}) == {"ok": True}
    assert post_json(f"{master.url}/cluster/lock", {"holder": "b", "ttl": 0})["ok"]
    # an expired lease is free for another holder
    assert post_json(f"{master.url}/cluster/lock", {"holder": "a"})["ok"]


def test_master_ec_online_growth_equals_reference_topology(tmp_path):
    """An -ec.online collection: growth finds slots at 000 (7 volumes, one
    holder each) while each volume records the requested placement 001,
    every holder allocates an ecOnline volume at the master's block, an
    assign into the collection is served at once by the optimistic
    registration, and once the servers have beaten the master's topology,
    lookups and writable set equal a JAX Topology fed the same heartbeats.
    The default collection is not online."""
    block = 64 * 1024
    m = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64,
                     ec_online="c", ec_online_block=block)
    m.start()
    servers = []
    try:
        for i, rack in enumerate(("r1", "r2")):
            vs = VolumeServer([str(tmp_path / f"v{i}")], m.url, port=0, rack=rack,
                              pulse_seconds=1, max_volume_count=30, device="cpu")
            vs.start()
            servers.append(vs)
        a = get_json(f"{m.url}/dir/assign?collection=c&replication=001")
        data = bytes(range(256)) * 8
        url = f"http://{a['publicUrl']}/{a['fid']}"
        assert http_request("POST", url, data)[0] == 201
        vols = {v.id: (vs, v) for vs in servers for loc in vs.store.locations
                for v in loc.volumes.values()}
        want = volume_growth.targets_per_growth(ReplicaPlacement.parse("000"))
        assert len(vols) == want
        for vs, v in vols.values():
            assert v.collection == "c" and v.online_ec is not None
            assert v.online_ec.block == block
            assert str(v.super_block.replica_placement) == "001"
        a0 = get_json(f"{m.url}/dir/assign")
        vid0 = int(a0["fid"].split(",")[0])
        assert vid0 not in vols
        (v0,) = [v for vs in servers for v in [vs.store.get_volume(vid0)] if v]
        assert v0.online_ec is None and v0.collection == ""

        ref = RefTopology(pulse_seconds=1, volume_size_limit=64 << 20)
        for vs in servers:
            vs.heartbeat_once()
            hb = vs.store.collect_heartbeat()
            hb.update(data_center=vs.data_center, rack=vs.rack,
                      max_volume_count=vs.max_volume_count)
            ref.sync_heartbeat(hb)
        assert get_json(f"{m.url}/dir/status")["Topology"] == ref.to_dict()
        for vid in vols:
            got = get_json(f"{m.url}/dir/lookup?volumeId={vid}")
            assert [loc["url"] for loc in got["locations"]] == ids(ref.lookup(vid))
        port_lo = m.topo.layout("c", ReplicaPlacement.parse("001"), 0)
        ref_lo = ref.layout("c", RefRP.parse("001"), 0)
        assert sorted(port_lo.writables) == sorted(ref_lo.writables) == sorted(vols)
        assert http_request("GET", url)[2] == data
    finally:
        for vs in servers:
            vs.stop()
        m.stop()
