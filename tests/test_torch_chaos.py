"""Chaos suite: REAL faults armed on live 3-node clusters of the port.

The port's counterpart of tests/test_chaos.py: the same scenarios and
assertions over the port's master, volume servers (device="cpu") and
shell. The volume servers run behind the native fastlane engine, as a
deployment does, and `volume.fastlane.drain` fires through its drain.

Every scenario here injects through util/faults.py (the `-faults` /
POST /debug/faults / cluster.faults switchboard) and asserts the
cluster SERVES THROUGH the fault: reads keep succeeding (degraded or
retried, no client-visible failures beyond the acceptance budget), the
maintenance daemon heals within its scan budget, and disarm_all()
restores the zero-injection steady state.

Coverage contract: every fault point declared in faults.ALL_POINTS must
fire at least once in this file — the port's check_metric_names lints
the names against this source, and test_every_fault_point_fires asserts the
firing counts at runtime:

    volume.read.dat volume.read.idx volume.write.dat
    volume.ec.shard.read volume.ec.parity.write volume.heartbeat.send
    master.assign master.lookup filer.chunk.read
    volume.replicate.fanout volume.fastlane.drain repair.partial_fetch

The `corrupt` fault mode (silent bit flips) is exercised by the
scrub scenario (TestSilentCorruptionScrubHeal), also lint-enforced.
"""

import contextlib
import os
import threading
import time

import pytest

from seaweedfs_tpu_torch.filer.wdclient import WeedClient
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.stats import events as events_mod
from seaweedfs_tpu_torch.storage.file_id import parse_key_hash_with_delta
from seaweedfs_tpu_torch.util import faults

BLOCK = 4096  # small uniform online-EC stripe keeps the suite quick


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.enable()  # opt the test process into runtime POST /debug/faults
    faults.disarm_all()
    yield
    faults.disarm_all()
    # neutralize this scenario's metric fallout (5xx bursts, degraded
    # reads) so rate-based alerts — the SLO fast burn especially — don't
    # keep firing into whatever suite runs inside the next window
    from seaweedfs_tpu_torch.stats import history as history_mod

    history_mod.default_history().clear()


@pytest.fixture()
def cluster(tmp_path):
    master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64,
                          maintenance_interval=0.25,
                          ec_online="hot", ec_online_block=BLOCK)
    master.start()
    vols = []
    for i, rack in enumerate(["r1", "r2", "r3"]):
        vs = VolumeServer(
            [str(tmp_path / f"v{i}")], master.url, port=0, rack=rack,
            pulse_seconds=1, max_volume_count=30, device="cpu"
        )
        vs.start()
        vols.append(vs)
    env = CommandEnv(master.url)
    yield master, vols, env
    for vs in vols:
        vs.stop()
    master.stop()


def assign(master, **params):
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    return get_json(f"{master.url}/dir/assign?{qs}")


def wait_until(fn, timeout=30.0, interval=0.2, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@contextlib.contextmanager
def pumps_held(vs):
    """Hold `vs`'s fastlane drain loop off its online-EC pumps (it calls
    `_pump_online_ec` every 20 ms) until the block ends; entering waits for
    a tick already pumping. A torn parity write is a crash mid-append, the
    last write the stripe sees: a loop tick that encodes the injected
    stripe's full rows takes the tear, and the caller's forced tail-row
    flush then writes past the cut and hides it from parity_health."""
    gate = threading.Lock()
    inner = vs._pump_online_ec

    def gated() -> None:
        with gate:
            inner()

    vs._pump_online_ec = gated
    try:
        with gate:
            yield
    finally:
        del vs._pump_online_ec


def fired(point: str) -> int:
    return faults.point(point).fired


class TestEveryPointFires:
    def test_every_fault_point_fires(self, cluster):
        """Arm each declared point (latency mode: benign) and drive its
        seam; every one must count an injection — the registry-vs-tests
        lint plus the runtime proof the seams are actually wired."""
        master, vols, env = cluster
        before = {p: fired(p) for p in faults.ALL_POINTS}

        # master.assign / master.lookup — control plane handlers
        faults.arm("master.assign", "latency", ms=1)
        a = assign(master)
        faults.arm("master.lookup", "latency", ms=1)
        get_json(f"{master.url}/dir/lookup?volumeId={a['fid'].split(',')[0]}")

        # volume.write.dat + volume.replicate.fanout — a replicated
        # write runs the Python write path and the synchronous fan-out
        faults.arm("volume.write.dat", "latency", ms=1)
        faults.arm("volume.replicate.fanout", "latency", ms=1)
        ar = assign(master, replication="010")
        url = f"http://{ar['publicUrl']}/{ar['fid']}"
        st, _, _ = http_request("POST", url, b"chaos-write " * 100)
        assert st == 201

        # volume.read.dat + volume.read.idx — a query-string GET rides
        # the Python read path even behind the native engine
        faults.arm("volume.read.dat", "latency", ms=1)
        faults.arm("volume.read.idx", "latency", ms=1)
        st, _, body = http_request("GET", url + "?chaos=1")
        assert st == 200 and body.startswith(b"chaos-write")

        # filer.chunk.read — the wdclient relay seam
        faults.arm("filer.chunk.read", "latency", ms=1)
        wc = WeedClient(master.url)
        assert wc.fetch(ar["fid"]).startswith(b"chaos-write")

        # volume.heartbeat.send
        faults.arm("volume.heartbeat.send", "latency", ms=1)
        vols[0].heartbeat_once()

        # volume.ec.parity.write — online-EC ingest encode
        ah = assign(master, collection="hot")
        hvid = int(ah["fid"].split(",")[0])
        hv = next(
            vs for vs in vols if vs.store.get_volume(hvid) is not None
        )
        st, _, _ = http_request(
            "POST", f"http://{ah['publicUrl']}/{ah['fid']}",
            os.urandom(BLOCK * 10 * 2),
        )
        assert st == 201
        faults.arm("volume.ec.parity.write", "latency", ms=1)
        hv.store.get_volume(hvid).online_ec.pump(force=True)

        # volume.ec.shard.read — seal a volume to EC, read from shards
        v_ec = assign(master)
        ecvid = int(v_ec["fid"].split(",")[0])
        http_request(
            "POST", f"http://{v_ec['publicUrl']}/{v_ec['fid']}",
            b"sealed-ec-needle " * 64,
        )
        src = next(
            vs for vs in vols if vs.store.get_volume(ecvid) is not None
        )
        post_json(f"{src.url}/admin/ec/generate", {"volume": ecvid},
                  timeout=60)
        post_json(f"{src.url}/admin/ec/delete_volume", {"volume": ecvid})
        post_json(f"{src.url}/admin/ec/mount", {"volume": ecvid})
        faults.arm("volume.ec.shard.read", "latency", ms=1)
        key, _ = parse_key_hash_with_delta(v_ec["fid"].split(",")[1])
        assert src.store.get_ec_volume(ecvid).read_needle(key).data \
            .startswith(b"sealed-ec-needle")

        # repair.partial_fetch — a ranged partial-sum request (the
        # pipelined-rebuild hop seam) against the sealed EC volume
        import json as _json
        import urllib.parse as _up

        faults.arm("repair.partial_fetch", "latency", ms=1)
        sid = src.store.get_ec_volume(ecvid).shard_ids()[0]
        st, _, body = http_request(
            "POST",
            f"{src.url}/admin/ec/partial?volume={ecvid}&offset=0&size=64"
            f"&targets=0&coefs={_up.quote(_json.dumps({str(sid): [1]}))}",
            b"",
        )
        assert st == 200 and len(body) == 64

        # volume.fastlane.drain — the engine event drain (a Python seam:
        # the engine has no injection ABI of its own)
        faults.arm("volume.fastlane.drain", "latency", ms=1)
        vols[0].fastlane.drain()

        faults.disarm_all()
        for p in faults.ALL_POINTS:
            assert fired(p) > before[p], f"fault point {p} never fired"

        # ...and the injections are observable: the metric family counts
        st, _, body = http_request("GET", f"{master.url}/metrics", timeout=10)
        assert b"SeaweedFS_faults_injected_total" in body

    def test_debug_faults_endpoint_on_every_role(self, cluster):
        master, vols, env = cluster
        for url in [master.url] + [vs.service.url for vs in vols]:
            out = get_json(f"{url}/debug/faults")
            assert set(out["declared"]) == set(faults.ALL_POINTS)
        out = post_json(f"{master.url}/debug/faults", {
            "action": "arm", "point": "master.lookup", "mode": "latency",
            "ms": 1,
        })
        assert out["ok"]
        assert "master.lookup" in faults.armed()
        out = post_json(f"{master.url}/debug/faults",
                        {"action": "disarm_all"})
        assert out["disarmed"] == 1

    def test_cluster_faults_verb(self, cluster):
        master, vols, env = cluster
        out = run_command(
            env, "cluster.faults -arm master.assign -mode latency -ms 1"
        )
        assert "armed master.assign" in out
        assert faults.armed()["master.assign"].ms == 1.0
        listing = run_command(env, "cluster.faults -list")
        assert "master.assign" in listing and "mode=latency" in listing
        out = run_command(env, "cluster.faults -disarmAll")
        assert "disarmed all" in out
        assert faults.armed() == {}


class TestHolderKilledMidReadStorm:
    def test_reads_survive_holder_loss_and_daemon_heals(self, cluster):
        """The acceptance scenario: kill a volume holder under a
        concurrent read storm — >= 99% of reads succeed (retried via the
        unified RetryPolicy, no client-visible failures), and the
        maintenance daemon re-replicates within its budget."""
        master, vols, env = cluster
        blobs = {}
        for i in range(12):
            a = assign(master, replication="010", collection="storm")
            url = f"http://{a['publicUrl']}/{a['fid']}"
            data = f"storm-{i}-".encode() * 60
            st, _, _ = http_request("POST", url, data)
            assert st == 201
            blobs[a["fid"]] = data
        post_json(f"{master.url}/maintenance/enable")

        wc = WeedClient(master.url, cache_ttl=2.0)
        results = {"ok": 0, "bad": 0, "wrong": 0}
        res_lock = threading.Lock()
        stop_at = time.time() + 4.0
        fids = list(blobs)

        def reader(seed: int) -> None:
            i = seed
            while time.time() < stop_at:
                fid = fids[i % len(fids)]
                i += 1
                try:
                    data = wc.fetch(fid)
                except Exception:
                    with res_lock:
                        results["bad"] += 1
                    continue
                with res_lock:
                    if data == blobs[fid]:
                        results["ok"] += 1
                    else:
                        results["wrong"] += 1

        threads = [
            threading.Thread(target=reader, args=(s,), daemon=True)
            for s in range(4)
        ]
        for t in threads:
            t.start()
        time.sleep(1.0)  # storm running against a healthy cluster...
        victim = next(
            vs for vs in vols
            if any(vs.store.has_volume(int(f.split(",")[0])) for f in fids)
        )
        victim_vids = {
            int(f.split(",")[0]) for f in fids
            if victim.store.has_volume(int(f.split(",")[0]))
        }
        victim_id = victim.node_id
        victim.stop()  # ...then a holder dies mid-storm
        for t in threads:
            t.join(timeout=30)
        total = results["ok"] + results["bad"] + results["wrong"]
        assert total > 50, f"storm too small to mean anything: {results}"
        assert results["wrong"] == 0, results
        assert results["ok"] / total >= 0.99, results

        # the daemon heals: every storm volume back to 2 live holders
        def healed() -> bool:
            live = {}
            for sv in env.servers():
                for vid in sv.volumes:
                    live[vid] = live.get(vid, 0) + 1
            return all(live.get(vid, 0) >= 2 for vid in victim_vids)

        wait_until(healed, timeout=40, msg="re-replication after holder loss")
        # steady state restored: reads serve clean with zero faults armed
        assert faults.armed() == {}
        for fid, data in list(blobs.items())[:3]:
            assert wc.fetch(fid) == data
        # the flight recorder tells the heal story: the repair runs its
        # full journaled lifecycle — either per-volume fix_replication
        # tasks or the stale-heartbeat evacuate (whichever wins the
        # race; healed() can pass early off the pre-expiry topology, so
        # wait for the journal, not just the holder counts)
        rec = events_mod.recorder()

        def repair_events() -> list[dict]:
            return [
                e for e in rec.events(limit=0)
                if (e.get("volume") in victim_vids
                    and (e.get("task") or "").startswith("fix_replication:"))
                or e.get("task") == f"evacuate:{victim_id}"
            ]

        wait_until(
            lambda: {"task_queued", "task_dispatched", "task_done"}
            <= {e["type"] for e in repair_events()},
            timeout=40, msg="repair task lifecycle in the flight recorder",
        )
        # and cluster.why renders a healed volume's timeline
        healed_vid = sorted(victim_vids)[0]
        why = run_command(env, f"cluster.why {healed_vid}")
        assert f"cluster.why volume {healed_vid}" in why


class TestTornParityWrite:
    def test_torn_parity_healed_by_daemon(self, cluster):
        """Arm a torn parity write on a live online-EC volume: reads keep
        serving off the intact .dat, the holder's heartbeat reports the
        damage, and the daemon's online ec_rebuild re-arms the striper +
        re-encodes from the durable .dat within its budget."""
        master, vols, env = cluster
        a = assign(master, collection="hot")
        vid = int(a["fid"].split(",")[0])
        hv = next(vs for vs in vols if vs.store.get_volume(vid) is not None)
        url = f"http://{a['publicUrl']}/{a['fid']}"
        payload = os.urandom(BLOCK * 10 * 3)
        assert http_request("POST", url, payload)[0] == 201
        v = hv.store.get_volume(vid)
        v.online_ec.pump(force=True)
        assert v.online_ec.parity_health() == 0

        from seaweedfs_tpu_torch.storage.needle import Needle

        with pumps_held(hv):
            faults.arm("volume.ec.parity.write", "torn", frac=1.0, count=1)
            # feed the next stripe, then pump: the encode lands, THEN the
            # injected tear chops the durable parity tail (crash mid-append)
            v.write_needle(
                Needle(cookie=0x99, id=999991, data=os.urandom(BLOCK * 10))
            )
            v.online_ec.pump(force=True)
            faults.disarm_all()
            assert v.online_ec.parity_health() >= 1

        # reads never noticed: the .dat is intact
        st, _, body = http_request("GET", url)
        assert st == 200 and body == payload

        post_json(f"{master.url}/maintenance/enable")
        hv.heartbeat_once()  # deliver the damage audit

        def rebuild_applied() -> tuple:
            st_hist = get_json(f"{master.url}/debug/maintenance")
            return st_hist, [
                line
                for e in st_hist.get("history", [])
                if e["task"]["type"] == "ec_rebuild"
                for line in e.get("applied", [])
            ]

        # the executor heals before the daemon records the task (it first
        # releases the admin lease and journals task_done): wait for both
        wait_until(
            lambda: v.online_ec.parity_health() == 0
            and v.online_ec.active and rebuild_applied()[1],
            timeout=30, msg="online parity rearm+re-encode, and its record",
        )
        st_hist, applied = rebuild_applied()
        assert any("parity re-encoded" in a for a in applied), st_hist
        # and the parity is REAL: a .dat corruption now degrades cleanly
        # (query-string GET rides the Python path, whose CRC check trips
        # the reconstruction; counted in degraded_reads_total)
        key, _ = parse_key_hash_with_delta(a["fid"].split(",")[1])
        nv = v.nm.get(key)
        with open(v.base_name + ".dat", "r+b") as f:
            f.seek(nv[0] + 30)
            f.write(b"\xff" * 16)
        st, hdrs, body = http_request("GET", url + "?degraded=1")
        assert st == 200 and body == payload
        # the degraded read's full causal chain reconstructs from the
        # flight recorder: request span -> degraded_read under ONE trace,
        # and the volume timeline shows the torn-parity fault, the
        # daemon's rearm heal (task_done + parity_rearm fallback) — the
        # acceptance chain, assembled by cluster.why
        tid = hdrs["X-Sw-Trace-Id"]
        why = run_command(env, f"cluster.why {tid}")
        assert "span [volume] GET" in why, why
        assert "degraded_read" in why and f"volume={vid}" in why, why
        whyv = run_command(env, f"cluster.why {vid}")
        assert "fault_injected" in whyv, whyv  # the torn parity write
        assert "fallback_ec_online" in whyv \
            and "parity_rearm" in whyv, whyv  # the rearm heal
        assert "task_done" in whyv and "ec_rebuild" in whyv, whyv


class TestPartitionedHeartbeat:
    def test_partition_evacuates_ec_shards_then_rejoins(self, tmp_path):
        """Partition ONE node's heartbeats (key-scoped fault): the master
        sees staleness, the evacuate executor pre-copies the node's EC
        shards from the still-serving node (the gap: no more
        waiting for expiry + ec_rebuild), and disarming lets the node
        rejoin."""
        master = MasterServer(port=0, pulse_seconds=2,
                              volume_size_limit_mb=64,
                              maintenance_interval=0.3)
        master.start()
        vols = []
        try:
            for i, rack in enumerate(["r1", "r2", "r3"]):
                vs = VolumeServer(
                    [str(tmp_path / f"v{i}")], master.url, port=0, rack=rack,
                    pulse_seconds=1, max_volume_count=30, device="cpu"
                )
                vs.start()
                vols.append(vs)
            env = CommandEnv(master.url)
            a = assign(master)
            vid = int(a["fid"].split(",")[0])
            http_request(
                "POST", f"http://{a['publicUrl']}/{a['fid']}",
                b"evac-me " * 200,
            )
            run_command(env, "lock")
            run_command(env, f"ec.encode -volumeId {vid}")
            run_command(env, "unlock")
            victim = max(
                vols, key=lambda vs: len(
                    vs.store.get_ec_volume(vid).shard_ids()
                    if vs.store.get_ec_volume(vid) else []
                ),
            )
            victim_id = victim.node_id
            victim_shards = set(
                victim.store.get_ec_volume(vid).shard_ids()
            )
            assert victim_shards
            post_json(f"{master.url}/maintenance/enable")
            # partition exactly the victim's heartbeats
            faults.arm("volume.heartbeat.send", "partition", key=victim_id)

            def shards_covered_elsewhere() -> bool:
                have = set()
                for sv in env.servers():
                    if sv.id == victim_id:
                        continue
                    have.update(sv.ec_shards.get(vid, []))
                return victim_shards <= have

            wait_until(shards_covered_elsewhere, timeout=40,
                       msg="EC shard pre-copy off the partitioned node")
            # force a collector render: the heartbeat_stale edge lands in
            # the flight recorder the moment staleness is computed
            http_request("GET", f"{master.url}/metrics")
            rec = events_mod.recorder()
            assert any(
                e["node"] == victim_id
                for e in rec.events(type="heartbeat_stale")
            ), rec.events(limit=64)
            st = get_json(f"{master.url}/debug/maintenance")
            evac = [
                line
                for e in st.get("history", [])
                if e["task"]["type"] == "evacuate"
                for line in e.get("applied", [])
            ]
            assert any("ec volume" in a for a in evac), st

            # heal the partition: the node heartbeats again and rejoins
            faults.disarm_all()
            victim.heartbeat_once()
            wait_until(
                lambda: any(
                    sv.id == victim_id for sv in env.servers()
                ),
                timeout=15, msg="partitioned node rejoining",
            )
            # ...and the rejoin edge is journaled on the next render
            http_request("GET", f"{master.url}/metrics")
            assert any(
                e["node"] == victim_id
                for e in rec.events(type="heartbeat_rejoin")
            ), rec.events(limit=64)
            # the evacuate repair's lifecycle is journaled under its
            # node-scoped task key (queued -> done on the stale node)
            evac = [e for e in rec.events(limit=0)
                    if e.get("task") == f"evacuate:{victim_id}"]
            assert {"task_queued", "task_done"} <= {
                e["type"] for e in evac}, evac
        finally:
            faults.disarm_all()
            for vs in vols:
                vs.stop()
            master.stop()


class TestPipelineHopKilledMidRebuild:
    def test_rebuild_survives_dead_hop_under_read_storm(self, cluster):
        """acceptance: a pipelined-rebuild chain hop dies
        (repair.partial_fetch error, key-scoped to one node) while
        clients hammer the EC volume with reads. The maintenance daemon
        (rebuildMode=pipelined) must still heal the lost shard — via a
        chain restart minus the dead hop or the typed classic fallback —
        with ZERO client-visible read errors, and the fallback/restart
        must be visible in the ec_repair counters."""
        master, vols, env = cluster
        # build a spread EC volume with real needles (assigns rotate over
        # the collection's volumes: group by vid, take the fullest)
        by_vid: dict[int, dict] = {}
        for i in range(8):
            a = assign(master, collection="pipe")
            data = f"pipe-{i}-".encode() * 400
            st, _, _ = http_request(
                "POST", f"http://{a['publicUrl']}/{a['fid']}", data)
            assert st == 201
            by_vid.setdefault(
                int(a["fid"].split(",")[0]), {})[a["fid"]] = data
        vid, blobs = max(by_vid.items(), key=lambda kv: len(kv[1]))
        assert blobs
        run_command(env, "lock")
        run_command(env, f"ec.encode -volumeId {vid}")
        run_command(env, "unlock")

        def counter(name: str, label: str) -> float:
            from seaweedfs_tpu_torch.stats import default_registry

            total = 0.0
            for line in default_registry().render().splitlines():
                if line.startswith(name + "{") and label in line:
                    total += float(line.rsplit(" ", 1)[1])
            return total

        from seaweedfs_tpu_torch.storage.erasure_coding import decoder as ec_dec

        restarts0 = counter(ec_dec.REPAIR_RESTARTS, "reason=")
        fallbacks0 = counter(ec_dec.REPAIR_FALLBACKS, "reason=")

        # kill one holder's partial-sum stage (NOT the whole node: its
        # shards still serve reads and classic copies)
        holders = [sv for sv in env.servers() if sv.ec_shards.get(vid)]
        victim = holders[0]
        faults.arm("repair.partial_fetch", "error", key=victim.id)

        post_json(f"{master.url}/maintenance/enable",
                  {"rebuildMode": "pipelined"})

        # client-visible = through the real retrying client (the unified
        # RetryPolicy + holder failover wdclient carries — the same bar
        # the killed-holder storm holds reads to)
        wc = WeedClient(master.url, cache_ttl=1.0)
        results = {"ok": 0, "bad": 0}
        res_lock = threading.Lock()
        stop_at = time.time() + 6.0
        fids = list(blobs)

        def reader(seed: int) -> None:
            i = seed
            while time.time() < stop_at:
                fid = fids[i % len(fids)]
                i += 1
                try:
                    body = wc.fetch(fid)
                    with res_lock:
                        if body == blobs[fid]:
                            results["ok"] += 1
                        else:
                            results["bad"] += 1
                except Exception:
                    with res_lock:
                        results["bad"] += 1

        threads = [
            threading.Thread(target=reader, args=(s,), daemon=True)
            for s in range(3)
        ]
        for t in threads:
            t.start()
        time.sleep(0.5)
        # lose the DATA shard backing blobs[0] mid-storm (not an
        # arbitrary — possibly parity — shard): its reads must now
        # RECONSTRUCT (degraded, journaled with their trace ids), and
        # the daemon detects + repairs through the dead hop
        fired_before = fired("repair.partial_fetch")
        key0, _ = parse_key_hash_with_delta(fids[0].split(",")[1])
        ev0 = next(v.store.get_ec_volume(vid) for v in vols
                   if v.store.get_ec_volume(vid) is not None)
        off0, size0 = ev0.find_needle_from_ecx(key0)
        lost = ev0.locate_intervals(off0, size0)[0].to_shard_id_and_offset(
            ev0.large_block_size, ev0.small_block_size)[0]
        shard_holder = next(sv for sv in env.servers()
                            if lost in sv.ec_shards.get(vid, []))
        post_json(f"{shard_holder.http}/admin/ec/delete_shards",
                  {"volume": vid, "shards": [lost], "collection": "pipe"})

        def healed() -> bool:
            have = {
                s for sv in env.servers()
                for s in sv.ec_shards.get(vid, [])
            }
            return len(have) == 14

        wait_until(healed, timeout=40,
                   msg="shard heal through a dead pipeline hop")
        for t in threads:
            t.join(timeout=30)
        assert results["bad"] == 0, results
        assert results["ok"] > 30, results
        # the dead hop was really in the repair's path...
        assert fired("repair.partial_fetch") > fired_before
        # ...and the ladder engaged: a chain restart or typed fallback
        restarts = counter(ec_dec.REPAIR_RESTARTS, "reason=") - restarts0
        fallbacks = counter(ec_dec.REPAIR_FALLBACKS, "reason=") - fallbacks0
        assert restarts + fallbacks >= 1, (restarts, fallbacks)
        faults.disarm_all()
        # steady state: reads still clean, shard still present
        for fid, data in list(blobs.items())[:2]:
            st, _, body = http_request(
                "GET", f"{holders[0].http}/{fid}")
            assert st == 200 and body == data
        assert healed()
        # the flight recorder reconstructs the incident: at least one
        # degraded (reconstructed) read is journaled with its trace id,
        # and cluster.why resolves request -> degraded_read, while the
        # volume timeline shows the remount swap, the repair lifecycle
        # and the ladder's restart/fallback through the dead hop
        rec = events_mod.recorder()
        deg = [e for e in rec.events(type="degraded_read", limit=0)
               if e["volume"] == vid and e.get("trace_id")]
        assert deg, rec.events(limit=64)
        why = run_command(env, f"cluster.why {deg[-1]['trace_id']}")
        assert "degraded_read" in why, why
        assert "ec_reconstruct" in why, why
        whyv = run_command(env, f"cluster.why {vid}")
        assert "remount_swap" in whyv, whyv
        assert "task_queued" in whyv and "task_done" in whyv, whyv
        assert "chain_restart" in whyv or "fallback_repair" in whyv, whyv


class TestStreamHopKilledChunksInFlight:
    def test_heal_resumes_from_committed_chunk_zero_client_errors(
        self, tmp_path
    ):
        """acceptance: a STREAMING rebuild hop dies with chunks in
        flight. 5-node cluster (excluding any one hop still leaves 10
        usable shards), one lost PARITY shard — parity so no read ever
        needs the partial fan-in, which shares the repair.partial_fetch
        point: the armed onset delay (`after=4`) is then consumed by the
        stream session alone, deterministically — open, then chunks 0-2
        pass through the victim and chunk 3 dies while the bounded
        window (4) keeps later chunks in flight behind it. The daemon's
        pipelined+streaming heal must restart minus the hop and RESUME
        from the writer's committed frontier (chunks 0-2 never re-sent,
        counted into resumed_bytes_total), journal chain_restart with
        the chunk index, and a concurrent read storm across the volume
        must see ZERO errors end to end."""
        from seaweedfs_tpu_torch.shell.commands_ec import plan_rebuild_pipelined
        from seaweedfs_tpu_torch.storage.erasure_coding import decoder as ec_dec

        def counter(name: str, label: str = "") -> float:
            from seaweedfs_tpu_torch.stats import default_registry

            total = 0.0
            for line in default_registry().render().splitlines():
                if line.startswith(name) and label in line:
                    total += float(line.rsplit(" ", 1)[1])
            return total

        master = MasterServer(port=0, pulse_seconds=1,
                              volume_size_limit_mb=64,
                              maintenance_interval=0.25)
        master.start()
        vols = []
        try:
            for i in range(5):
                vs = VolumeServer(
                    [str(tmp_path / f"v{i}")], master.url, port=0,
                    rack=f"r{i}", pulse_seconds=1, max_volume_count=30, device="cpu"
                )
                vs.start()
                vols.append(vs)
            env = CommandEnv(master.url)
            by_vid: dict[int, dict] = {}
            for i in range(8):
                a = assign(master, collection="stream")
                data = os.urandom(50000)
                st, _, _ = http_request(
                    "POST", f"http://{a['publicUrl']}/{a['fid']}", data)
                assert st == 201
                by_vid.setdefault(
                    int(a["fid"].split(",")[0]), {})[a["fid"]] = data
            vid, blobs = max(by_vid.items(), key=lambda kv: len(kv[1]))
            run_command(env, "lock")
            run_command(env, f"ec.encode -volumeId {vid}")
            run_command(env, "unlock")

            def shard_count() -> int:
                return len({
                    s for sv in env.servers()
                    for s in sv.ec_shards.get(vid, [])
                })

            # lose a parity shard: the repair is real, the reads never
            # degrade (see docstring — keeps the fault onset countdown
            # owned by the stream)
            lost = 13
            holder = next(sv for sv in env.servers()
                          if lost in sv.ec_shards.get(vid, []))
            post_json(f"{holder.http}/admin/ec/delete_shards",
                      {"volume": vid, "shards": [lost],
                       "collection": "stream"})
            wait_until(lambda: shard_count() == 13, timeout=15,
                       msg="shard loss in topology")
            # the daemon will compute this same deterministic plan; pick
            # a MID hop (not head, not the terminal writer) as victim
            pplan = plan_rebuild_pipelined(env, vid, "stream")
            assert pplan is not None and len(pplan["chain"]) >= 4
            victim = pplan["chain"][1]["server"]
            faults.arm("repair.partial_fetch", "error", key=victim,
                       after=4)
            resumed0 = counter(ec_dec.REPAIR_RESUMED_BYTES)
            written0 = counter(ec_dec.REPAIR_STREAM_CHUNKS,
                               'state="written"')

            wc = WeedClient(master.url, cache_ttl=1.0)
            results = {"ok": 0, "bad": 0}
            res_lock = threading.Lock()
            stop = threading.Event()
            fids = list(blobs)

            def reader(seed: int) -> None:
                i = seed
                while not stop.is_set():
                    fid = fids[i % len(fids)]
                    i += 1
                    try:
                        body = wc.fetch(fid)
                        with res_lock:
                            if body == blobs[fid]:
                                results["ok"] += 1
                            else:
                                results["bad"] += 1
                    except Exception:
                        with res_lock:
                            results["bad"] += 1

            threads = [
                threading.Thread(target=reader, args=(s,), daemon=True)
                for s in range(3)
            ]
            for t in threads:
                t.start()
            post_json(f"{master.url}/maintenance/enable",
                      {"rebuildMode": "pipelined"})
            wait_until(lambda: shard_count() == 14, timeout=40,
                       msg="streamed heal through the dead hop")
            time.sleep(0.5)  # let the storm read across the remount
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert results["bad"] == 0, results
            assert results["ok"] > 30, results
            # the heal streamed, and the restart RESUMED: the committed
            # chunks (>= 3 by the onset delay) were never re-sent
            assert counter(ec_dec.REPAIR_STREAM_CHUNKS,
                           'state="written"') > written0
            assert counter(ec_dec.REPAIR_RESUMED_BYTES) - resumed0 > 0, \
                "restart re-sent from byte 0 instead of resuming"
            restarts = [
                e for e in events_mod.recorder().events(
                    type="chain_restart", limit=0)
                if e["volume"] == vid
            ]
            assert restarts, "chain_restart not journaled"
            chunks = [e.get("attrs", e).get("chunk") for e in restarts]
            assert any(c is not None and c >= 3 for c in chunks), restarts
            # the victim was the attributed hop, and steady state is clean
            assert any(e.get("node") == victim for e in restarts), restarts
            faults.disarm_all()
            for fid, data in list(blobs.items())[:2]:
                body = wc.fetch(fid)
                assert body == data
        finally:
            faults.disarm_all()
            for vs in vols:
                vs.stop()
            master.stop()


class TestSilentCorruptionScrubHeal:
    def test_bitrot_detected_and_healed_with_zero_client_errors(
        self, cluster
    ):
        """The acceptance scenario: silent corruption — a bit flip
        in a cold replicated needle (injected via the `corrupt` fault
        mode on the write seam: the client got its 201, nobody noticed)
        and a flipped byte in a sealed EC shard — is found by a scrub
        pass, routed by the maintenance daemon to the existing heals
        (needle re-copy from the good replica; shard delete ->
        ec_rebuild re-derivation), `cluster.why <vid>` resolves the
        scrub_finding -> task_done chain, and a concurrent client read
        storm sees ZERO errors throughout."""
        master, vols, env = cluster

        # --- a replicated collection with one silently-corrupt needle
        blobs = {}
        for i in range(6):
            a = assign(master, replication="010", collection="cold")
            data = f"cold-{i}-".encode() * 120
            st, _, _ = http_request(
                "POST", f"http://{a['publicUrl']}/{a['fid']}", data)
            assert st == 201
            blobs[a["fid"]] = data
        # the silent write-path bit flip: ONE append draws the fault —
        # the write still acks 201 and the flip is invisible until a
        # CRC looks at it (the scrub thesis)
        faults.arm("volume.write.dat", "corrupt", frac=0.5, count=1)
        a = assign(master, replication="010", collection="cold")
        vid_n = int(a["fid"].split(",")[0])
        key_n, _ = parse_key_hash_with_delta(a["fid"].split(",")[1])
        data_n = b"rot-me " * 150
        st, _, _ = http_request(
            "POST", f"http://{a['publicUrl']}/{a['fid']}", data_n)
        assert st == 201, "silent corruption must not fail the write"
        faults.disarm_all()
        blobs[a["fid"]] = data_n

        # --- a sealed EC volume with a flipped shard byte (all 14
        # shards stay on the sealing node: the locate-via-parity regime)
        e = assign(master)
        vid_e = int(e["fid"].split(",")[0])
        key_e, _ = parse_key_hash_with_delta(e["fid"].split(",")[1])
        data_e = b"sealed-rot " * 300
        assert http_request(
            "POST", f"http://{e['publicUrl']}/{e['fid']}", data_e,
        )[0] == 201
        src = next(
            vs for vs in vols if vs.store.get_volume(vid_e) is not None
        )
        post_json(f"{src.url}/admin/ec/generate", {"volume": vid_e},
                  timeout=60)
        post_json(f"{src.url}/admin/ec/delete_volume", {"volume": vid_e})
        post_json(f"{src.url}/admin/ec/mount", {"volume": vid_e})
        ev = src.store.get_ec_volume(vid_e)
        assert len(ev.shard_ids()) == 14
        flipped_shard = 4
        shard_path = ev.data_base + f".ec{flipped_shard:02d}"
        with open(shard_path, "r+b") as f:
            f.seek(11)
            b = f.read(1)
            f.seek(11)
            f.write(bytes([b[0] ^ 0xFF]))

        # --- client read storm through the whole detect->heal window
        wc = WeedClient(master.url, cache_ttl=1.0)
        results = {"ok": 0, "bad": 0}
        res_lock = threading.Lock()
        storm_stop = threading.Event()
        fids = list(blobs)

        def reader(seed: int) -> None:
            i = seed
            while not storm_stop.is_set():
                fid = fids[i % len(fids)]
                i += 1
                try:
                    body = wc.fetch(fid)
                    with res_lock:
                        results["ok" if body == blobs[fid] else "bad"] += 1
                except Exception:
                    with res_lock:
                        results["bad"] += 1
        threads = [
            threading.Thread(target=reader, args=(s,), daemon=True)
            for s in range(3)
        ]
        for t in threads:
            t.start()

        try:
            # --- scrub passes find BOTH pieces of silent damage
            findings = []
            for vs in vols:
                out = post_json(f"{vs.url}/admin/scrub/run", {},
                                timeout=120)
                findings.extend(out["findings"])
            kinds = {(f["kind"], f["volume_id"]) for f in findings}
            assert ("corrupt_needle", vid_n) in kinds, findings
            assert ("corrupt_shard", vid_e) in kinds, findings
            shard_finding = next(
                f for f in findings if f["kind"] == "corrupt_shard"
            )
            assert shard_finding["shard"] == flipped_shard, \
                "parity recompute must LOCATE the flipped shard"

            # the operator surface sees the same truth: volume.scrub
            # -dryRun renders the routed repair plan without mutating
            run_command(env, "lock")
            plan = run_command(env, "volume.scrub -dryRun")
            run_command(env, "unlock")
            assert "corrupt_needle" in plan and "re-copy needle" in plan
            assert "corrupt_shard" in plan and "ec_rebuild" in plan
            top = run_command(env, "cluster.scrub")
            assert "unresolved finding(s)" in top, top

            # --- the daemon routes both findings to their heals
            post_json(f"{master.url}/maintenance/enable")
            corrupt_holder = next(
                vs for vs in vols
                if vs.scrubber is not None and any(
                    f["kind"] == "corrupt_needle"
                    for f in vs.scrubber.unresolved()
                )
            )
            cv = corrupt_holder.store.get_volume(vid_n)

            def needle_healed() -> bool:
                try:  # a DIRECT local read must verify (no failover)
                    return cv._read_needle_once(key_n, None).data == data_n
                except Exception:
                    return False

            wait_until(needle_healed, timeout=40,
                       msg="corrupt needle re-copied from good replica")

            def shard_healed() -> bool:
                evx = src.store.get_ec_volume(vid_e)
                return evx is not None \
                    and len(evx.shard_ids()) == 14 \
                    and not [
                        f for f in src.scrubber.unresolved()
                        if f["kind"] == "corrupt_shard"
                    ]

            wait_until(shard_healed, timeout=40,
                       msg="corrupt shard deleted + ec_rebuild re-derived")
            # the re-derived shard is REAL: re-scrub is clean and the
            # needle reads back through the shards byte-identical
            out = post_json(f"{src.url}/admin/scrub/run",
                            {"volume": vid_e}, timeout=120)
            assert out["findings"] == [], out
            evx = src.store.get_ec_volume(vid_e)
            assert evx.read_needle(key_e).data == data_e
        finally:
            storm_stop.set()
        for t in threads:
            t.join(timeout=30)

        # --- zero client-visible errors through detect + heal
        total = results["ok"] + results["bad"]
        assert total > 30, f"storm too small to mean anything: {results}"
        assert results["bad"] == 0, results

        # --- the flight recorder resolves detect -> repair for both:
        # scrub_finding -> task_queued/task_done (scrub), and the shard's
        # delete -> ec_rebuild chain
        whyn = run_command(env, f"cluster.why {vid_n}")
        assert "scrub_finding" in whyn, whyn
        assert "corrupt_needle" in whyn, whyn
        assert "task_done" in whyn and "scrub" in whyn, whyn
        whye = run_command(env, f"cluster.why {vid_e}")
        assert "scrub_finding" in whye, whye
        assert "corrupt_shard" in whye, whye
        assert "ec_rebuild" in whye, whye

        # --- steady state: re-scrub everywhere finds nothing
        for vs in vols:
            out = post_json(f"{vs.url}/admin/scrub/run", {}, timeout=120)
            assert out["findings"] == [], out
        top = run_command(env, "cluster.scrub")
        assert "integrity clean" in top, top


class TestDisarmAllSteadyState:
    def test_disarm_all_restores_zero_injection(self, cluster):
        master, vols, env = cluster
        faults.arm("volume.read.dat", "latency", ms=1)
        faults.arm("master.assign", "latency", ms=1)
        a = assign(master)  # fires
        assert faults.disarm_all() == 2
        counts = {p: fired(p) for p in faults.ALL_POINTS}
        # a post-disarm workload injects NOTHING
        for i in range(5):
            a = assign(master)
            url = f"http://{a['publicUrl']}/{a['fid']}"
            assert http_request("POST", url, b"steady " * 50)[0] == 201
            st, _, body = http_request("GET", url + "?steady=1")
            assert st == 200 and body == b"steady " * 50
        assert {p: fired(p) for p in faults.ALL_POINTS} == counts
        assert faults.armed() == {}


@pytest.fixture(autouse=True, scope="module")
def _stop_port_history_loop():
    """The port's metered servers start the process's history loop; stop it
    when this module is done, so no thread of this file outlives it."""
    yield
    from seaweedfs_tpu_torch.stats import history

    history.default_history().stop()
