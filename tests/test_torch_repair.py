"""The port's pipelined partial-sum rebuild plane held against the JAX package.

Pure pieces on seeded inputs: `auto_chunk`, `_chunk_spans`,
`plan_rebuild_pipelined` (with `exclude` and `prefer_rebuilder`),
`describe_rebuild_pipelined` and `choose_rebuild_mode` give the JAX
package's answers; the port's fault registry fires and skips in the JAX
registry's sequence under `key`, `after` and `count`.

On port clusters (a port master and 3-5 port volume servers, all at
device="cpu"): the bare `/admin/ec/partial` returns `gf_matmul_bytes` of
the raw range with its CRC; chain rebuilds, serial and streamed, single
and multi target, leave every `.ecNN` equal to the JAX `write_ec_files`
over a copy of the `.dat` (`assert_equal_oracle`), with the wire stats of
the JAX `TestPipelinedRebuildLive`; degraded reads are served by the
partial fan-in with `RSCodec.reconstruct` never called; the retry ladder
of `tests/test_ec_repair.py` (a dead hop resumes from the committed
chunk, an exhausted chain falls back to classic with a typed reason, a
stream stall escalates typed, a duplicate chunk is ACKed, a bad chunk CRC
is refused); and a hop's or a holder's codec failure fails the verb or
the GET with no classic repair in its place and no `.tmp` left. The
tolerance throughout is byte equality.
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.shell import commands_ec as ref_ec
from seaweedfs_tpu.shell.env import ServerView as RefServerView
from seaweedfs_tpu.shell.env import ShellError as RefShellError
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.util import faults as ref_faults
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.httpd import http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, commands_ec, run_command
from seaweedfs_tpu_torch.shell.env import ServerView
from seaweedfs_tpu_torch.storage import crc as crc_mod
from seaweedfs_tpu_torch.storage.erasure_coding import decoder, geometry
from seaweedfs_tpu_torch.util import faults
from tests.test_torch_shell import (
    StubEnv,
    assert_equal_oracle,
    fid_of,
    get,
    status_nodes,
    write_blobs,
)
from tests._threads import stop_history_loops  # noqa: F401

POINT = "repair.partial_fetch"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm_all()
    ref_faults.disarm_all()
    yield
    faults.disarm_all()
    ref_faults.disarm_all()


# --- pure pieces against the JAX package ------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_auto_chunk_and_chunk_spans_equal_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 4095, 4096, 16 * 4096 + 1, 64 << 20, (64 << 20) + 3, 15 << 20]
    sizes += [int(x) for x in rng.integers(1, 1 << 30, size=8)]
    for size in sizes:
        chunk = commands_ec.auto_chunk(size)
        assert chunk == ref_ec.auto_chunk(size), size
        committed = int(rng.integers(0, max(size, 1))) // chunk * chunk
        for c in (chunk, max(1, size // int(rng.integers(2, 40)))):
            assert list(commands_ec._chunk_spans(size, committed, c)) == \
                list(ref_ec._chunk_spans(size, committed, c)), (size, committed, c)


@pytest.mark.parametrize("seed", range(4))
def test_plan_rebuild_pipelined_equals_reference(seed):
    nodes = status_nodes(seed, 3 + seed)
    port, ref = StubEnv(nodes, ServerView), StubEnv(nodes, RefServerView)
    plan = commands_ec.plan_rebuild_pipelined(port, 50, "c")
    assert plan == ref_ec.plan_rebuild_pipelined(ref, 50, "c")
    assert plan["missing"] == [2, 9] and plan["chain"][-1]["write"]
    assert commands_ec.describe_rebuild_pipelined(plan) == \
        ref_ec.describe_rebuild_pipelined(plan)
    assert commands_ec.plan_rebuild_pipelined(port, 51) is None
    assert ref_ec.plan_rebuild_pipelined(ref, 51) is None
    rng = np.random.default_rng(seed)
    holders = [node["id"] for _, _, node in nodes
               if any(e["id"] == 50 for e in node["ec_shard_infos"])]
    for _ in range(4):
        exclude = tuple(rng.choice(holders, size=int(rng.integers(0, 3)), replace=False))
        prefer = str(rng.choice(holders + ["nobody:0"]))
        try:
            want = ref_ec.plan_rebuild_pipelined(ref, 50, "c", exclude=exclude,
                                                  prefer_rebuilder=prefer)
        except RefShellError as e:
            with pytest.raises(ShellError, match="cannot rebuild"):
                commands_ec.plan_rebuild_pipelined(port, 50, "c", exclude=exclude,
                                                   prefer_rebuilder=prefer)
            assert "cannot rebuild" in str(e)
            continue
        got = commands_ec.plan_rebuild_pipelined(port, 50, "c", exclude=exclude,
                                                 prefer_rebuilder=prefer)
        assert got == want
        assert commands_ec.describe_rebuild_pipelined(got) == \
            ref_ec.describe_rebuild_pipelined(want)


@pytest.mark.parametrize("seed", range(3))
def test_choose_rebuild_mode_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hops = int(rng.integers(0, 6))
        pplan = None if rng.random() < 0.15 else {
            "chain": [{"server": f"h{i}"} for i in range(hops)],
            "missing": list(range(int(rng.integers(1, 5))))}
        pressure = None if rng.random() < 0.3 else {
            "tokens": float(rng.uniform(0, 3)),
            "in_flight": int(rng.integers(0, 5)),
            "global_limit": int(rng.integers(1, 6)),
            "per_node_limit": int(rng.integers(1, 3)),
            "node_inflight": {f"n{i}": int(rng.integers(0, 3))
                              for i in range(int(rng.integers(0, 3)))}}
        assert commands_ec.choose_rebuild_mode(pplan, pressure) == \
            ref_ec.choose_rebuild_mode(pplan, pressure)


@pytest.mark.parametrize("seed", range(4))
def test_fault_registry_sequence_equals_reference(seed):
    """The same arming and the same seeded sequence of seam keys: the port's
    point fires (raises FaultInjected) and skips exactly where the JAX
    point does, and counts the same firings."""
    rng = np.random.default_rng(seed)
    keys = ["a:1", "b:2", "c:3"]
    for _ in range(6):
        spec = dict(key=str(rng.choice(keys + [""])), after=int(rng.integers(0, 4)),
                    count=int(rng.choice([-1, 1, 2, 3])))
        faults.arm(POINT, "error", **spec)
        ref_faults.arm(POINT, "error", **spec)
        port_p, ref_p = faults.point(POINT), ref_faults.point(POINT)
        fired0 = (port_p.fired, ref_p.fired)
        for _ in range(12):
            key = None if rng.random() < 0.2 else str(rng.choice(keys))
            outcome = []
            for p, exc in ((port_p, faults.FaultInjected),
                           (ref_p, ref_faults.FaultInjected)):
                try:
                    p.hit(key=key)
                    outcome.append(False)
                except exc:
                    outcome.append(True)
            assert outcome[0] == outcome[1], (spec, key)
        assert port_p.fired - fired0[0] == ref_p.fired - fired0[1]
        assert (port_p.spec is None) == (ref_p.spec is None)
    assert faults.disarm_all() == ref_faults.disarm_all()
    with pytest.raises(ValueError, match="undeclared"):
        faults.register("volume.fastlane.undeclared")
    with pytest.raises(ValueError):
        faults.arm(POINT, "bogus")


def test_repair_sets_equal_reference_and_counters():
    from seaweedfs_tpu.storage.erasure_coding import decoder as ref_decoder

    for name in ("REPAIR_MODES", "REPAIR_FALLBACK_REASONS", "REPAIR_RESTART_REASONS",
                 "STREAM_CHUNK_STATES"):
        assert getattr(decoder, name) == getattr(ref_decoder, name), name
    c = decoder.RepairCounters()
    c.inc("bytes_on_wire", "pipelined", 5)
    c.inc("fallbacks", "chunk_crc")
    c.add_resumed(7)
    snap = c.snapshot()
    assert snap["bytes_on_wire"] == {"classic": 0, "pipelined": 5}
    assert snap["fallbacks"]["chunk_crc"] == 1 and snap["resumed_bytes"] == 7
    with pytest.raises(ValueError, match="unknown label"):
        c.inc("restarts", "too_few_holders")  # a fallback reason, not a restart one
    c.reset()
    assert not any(v for fam in ("bytes_on_wire", "fallbacks", "restarts", "stream_chunks")
                   for v in c.snapshot()[fam].values())


def test_repair_counters_lose_no_update_under_threads():
    """16 threads increment one counter with a short switch interval: the
    lock keeps every read-modify-write."""
    import sys
    import threading

    c = decoder.RepairCounters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [c.inc("stream_chunks", "written")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.snapshot()["stream_chunks"]["written"] == 16 * 2000


# --- port clusters on the CPU -------------------------------------------------------
@pytest.fixture
def clusters(tmp_path):
    """make(n) -> (master, servers, env): a port master and n port volume
    servers on racks r0..r{n-1}, device="cpu"; all stopped at teardown."""
    made = []

    def make(n: int):
        master = MasterServer(port=0, pulse_seconds=1, volume_size_limit_mb=64)
        master.start()
        made.append(master)
        servers = []
        for i in range(n):
            vs = VolumeServer([str(tmp_path / f"v{i}")], master.url, port=0,
                              rack=f"r{i}", pulse_seconds=1, max_volume_count=30,
                              device="cpu")
            vs.start()
            made.append(vs)
            servers.append(vs)
        return master, servers, CommandEnv(master.url)

    yield make
    for role in reversed(made):
        role.stop()


def encode_with_oracle(master, servers, env, tmp_path, seed=0, n_blobs=24):
    """Seeded blobs, a copy of the first blob's volume, `ec.encode` of it and
    the JAX `write_ec_files` over the copy. Returns (vid, {url: data},
    oracle base)."""
    blobs = write_blobs(master.url, n_blobs, seed)
    vid = int(fid_of(next(iter(blobs))).split(",")[0])
    in_vol = {u: d for u, d in blobs.items() if fid_of(u).startswith(f"{vid},")}
    holder = next(vs for vs in servers if vs.store.get_volume(vid) is not None)
    base = holder.store.get_volume(vid).base_name
    os.makedirs(tmp_path / "oracle", exist_ok=True)
    obase = str(tmp_path / "oracle" / str(vid))
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, obase + ext)
    assert run_command(env, "lock") == "lock acquired"
    assert "shards spread" in run_command(env, f"ec.encode -volumeId {vid}")
    ref_encoder.write_ec_files(obase, codec=RefCodec(backend="numpy"))
    ref_encoder.write_sorted_file_from_idx(obase)
    ref_encoder.save_volume_info(obase + ".vif", version=3)
    return vid, in_vol, obase


def server_of(servers, server_id: str) -> VolumeServer:
    return next(vs for vs in servers if vs.url == f"http://{server_id}")


def lose(env, vid, shards) -> list[int]:
    """Delete `shards` of `vid` from whichever servers hold them."""
    lost = []
    for sv in env.servers():
        drop = [s for s in sv.ec_shards.get(vid, []) if s in shards]
        if drop:
            post_json(f"{sv.http}/admin/ec/delete_shards", {"volume": vid, "shards": drop})
            lost += drop
    return sorted(lost)


def lose_holder_of(env, vid, shard) -> list[int]:
    """Delete every shard of `vid` on the server that holds `shard`."""
    sv = next(s for s in env.servers() if shard in s.ec_shards.get(vid, []))
    return lose(env, vid, list(sv.ec_shards[vid]))


def shard_holders(env, vid) -> dict:
    return {sv.id: sorted(sv.ec_shards[vid]) for sv in env.servers()
            if sv.ec_shards.get(vid)}


def no_tmp_left(servers) -> bool:
    return not any(name.endswith(".tmp") for vs in servers
                   for name in os.listdir(vs.store.locations[0].directory))


def test_ranged_partial_endpoint_equals_reference(clusters, tmp_path):
    """A bare /admin/ec/partial answers the coefficient-scaled range straight
    back, stamped with its CRC32C: one target over one shard, and two
    targets over every shard the holder has."""
    master, servers, env = clusters(3)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path)
    rng = np.random.default_rng(5)
    for sv in env.servers():
        own = sorted(sv.ec_shards.get(vid, []))
        if not own:
            continue
        off, size = int(rng.integers(0, 4096)), int(rng.integers(1, 8192))
        raw = []
        for s in own:
            with open(obase + geometry.to_ext(s), "rb") as f:
                f.seek(off)
                raw.append(np.frombuffer(f.read(size), dtype=np.uint8))
        for coefs in ({own[0]: [7]},
                      {s: [int(c) for c in rng.integers(0, 256, 2)] for s in own}):
            n_t = len(next(iter(coefs.values())))
            url = (f"{sv.http}/admin/ec/partial?volume={vid}&offset={off}&size={size}"
                   f"&targets={','.join(str(t) for t in range(n_t))}"
                   f"&coefs={urllib.parse.quote(json.dumps({str(k): v for k, v in coefs.items()}))}")
            status, hdrs, body = http_request("POST", url, b"")
            assert status == 200 and len(body) == n_t * size
            assert int(hdrs["X-Repair-Crc"]) == crc_mod.crc32c(body)
            m = np.array([coefs[s] for s in sorted(coefs)], dtype=np.uint8).T
            rows = np.stack([raw[own.index(s)] for s in sorted(coefs)])
            assert body == ref_gf256.gf_matmul_bytes(m, rows).tobytes()


@pytest.mark.parametrize("targets", ["single", "multi"])
@pytest.mark.parametrize("stream", [False, True])
def test_pipelined_rebuild_equals_reference(clusters, tmp_path, stream, targets):
    """A pipelined chain rebuild, serial or streamed, of one lost shard or of
    a whole holder's shards: every shard, .ecx and .vif equals the JAX
    write_ec_files; one stacked partial crosses each hop link, each use
    shard is read once, the rebuilder receives targets x shard size."""
    master, servers, env = clusters(4)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path, seed=1)
    lost = lose(env, vid, [0]) if targets == "single" else lose_holder_of(env, vid, 0)
    wire0 = decoder.REPAIR.snapshot()
    out = commands_ec.run_rebuild(env, vid, mode="pipelined", stream=stream)
    stats = out["stats"]
    assert out["mode"] == "pipelined" and sorted(out["rebuilt"]) == lost
    assert stats["streamed"] is stream and stats["restarts"] == 0
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    shard_size = stats["shard_size"]
    assert shard_size == os.path.getsize(obase + ".ec00")
    assert stats["bytes_on_wire_total"] == (stats["hops"] - 1) * len(lost) * shard_size
    assert stats["bytes_on_wire_rebuilder"] == len(lost) * shard_size
    assert stats["survivor_bytes_read"] == 10 * shard_size
    chunks = len(list(commands_ec._chunk_spans(shard_size, 0,
                                               commands_ec.auto_chunk(shard_size))))
    wire = decoder.REPAIR.snapshot()
    assert wire["bytes_on_wire"]["pipelined"] - wire0["bytes_on_wire"]["pipelined"] \
        >= stats["bytes_on_wire_total"]
    if stream:
        assert wire["stream_chunks"]["written"] - wire0["stream_chunks"]["written"] == chunks
    assert no_tmp_left(servers)


def test_degraded_reads_fan_in_partials(clusters, tmp_path, monkeypatch):
    """With a holder's shards gone, every needle on them reads equal from the
    other servers through the partial fan-in: partial_served counts each
    reconstructed interval, no fallback, and RSCodec.reconstruct (the
    classic ladder's decode) is never called."""
    master, servers, env = clusters(4)
    vid, in_vol, _ = encode_with_oracle(master, servers, env, tmp_path, seed=2)
    victim = next(sv for sv in env.servers() if 0 in sv.ec_shards.get(vid, []))
    lose_holder_of(env, vid, 0)
    calls = []
    monkeypatch.setattr(RSCodec, "reconstruct",
                        lambda *a, **kw: calls.append(a) or {})
    wire0 = decoder.REPAIR.snapshot()["bytes_on_wire"]["pipelined"]
    others = [vs for vs in servers if vs.url != victim.http]
    for vs in others:
        for url, data in in_vol.items():
            assert get(f"{vs.url}/{fid_of(url)}") == (200, data), vs.url
    evs = [vs.store.get_ec_volume(vid) for vs in others]
    assert sum(ev.partial_served for ev in evs) >= len(others)
    assert not any(ev.partial_fallbacks for ev in evs)
    assert not calls
    assert decoder.REPAIR.snapshot()["bytes_on_wire"]["pipelined"] > wire0


def test_partial_fetcher_declines_fall_to_classic_ladder(clusters, tmp_path, monkeypatch):
    """A holder that refuses its partial (an injected fault at its seam) makes
    the fetcher decline: the read falls to the classic ladder, reads equal,
    and the fallback is counted with its reason."""
    master, servers, env = clusters(4)
    vid, in_vol, _ = encode_with_oracle(master, servers, env, tmp_path, seed=3)
    victim = next(sv for sv in env.servers() if 0 in sv.ec_shards.get(vid, []))
    lose_holder_of(env, vid, 0)
    reader = next(vs for vs in servers if vs.url != victim.http)
    faults.arm(POINT, "error")  # every holder refuses
    for url, data in in_vol.items():
        assert get(f"{reader.url}/{fid_of(url)}") == (200, data)
    ev = reader.store.get_ec_volume(vid)
    assert ev.partial_served == 0
    assert ev.partial_fallbacks.get("holder_refused", 0) > 0


# --- the retry ladder (tests/test_ec_repair.py's cases) ---------------------------
def test_dead_hop_resumes_from_committed_chunk(clusters, tmp_path):
    master, servers, env = clusters(5)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path, seed=4)
    lose(env, vid, [2])
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    assert len(pplan["chain"]) >= 4
    shard_size = os.path.getsize(obase + ".ec02")
    chunk = max(4096, shard_size // 16)
    # kill a MID hop (not the writer) once a few chunks passed through it
    faults.arm(POINT, "error", key=pplan["chain"][1]["server"], after=6)
    before = decoder.REPAIR.snapshot()
    rebuilt, stats = commands_ec.apply_rebuild_pipelined(env, pplan, chunk=chunk, stream=True)
    faults.disarm_all()
    after = decoder.REPAIR.snapshot()
    assert rebuilt == [2] and stats["restarts"] >= 1
    assert stats["resumed_bytes_saved"] > 0
    assert after["resumed_bytes"] - before["resumed_bytes"] > 0
    assert sum(after["restarts"].values()) > sum(before["restarts"].values())
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    assert no_tmp_left(servers)


def test_exhausted_chain_falls_back_to_classic(clusters, tmp_path):
    """3 servers: killing the chain's head leaves fewer than 10 usable
    shards, so the pipelined attempt raises the typed fallback; the verb
    (auto picks pipelined on 3 hops) then repairs by classic."""
    master, servers, env = clusters(3)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path, seed=5)
    lose(env, vid, [4])
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    faults.arm(POINT, "error", key=pplan["chain"][0]["server"])
    with pytest.raises(commands_ec.PipelinedRebuildError) as ei:
        commands_ec.apply_rebuild_pipelined(env, pplan)
    assert ei.value.reason in decoder.REPAIR_FALLBACK_REASONS
    before = decoder.REPAIR.snapshot()["fallbacks"]
    out = run_command(env, f"ec.rebuild -volumeId {vid}")
    assert "(classic)" in out
    after = decoder.REPAIR.snapshot()["fallbacks"]
    assert sum(after.values()) == sum(before.values()) + 1
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    assert no_tmp_left(servers)


def test_stream_stall_escalates_typed(clusters, tmp_path):
    master, servers, env = clusters(3)
    vid, _, _ = encode_with_oracle(master, servers, env, tmp_path, seed=6)
    lose(env, vid, [4])
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    assert len(pplan["chain"]) >= 2
    faults.arm(POINT, "latency", ms=600.0, key=pplan["chain"][1]["server"])
    stalled0 = decoder.REPAIR.snapshot()["stream_chunks"]["stalled"]
    with pytest.raises(commands_ec.PipelinedRebuildError) as ei:
        commands_ec.apply_rebuild_pipelined(env, pplan, chunk=4096, stream=True,
                                            window=1, stall_timeout=0.05)
    assert ei.value.reason == "stream_stall"
    assert decoder.REPAIR.snapshot()["stream_chunks"]["stalled"] > stalled0


def test_slow_drain_closes_without_restart(clusters, tmp_path):
    """A writer that lands each chunk slowly (2.5 s) but never stalls past
    the stall budget: the close waits for every hop's queue to drain, so the
    stream commits whole with no chain restart and the rebuilder receives
    exactly one stacked partial. Before the drain wait, a hop's close gave
    up on its forwarder after a fixed 10 s and cascaded while chunks were
    still queued: the writer's frontier fell short and the chain
    restarted."""
    master, servers, env = clusters(4)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path, seed=9)
    lost = lose(env, vid, [0, 4])
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    assert len(pplan["chain"]) >= 3
    start = post_json(f"{pplan['rebuilder_url']}/admin/ec/partial/start",
                      {"volume": vid, "targets": pplan["missing"]})
    shard_size = int(start["shard_size"])
    chunk = -(-shard_size // 6)
    # the writer's open passes; each of its 6 chunks takes 2.5 s to land
    faults.arm(POINT, "latency", ms=2500.0, key=pplan["chain"][-1]["server"], after=1)
    rebuilt, stats = commands_ec.apply_rebuild_pipelined(env, pplan, chunk=chunk,
                                                         stream=True)
    faults.disarm_all()
    assert sorted(rebuilt) == lost and stats["restarts"] == 0
    assert stats["bytes_on_wire_rebuilder"] == len(lost) * shard_size
    assert stats["bytes_on_wire_total"] == (stats["hops"] - 1) * len(lost) * shard_size
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))
    assert no_tmp_left(servers)


def open_terminal_session(env, vid, session):
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    rb = pplan["rebuilder_url"]
    assert post_json(f"{rb}/admin/ec/partial/start", {"volume": vid, "targets": [0]})["ok"]
    status, _, body = http_request(
        "POST", f"{rb}/admin/ec/partial/stream/open",
        json.dumps({"session": session, "volume": vid, "targets": [0],
                    "chain": [pplan["chain"][-1]]}).encode())
    assert status == 200, body
    return rb


def test_duplicate_chunk_acked_out_of_order_refused(clusters, tmp_path):
    master, servers, env = clusters(3)
    vid, _, _ = encode_with_oracle(master, servers, env, tmp_path, seed=7)
    lose(env, vid, [0])
    rb = open_terminal_session(env, vid, "duptest")
    url = f"{rb}/admin/ec/partial/stream/chunk?session=duptest&seq=0&offset=0&size=256"
    status, _, body = http_request("POST", url, b"")
    assert status == 200 and json.loads(body)["committed"] == 256
    status, _, body = http_request("POST", url, b"")  # the retry: ACKed again
    dup = json.loads(body)
    assert status == 200 and dup["ok"] and dup["duplicate"] and dup["committed"] == 256
    status, _, body = http_request(
        "POST", f"{rb}/admin/ec/partial/stream/chunk?session=duptest&seq=3"
        "&offset=1024&size=256", b"")
    assert status == 409, body
    http_request("POST", f"{rb}/admin/ec/partial/stream/close?session=duptest", b"")
    assert post_json(f"{rb}/admin/ec/partial/abort", {"volume": vid})["aborted"]
    assert no_tmp_left(servers)


def test_chunk_crc_refused(clusters, tmp_path):
    master, servers, env = clusters(3)
    vid, _, _ = encode_with_oracle(master, servers, env, tmp_path, seed=8)
    lose(env, vid, [0])
    rb = open_terminal_session(env, vid, "crctest")
    crc0 = decoder.REPAIR.snapshot()["stream_chunks"]["crc_failed"]
    status, _, body = http_request(
        "POST", f"{rb}/admin/ec/partial/stream/chunk?session=crctest&seq=0&offset=0&size=256",
        b"\x00" * 256, headers={"X-Repair-Crc": "12345"})
    assert status == 409 and json.loads(body)["error"] == "chunk_crc"
    assert decoder.REPAIR.snapshot()["stream_chunks"]["crc_failed"] == crc0 + 1
    # the commit refuses a half-landed rebuild
    status, _, body = http_request("POST", f"{rb}/admin/ec/partial/commit",
                                   json.dumps({"volume": vid}).encode())
    assert status == 409 and json.loads(body)["error"] == "rebuild incomplete"
    http_request("POST", f"{rb}/admin/ec/partial/stream/close?session=crctest", b"")
    post_json(f"{rb}/admin/ec/partial/abort", {"volume": vid})


# --- a codec failure is an error, never a quiet classic repair ---------------------
class RecordingEnv(CommandEnv):
    def __init__(self, master_url: str) -> None:
        super().__init__(master_url)
        self.urls: list[str] = []

    def post(self, url, payload=None, timeout=300):
        self.urls.append(url)
        return super().post(url, payload, timeout)


def boom(*a, **kw):
    raise RuntimeError("codec failed")


@pytest.mark.parametrize("stream", ["true", "false"])
def test_hop_codec_failure_fails_rebuild(clusters, tmp_path, stream):
    """A mid-chain hop's codec raises: the verb raises ShellError naming
    codec_failed and the hop; no classic /admin/ec/copy or /admin/ec/rebuild
    is posted, the partial state is aborted and no .tmp remains. With the
    codec back, the same verb repairs byte-equal."""
    master, servers, _ = clusters(4)
    env = RecordingEnv(master.url)
    vid, _, obase = encode_with_oracle(master, servers, env, tmp_path, seed=9)
    lose_holder_of(env, vid, 0)
    pplan = commands_ec.plan_rebuild_pipelined(env, vid, "")
    assert len(pplan["chain"]) == 3
    hop = pplan["chain"][1]["server"]
    ev = server_of(servers, hop).store.get_ec_volume(vid)
    ev.codec.apply2d_async = boom
    env.urls.clear()
    with pytest.raises(ShellError, match=f"codec_failed on hop {hop}.*codec failed"):
        run_command(env, f"ec.rebuild -volumeId {vid} -stream {stream}")
    assert not any(u.endswith(("/admin/ec/copy", "/admin/ec/rebuild")) for u in env.urls)
    assert env.urls[-1].endswith("/admin/ec/partial/abort")
    assert no_tmp_left(servers)
    del ev.codec.apply2d_async
    out = run_command(env, f"ec.rebuild -volumeId {vid} -stream {stream}")
    assert "(pipelined" in out
    assert assert_equal_oracle(servers, vid, obase) == list(range(14))


def test_holder_codec_failure_fails_degraded_get(clusters, tmp_path, monkeypatch):
    """A remote holder's codec raises while it scales its ranged partial:
    the degraded GET is a 500 and the classic ladder does not run."""
    master, servers, env = clusters(4)
    vid, in_vol, _ = encode_with_oracle(master, servers, env, tmp_path, seed=10)
    victim = next(sv for sv in env.servers() if 0 in sv.ec_shards.get(vid, []))
    lose_holder_of(env, vid, 0)
    others = [vs for vs in servers if vs.url != victim.http]
    reader, sick = others[0], others[1]
    sick.store.get_ec_volume(vid).codec.apply2d_async = boom
    calls = []
    monkeypatch.setattr(RSCodec, "reconstruct", lambda *a, **kw: calls.append(a) or {})
    url = next(iter(in_vol))
    status, body = get(f"{reader.url}/{fid_of(url)}")
    assert status == 500 and b"codec failed" in body
    assert not calls
    assert not reader.store.get_ec_volume(vid).partial_fallbacks


def test_hop_failure_detail_reaches_the_warning_whole(monkeypatch, caplog):
    """A hop's answer puts its detail first and whole into the restart
    warning, however long: the cause of a stalled forward (a timeout, a
    refusal or a reset, and its elapsed ms) must not be cut away."""
    detail = ("ConnectionResetError: [Errno 104] Connection reset by peer after 30012.5 ms; "
              + "x" * 400)
    resp = {"received": 7, "read": 7, "committed": 6, "error": "hop_unreachable",
            "failed_hop_server": "127.0.0.1:1", "chunk": 6, "detail": detail}
    err = commands_ec._hop_failed(resp, "127.0.0.1:1")
    assert err.detail.startswith(detail) and len(detail) > 300
    calls = []

    def chain(env, plan, chunk, restarts, **kw):
        calls.append(restarts)
        if restarts == 0:
            raise err
        return [3], {"restarts": restarts}

    monkeypatch.setattr(commands_ec, "_run_chain", chain)
    monkeypatch.setattr(commands_ec, "plan_rebuild_pipelined",
                        lambda env, vid, coll, **kw: {**plan, "chain": []})
    monkeypatch.setattr(commands_ec, "_abort", lambda *a: None)
    plan = {"volume": 5, "collection": "", "rebuilder_url": "http://127.0.0.1:2",
            "rebuilder": "127.0.0.1:2", "chain": [], "missing": [3]}
    with caplog.at_level("WARNING", logger=commands_ec.log.name):
        assert commands_ec.apply_rebuild_pipelined(None, plan) == ([3], {"restarts": 1})
    assert calls == [0, 1]
    warned = [r.getMessage() for r in caplog.records if "chain restart" in r.getMessage()]
    assert len(warned) == 1 and detail in warned[0]


def test_forward_failure_detail_names_the_cause_and_its_ms(monkeypatch):
    """The volume server's forward records the exception's type, its whole
    text and the forward's elapsed ms in the session's error detail."""
    from seaweedfs_tpu_torch.server import volume as volume_mod

    text = "timed out " + "y" * 300

    class Policy:
        deadline = 1.0

        @staticmethod
        def call(fn):
            raise TimeoutError(text)

    monkeypatch.setattr(volume_mod, "READ_POLICY", Policy)
    state = {"error": None}
    volume_mod.VolumeServer._forward_one(None, state, {"server": "127.0.0.1:3"},
                                         "http://127.0.0.1:3/x?a=1", (4, 0, 3, b"abc"))
    err = state["error"]
    assert err["error"] == "hop_unreachable" and err["chunk"] == 4
    assert err["failed_hop_server"] == "127.0.0.1:3"
    assert err["detail"].startswith(f"TimeoutError: {text} after ")
    assert err["detail"].endswith(" ms")
