"""The port's integrity scrubber (`seaweedfs_tpu_torch/maintenance/scrub.py`)
held against the JAX package's on the same seeded volumes.

Each comparison builds the same volume through both packages' `Volume`
(each needle module on its own copy of one deterministic clock, so the
.dat files are equal byte for byte), damages both the same way, and runs
both `VolumeScrubber.scrub_pass`: the findings (kind, volume, needle,
shard, detail), `needles_checked`, `stripes_checked` and `bytes_scanned`
must be equal. The port runs on `device="cpu"` (the plain PyTorch
versions of `crc32c_batch` and `gf256_matmul`). Also held against the JAX
package: `TokenBucket` and the scrubber's pacing under an injected clock,
`_crc_batch_ok`'s legacy-CRC rule, `detect` over the same heartbeats (the
JAX's divergence cases), and `plan_scrub_repairs` / `describe_scrub_repairs`
/ `apply_scrub_repairs` over a stub env. A CRC kernel or codec that raises
fails the pass (`ScrubCodecFailed`) instead of going scalar or being
skipped. Exact comparisons throughout (tolerance 0).
"""

from __future__ import annotations

import itertools
import os
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.shell.env import ServerView as RefServerView
from seaweedfs_tpu.storage import needle as ref_needle_mod
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.online import OnlineEcWriter as RefWriter
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.topology import Topology as RefTopology
from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.ops.rs_kernel import RSCodec
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import ServerView
from seaweedfs_tpu_torch.storage import crc as crc_mod
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage.erasure_coding import encoder, geometry
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import NEEDLE_HEADER_SIZE
from seaweedfs_tpu_torch.topology import Topology
from tests._threads import stop_history_loops  # noqa: F401

BLOCK = 4096
EQUAL = 1500  # the equal-length group's data size
N_EQUAL = 24  # >= MIN_BATCH: the batched kernel takes it


@pytest.fixture
def clock(monkeypatch):
    """The same deterministic time_ns sequence for each package's needles."""
    for mod in (needle_mod, ref_needle_mod):
        ticks = itertools.count(1_700_000_000_000_000_000, 1_000)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time_ns=lambda t=ticks: next(t)))


def flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def poke(path: str, offset: int, data: bytes) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(data)


class Pair:
    """A port Store (device="cpu") and a JAX Store over two directories,
    written in lock step."""

    def __init__(self, root) -> None:
        self.dirs = (os.path.join(root, "port"), os.path.join(root, "ref"))
        self.st = Store([self.dirs[0]], device="cpu")
        self.rst = RefStore([self.dirs[1]])

    def add(self, vid: int, **kw):
        return self.st.add_volume(vid, "", **kw), self.rst.add_volume(vid, "", **kw)

    def write(self, vid: int, nid: int, data: bytes) -> None:
        self.st.write(vid, Needle(cookie=0x55, id=nid, data=data))
        self.rst.write(vid, RefNeedle(cookie=0x55, id=nid, data=data))

    def paths(self, vid: int, ext: str) -> tuple[str, str]:
        return tuple(os.path.join(d, f"{vid}{ext}") for d in self.dirs)

    def scrubbers(self, **kw):
        kw.setdefault("rate_mb", 0)
        return (scrub.VolumeScrubber(self.st, node_id="n1", **kw),
                ref_scrub.VolumeScrubber(self.rst, node_id="n1", **kw))

    def close(self) -> None:
        self.st.close()
        self.rst.close()


@pytest.fixture
def pair(tmp_path, clock):
    p = Pair(str(tmp_path))
    yield p
    p.close()


def findings(fs) -> list[tuple]:
    return sorted((f.kind, f.volume_id, f.node, f.needle, f.shard, f.detail)
                  for f in fs)


def assert_same_pass(sc, rsc, volume_id=None) -> list:
    got = sc.scrub_pass(volume_id)
    want = rsc.scrub_pass(volume_id)
    assert findings(got) == findings(want)
    for key in ("needles_checked", "stripes_checked", "bytes_scanned",
                "findings", "resolved", "tmp_removed", "passes"):
        assert sc.stats[key] == rsc.stats[key], key
    assert sorted(f["kind"] for f in sc.unresolved()) == \
        sorted(f["kind"] for f in rsc.unresolved())
    return got


def fill_mixed(p: Pair, vid: int, seed: int) -> dict:
    """N_EQUAL needles of EQUAL bytes, then 19 of log-uniform sizes.
    Returns {needle id: data}."""
    rng = np.random.default_rng(seed)
    out = {}
    for nid in range(1, N_EQUAL + 1):
        out[nid] = rng.bytes(EQUAL)
    for nid in range(N_EQUAL + 1, N_EQUAL + 20):
        out[nid] = rng.bytes(int(np.exp(rng.uniform(np.log(10), np.log(20000)))))
    for nid, data in out.items():
        p.write(vid, nid, data)
    return out


def record_at(p: Pair, vid: int, nid: int) -> tuple[int, int]:
    off, size = p.st.get_volume(vid).nm.get(nid)
    assert p.rst.get_volume(vid).nm.get(nid) == (off, size)
    return off, size


def test_needle_scrub_equals_reference(pair):
    pair.add(1)
    data = fill_mixed(pair, 1, seed=3)
    for ext in (".dat", ".idx"):
        a, b = pair.paths(1, ext)
        assert open(a, "rb").read() == open(b, "rb").read()
    sc, rsc = pair.scrubbers()
    assert assert_same_pass(sc, rsc) == []
    assert sc.stats["needles_checked"] == len(data)
    # the equal-length group went through the batched kernel, the rest scalar
    assert sc.counters["bytes"]["batched"] == N_EQUAL * EQUAL
    assert sc.counters["bytes"]["scalar"] == sum(map(len, data.values())) - N_EQUAL * EQUAL
    # a needle stored under the legacy CRC value (one in the batched group,
    # one scalar) verifies clean on both sides
    for nid in (5, N_EQUAL + 3):
        off, size = record_at(pair, 1, nid)
        actual = crc_mod.crc32c(data[nid])
        for path in pair.paths(1, ".dat"):
            poke(path, off + NEEDLE_HEADER_SIZE + size,
                 crc_mod.legacy_value(actual).to_bytes(4, "big"))
    assert assert_same_pass(sc, rsc) == []
    # the same bytes flipped in both: two in the batched group, one scalar,
    # and one record torn (its data-size field past the record)
    for nid in (2, 9, N_EQUAL + 5):
        off, size = record_at(pair, 1, nid)
        for path in pair.paths(1, ".dat"):
            flip(path, off + NEEDLE_HEADER_SIZE + 4 + 100)
    off, _ = record_at(pair, 1, N_EQUAL + 7)
    for path in pair.paths(1, ".dat"):
        poke(path, off + NEEDLE_HEADER_SIZE, b"\xff\xff\xff\x00")
    got = assert_same_pass(sc, rsc)
    assert sorted(f.needle for f in got) == [2, 9, N_EQUAL + 5, N_EQUAL + 7]
    assert {f.kind for f in got} == {"corrupt_needle"}
    assert sc.counters["findings"]["corrupt_needle"] == 4
    # a repair resolves on both sides, and the next pass reproduces the rest
    assert sc.resolve(kind="corrupt_needle", needle=2) == rsc.resolve(
        kind="corrupt_needle", needle=2) == 1
    assert_same_pass(sc, rsc)


def test_needle_scrub_batch_bytes_and_scoping_equal_reference(pair):
    for vid in (1, 2):
        pair.add(vid)
        fill_mixed(pair, vid, seed=vid)
    sc, rsc = pair.scrubbers(batch_bytes=8 * 1024)  # many flushes
    off, _ = record_at(pair, 2, 4)
    for path in pair.paths(2, ".dat"):
        flip(path, off + NEEDLE_HEADER_SIZE + 4 + 7)
    assert findings(assert_same_pass(sc, rsc, volume_id=1)) == []
    got = assert_same_pass(sc, rsc, volume_id=2)
    assert [(f.volume_id, f.needle) for f in got] == [(2, 4)]
    # small flushes break the equal-length group below MIN_BATCH: scalar
    assert sc.counters["bytes"]["batched"] == 0


@pytest.mark.parametrize("stored", ["actual", "legacy", "other"])
def test_batched_legacy_rule_equals_scalar(stored):
    rng = np.random.default_rng(11)
    datas = [rng.bytes(700) for _ in range(scrub.MIN_BATCH)]
    crcs = [crc_mod.crc32c(d) for d in datas]
    want = {"actual": crcs, "legacy": [crc_mod.legacy_value(c) for c in crcs],
            "other": [c ^ 1 for c in crcs]}[stored]
    ok_b, kernel = scrub._crc_batch_ok(datas, want, "cpu")
    # a group of one stays under MIN_BATCH: the scalar rule, per needle
    scalar = [scrub._crc_batch_ok([d], [w], "cpu") for d, w in zip(datas, want)]
    ok_ref, _ = ref_scrub._crc_batch_ok(datas, want, False)
    assert kernel == "batched" and {k for _, k in scalar} == {"scalar"}
    assert ok_b == [ok[0] for ok, _ in scalar] == ok_ref == [stored != "other"] * len(datas)


def sealed_pair(pair: Pair):
    """Volume 1 written in both, encoded at BLOCK, all 14 shards local and
    mounted."""
    v, rv = pair.add(1)
    fill_mixed(pair, 1, seed=5)
    encoder.write_ec_files(v.base_name, codec=RSCodec(device="cpu"),
                           large_block_size=BLOCK, small_block_size=BLOCK)
    ref_encoder.write_ec_files(rv.base_name, codec=RefCodec(backend="numpy"),
                               large_block_size=BLOCK, small_block_size=BLOCK)
    for enc, base in ((encoder, v.base_name), (ref_encoder, rv.base_name)):
        enc.write_sorted_file_from_idx(base)
    for ext in [geometry.to_ext(s) for s in range(14)] + [".ecx"]:
        a, b = pair.paths(1, ext)
        assert open(a, "rb").read() == open(b, "rb").read(), ext
    return pair.st.mount_ec_volume(1, ""), pair.rst.mount_ec_volume(1, "")


@pytest.mark.parametrize("damage", ["clean", "flip", "short", "two_flips"])
def test_sealed_ec_scrub_equals_reference(pair, damage):
    ev, rev = sealed_pair(pair)
    if damage == "flip":
        for path in pair.paths(1, geometry.to_ext(3)):
            flip(path, 10)
    elif damage == "short":
        for path in pair.paths(1, geometry.to_ext(12)):
            os.truncate(path, os.path.getsize(path) - 100)
    elif damage == "two_flips":
        for s in (2, 7):
            for path in pair.paths(1, geometry.to_ext(s)):
                flip(path, 20)
    sc, rsc = pair.scrubbers()
    got = [f for f in assert_same_pass(sc, rsc) if f.kind == "corrupt_shard"]
    want = {"clean": [], "flip": [3], "short": [12], "two_flips": [None]}[damage]
    assert [f.shard for f in got] == want
    if damage in ("clean", "flip", "two_flips"):
        assert sc.stats["stripes_checked"] > 0 and sc.counters["bytes"]["gf"] > 0
    if damage == "flip":
        # the locator: one encode, then a reconstruct and an encode a
        # suspect up to shard 3, each its own codec call
        assert sc.counters["codec_calls"] == 1 + 2 * 4


def test_online_parity_scrub_equals_reference(pair):
    v = pair.st.add_volume(1, "", ec_online=True, ec_online_block=BLOCK)
    rv = pair.rst.add_volume(1, "")
    rv.online_ec = RefWriter(rv, block_size=BLOCK, codec=RefCodec(backend="numpy"))
    fill_mixed(pair, 1, seed=8)
    v.online_ec.pump(force=True)
    rv.online_ec.pump(force=True)
    assert v.online_ec.watermark == rv.online_ec.watermark >= 2 * v.online_ec.stripe
    sc, rsc = pair.scrubbers()
    assert [f for f in assert_same_pass(sc, rsc) if f.kind == "parity_mismatch"] == []
    for path in pair.paths(1, geometry.to_ext(10)):
        flip(path, 5)
    got = [f for f in assert_same_pass(sc, rsc) if f.kind == "parity_mismatch"]
    assert len(got) == 1 and got[0].detail == "stripe row 0: recomputed parity disagrees"
    v.online_ec.rearm()
    rv.online_ec.rearm()
    assert [f for f in assert_same_pass(sc, rsc) if f.kind == "parity_mismatch"] == []


def test_tmp_litter_gated_by_age_and_ownership(pair):
    pair.add(1)
    names = ("7.ec03.tmp", "7.ec04.tmp", "7.ec05.tmp", "notashard.tmp")
    old = time.time() - 7200
    for d in pair.dirs:
        for name in names:
            with open(os.path.join(d, name), "wb") as f:
                f.write(b"x" * 64)
            if name != "7.ec04.tmp":
                os.utime(os.path.join(d, name), (old, old))
    sc = scrub.VolumeScrubber(pair.st, rate_mb=0, tmp_max_age=3600.0,
                              active_tmp_paths=lambda: {os.path.join(pair.dirs[0], names[2])})
    rsc = ref_scrub.VolumeScrubber(pair.rst, rate_mb=0, tmp_max_age=3600.0,
                                   active_tmp_paths=lambda: {os.path.join(pair.dirs[1], names[2])})
    assert_same_pass(sc, rsc)
    for d in pair.dirs:
        assert sorted(os.listdir(d)) == sorted(["1.dat", "1.idx", *names[1:]])
    assert sc.stats["tmp_removed"] == 1
    assert sc.counters["findings"]["tmp_litter"] == sc.counters["repairs"]["tmp_litter"] == 1


def test_server_keeps_an_in_flight_rebuilds_tmp(tmp_path):
    """The volume server's scrubber asks `_active_rebuild_tmps`: an aged
    tmp of a pipelined rebuild still in `_partial_rebuilds` stays, the
    same file abandoned is swept."""
    vs = VolumeServer([str(tmp_path)], device="cpu")
    vs.start()
    try:
        writers = encoder._ShardWriters(str(tmp_path / "9"), 4096, shard_ids=[2, 5])
        with vs._partial_lock:
            vs._partial_rebuilds[9] = {"writers": writers, "targets": [2, 5],
                                       "shard_size": 4096, "collection": "",
                                       "committed": 0}
        old = time.time() - 7200
        for path in writers.tmp_paths.values():
            os.utime(path, (old, old))
        assert vs._active_rebuild_tmps() == set(writers.tmp_paths.values())
        vs.scrubber.scrub_pass()
        assert all(os.path.exists(p) for p in writers.tmp_paths.values())
        with vs._partial_lock:
            vs._partial_rebuilds.pop(9)
        for fd in writers.fds.values():
            os.close(fd)
        writers.fds.clear()
        vs.scrubber.scrub_pass()
        assert not any(os.path.exists(p) for p in writers.tmp_paths.values())
        assert vs.scrubber.stats["tmp_removed"] == 2
    finally:
        vs.stop()


@pytest.mark.parametrize("steps", [
    [(0.0, 100)],
    [(0.0, 400), (0.5, 10)],
    [(0.0, 1000), (0.1, 50), (0.2, 50), (5.0, 10)],
    [(1.0, 300), (1.0, 300), (1.5, 300), (4.0, 2000)],
])
def test_token_bucket_equals_reference(steps):
    for rate, burst in ((1000.0, None), (500.0, 200.0), (0.0, None)):
        b, rb = scrub.TokenBucket(rate, burst), ref_scrub.TokenBucket(rate, burst)
        for now, n in steps:
            assert b.take(n, now) == rb.take(n, now)


def test_scrubber_pacing_under_injected_clock_equals_reference(pair):
    pair.add(1)
    fill_mixed(pair, 1, seed=2)
    sleeps = ([], [])
    clocks = [itertools.count(0.0, 0.001), itertools.count(0.0, 0.001)]
    sc = scrub.VolumeScrubber(pair.st, rate_mb=0.01, now=lambda: next(clocks[0]),
                              sleep=sleeps[0].append)
    rsc = ref_scrub.VolumeScrubber(pair.rst, rate_mb=0.01, now=lambda: next(clocks[1]),
                                   sleep=sleeps[1].append)
    assert_same_pass(sc, rsc)
    assert sleeps[0] == sleeps[1] and sleeps[0]
    assert sc.stats["throttle_waits"] == rsc.stats["throttle_waits"] == len(sleeps[0])


# --- detect over the same heartbeats ------------------------------------------
def beat(topos, port, volumes, findings=None):
    for topo in topos:
        topo.sync_heartbeat({
            "ip": "127.0.0.1", "port": port, "public_url": "",
            "max_file_key": 0, "max_volume_count": 10,
            "volumes": volumes, "ec_shards": [],
            **({"scrub_findings": findings} if findings is not None else {}),
        })


def vol(vid, size, digest, ec_online=False):
    return {"id": vid, "size": size, "file_count": 3, "replica_placement": 1,
            "needle_digest": digest, "ec_online": ec_online}


EMPTY = "0" * 16
DIVERGENCE_CASES = {
    "agree": [(8081, [vol(5, 1000, "aa")]), (8082, [vol(5, 1000, "aa")])],
    "empty_replica": [(8081, [vol(5, 1000, "aa")]), (8082, [vol(5, 8, EMPTY)])],
    "empty_majority": [(8081, [vol(5, 1000, "aa")]), (8082, [vol(5, 8, EMPTY)]),
                       (8083, [vol(5, 8, EMPTY)])],
    "majority_source": [(8081, [vol(5, 1000, "aa")]), (8082, [vol(5, 1100, "aa")]),
                        (8083, [vol(5, 900, "bb")])],
    "two_way_tie": [(8081, [vol(5, 2000, "aa")]), (8082, [vol(5, 1000, "bb")])],
    "all_empty": [(8081, [vol(5, 8, EMPTY)]), (8082, [vol(5, 8, EMPTY)])],
    "online_skipped": [(8081, [vol(6, 1000, "aa", True)]),
                       (8082, [vol(6, 1000, "bb", True)])],
    "several": [(8081, [vol(5, 1000, "aa"), vol(7, 50, "cc")]),
                (8082, [vol(5, 900, "bb"), vol(7, 60, "dd")]),
                (8083, [vol(5, 1000, "aa")])],
}


def tasks_of(tasks) -> list[dict]:
    out = []
    for t in tasks:
        d = t.to_dict()
        for f in d["params"]["findings"]:
            f.pop("detected_at", None)
        out.append(d)
    return out


@pytest.mark.parametrize("case", sorted(DIVERGENCE_CASES))
def test_detect_divergence_equals_reference(case):
    topos = (Topology(pulse_seconds=1), RefTopology(pulse_seconds=1))
    for port, volumes in DIVERGENCE_CASES[case]:
        beat(topos, port, volumes)
    got = scrub.detect(types.SimpleNamespace(topo=topos[0]))
    want = ref_scrub.detect(types.SimpleNamespace(topo=topos[1]))
    assert tasks_of(got) == tasks_of(want)
    assert [t.key for t in got] == [t.key for t in want]
    expect = {"agree": 0, "all_empty": 0, "online_skipped": 0, "several": 2}
    assert len(got) == expect.get(case, 1)


def test_detect_heartbeat_findings_equal_reference():
    topos = (Topology(pulse_seconds=1), RefTopology(pulse_seconds=1))
    fs = [scrub.ScrubFinding("corrupt_needle", 7, node="127.0.0.1:8081", needle=3,
                             detected_at=1.0).to_dict(),
          scrub.ScrubFinding("corrupt_shard", 9, node="127.0.0.1:8081", shard=4,
                             detected_at=1.0).to_dict(),
          {"kind": "tmp_litter", "volume_id": 0, "node": "127.0.0.1:8081"},
          {"kind": "bogus", "volume_id": 3}]
    beat(topos, 8081, [vol(7, 1000, "aa")], fs)
    beat(topos, 8082, [vol(7, 1000, "bb")], [])
    got = scrub.detect(types.SimpleNamespace(topo=topos[0]))
    want = ref_scrub.detect(types.SimpleNamespace(topo=topos[1]))
    assert tasks_of(got) == tasks_of(want)
    assert [t.key for t in got] == [("scrub", 7), ("scrub", 9)]
    assert got[0].priority == want[0].priority


# --- repair routing over a stub env --------------------------------------------
def stub_views(cls, n=3):
    nodes = [{"id": f"h{i}:80", "url": f"h{i}:80",
              "volume_infos": [{"id": 5}], "ec_shard_infos": []} for i in range(1, n + 1)]
    nodes[0]["ec_shard_infos"] = [{"id": 9, "shards": [0, 1]}]
    return [cls("dc", "r", node) for node in nodes]


class StubEnv:
    def __init__(self, cls, fail=()) -> None:
        self.views = stub_views(cls)
        self.fail = fail
        self.calls = []

    def servers(self):
        return self.views

    def post(self, url, body=None, timeout=None):
        self.calls.append((url, dict(body or {})))
        for frag in self.fail:
            if frag in url or frag == (body or {}).get("source"):
                raise IOError(f"409 refused {frag}")
        return {"watermark": 81920, "copied": 2, "deleted": 1}


FINDINGS = [
    ("corrupt_needle", 5, dict(node="h1:80", needle=0x42)),
    ("corrupt_shard", 9, dict(node="h1:80", shard=3)),
    ("parity_mismatch", 5, dict(node="h2:80")),
    ("replica_divergence", 5, dict(node="h2:80", source_node="h1:80")),
    ("replica_divergence", 5, dict(node="h3:80", source_node="gone:80")),
    ("corrupt_shard", 9, dict(node="h1:80")),
    ("corrupt_needle", 5, dict(node="gone:80", needle=1)),
    ("tmp_litter", 5, dict(node="h1:80")),
]


@pytest.mark.parametrize("fail", [(), ("repair_needle",), ("http://h2:80",),
                                  ("delete_shards", "online/rebuild", "scrub/sync",
                                   "repair_needle")])
def test_repair_plan_and_apply_equal_reference(fail):
    fds = [scrub.ScrubFinding(k, v, detected_at=1.0, **kw).to_dict() for k, v, kw in FINDINGS]
    env, renv = StubEnv(ServerView, fail), StubEnv(RefServerView, fail)
    actions = scrub.plan_scrub_repairs(env, fds)
    assert actions == ref_scrub.plan_scrub_repairs(renv, fds)
    assert scrub.describe_scrub_repairs(actions) == ref_scrub.describe_scrub_repairs(actions)
    outcome = []
    for mod, e in ((scrub, env), (ref_scrub, renv)):
        try:
            outcome.append(("ok", mod.apply_scrub_repairs(e, actions)))
        except RuntimeError as err:
            outcome.append(("raised", str(err)))
    assert outcome[0] == outcome[1]
    assert env.calls == renv.calls
    if fail == ("repair_needle",):  # per-action isolation
        assert any("FAILED" in line for line in outcome[0][1])
        assert any("shard 3 deleted" in line for line in outcome[0][1])
    if len(fail) > 1:
        assert outcome[0][0] == "raised"


# --- a failing kernel or codec fails the pass ---------------------------------
def boom(*a, **kw):
    raise RuntimeError("kernel launch failed")


def test_crc_kernel_failure_fails_the_pass(pair, monkeypatch):
    pair.add(1)
    fill_mixed(pair, 1, seed=4)
    sc, _ = pair.scrubbers()
    monkeypatch.setattr(scrub, "crc32c_batch", boom)
    with pytest.raises(scrub.ScrubCodecFailed, match="crc32c_batch.*kernel launch failed"):
        sc.scrub_pass()
    assert sc.stats["passes"] == 0 and sc.active_volumes() == []
    assert sc.counters["codec_failures"] == 1
    assert sc.status()["codec_failure"]["error"] == "codec_failed"
    assert sc.counters["bytes"]["scalar"] == 0  # no quiet scalar fallback


def test_codec_failure_fails_sealed_and_online_scrub(pair, monkeypatch):
    ev, _ = sealed_pair(pair)
    sc, _ = pair.scrubbers()
    monkeypatch.setattr(ev.codec, "encode", boom)
    with pytest.raises(scrub.ScrubCodecFailed, match="EC codec"):
        sc.scrub_pass()
    monkeypatch.undo()
    pair.st.unmount_ec_volume(1)
    v = pair.st.add_volume(2, "", ec_online=True, ec_online_block=BLOCK)
    rng = np.random.default_rng(1)
    for nid in range(1, 40):
        pair.st.write(2, Needle(cookie=1, id=nid, data=rng.bytes(3000)))
    v.online_ec.pump(force=True)
    assert sc.scrub_pass(volume_id=2) == []
    monkeypatch.setattr(v.online_ec.codec, "encode", boom)
    with pytest.raises(scrub.ScrubCodecFailed, match="parity recompute"):
        sc.scrub_pass(volume_id=2)
    assert sc.counters["codec_failures"] == 2
