"""The port's `volume.*` shell verbs held against the JAX shell.

A JAX cluster (master and three volume servers, racks r1, r1, r2, the
native front door off) and a port cluster (the same, at `device="cpu"`)
get the same layout and the same seeded needles, written under one frozen
clock so their `.dat` files are equal byte for byte. Each verb then runs in
both shells; its output, with every server address replaced by the
server's index, and the resulting placement (the volumes and EC shards on
each server) must be equal. `volume.scrub` runs end to end: a corrupt
needle re-copied from the other replica, a corrupt shard located, deleted
and restored byte for byte by `ec.rebuild`, a flipped parity row re-armed,
and a diverged replica found by `detect` and healed by `/admin/scrub/sync`.
A CRC kernel that raises makes the port's `volume.scrub` raise ShellError
naming the server. Tolerance 0.
"""

from __future__ import annotations

import os
import shutil
import types

import pytest

from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command
from seaweedfs_tpu_torch.storage.erasure_coding import geometry
from tests.test_torch_volume_admin import (
    OCTET,
    allocate,
    delete,
    fid,
    pinned_clock,
    port_side,
    same_bytes,
    seeded_blobs,
    twin,
    write,
)
from tests._threads import stop_history_loops  # noqa: F401

BLOCK = 4096


class Shells:
    """The JAX shell over the JAX side and the port's over the port side."""

    def __init__(self, ref, port) -> None:
        self.ref, self.port = ref, port
        self.envs = (RefEnv(ref.master.url), CommandEnv(port.master.url))

    def beat(self) -> None:
        for side in (self.ref, self.port):
            side.beat()

    def run(self, line: str) -> str:
        """One verb in both shells; the normalized outputs must agree."""
        self.beat()
        outs = []
        for side, env, runner in ((self.ref, self.envs[0], ref_run),
                                  (self.port, self.envs[1], run_command)):
            try:
                outs.append(("ok", side.norm(runner(env, line))))
            except Exception as e:  # the same failure in both
                outs.append(("raised", type(e).__name__, side.norm(str(e))))
        assert outs[0] == outs[1], (line, outs)
        assert self.layout(self.ref) == self.layout(self.port), line
        return outs[1][1]

    @staticmethod
    def layout(side) -> list:
        out = []
        for vs in side.servers:
            st = vs.store
            ec = sorted((loc_vid, tuple(ev.shard_ids()))
                        for loc in st.locations for loc_vid, ev in loc.ec_volumes.items())
            out.append((sorted(st.volume_ids()), ec))
        return out

    def both(self, fn) -> None:
        fn(self.ref)
        fn(self.port)


def flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def base(side, i: int, vid: int) -> str:
    return os.path.join(side.servers[i].store.locations[0].directory, str(vid))


def get(side, i: int, vid: int, nid: int) -> tuple[int, bytes]:
    status, _, body = http_request("GET", f"{side.url(i)}/{fid(vid, nid)}")
    return status, body


def tasks_of(tasks, side) -> list:
    out = []
    for t in tasks:
        d = t.to_dict()
        for f in d["params"]["findings"]:
            f.pop("detected_at", None)
        out.append(side.norm(d))
    return out


@pytest.fixture
def shells():
    # the pulse must not vacuum on its own: the tests delete past the
    # default 0.3 garbage threshold, and each verb sets its own
    with twin(master_kw={"garbage_threshold": 0.99}) as (ref, port):
        yield Shells(ref, port)


def test_scrub_verb_end_to_end_equals_reference(shells, tmp_path):
    sh = shells
    ref, port = sh.ref, sh.port
    blobs = seeded_blobs(21, 30)
    equal = seeded_blobs(22, 20, lo=1200, hi=1201)  # a batched group
    for side in (ref, port):
        allocate(side, 1, [0, 1], replication="001")
        allocate(side, 3, [0])
        post_json(side.url(2) + "/admin/allocate_volume",
                  {"volume": 4, "ecOnline": True, "ecOnlineBlock": BLOCK})
    with pinned_clock():
        for side in (ref, port):
            for nid, data in blobs.items():
                write(side, nid % 2, 1, nid, data)
                write(side, 0, 3, nid, data)
                write(side, 2, 4, nid, data)
            for nid, data in equal.items():
                write(side, 0, 1, 100 + nid, data)
    for ext in (".dat", ".idx"):
        for i, vid in ((0, 1), (1, 1), (0, 3), (2, 4)):
            assert same_bytes(base(ref, i, vid) + ext, base(port, i, vid) + ext)
    for env in sh.envs:
        env.acquire_lock()
    out = sh.run("volume.scrub -dryRun")
    assert out.endswith("scrub: clean — no silent damage found")
    assert sh.run("volume.fsck").endswith("fsck: clean")
    assert sh.run("volume.check.disk") == "all replicas are in sync"

    # 1. a corrupt needle on s0's replica, re-copied from s1
    off, size = port.servers[0].store.get_volume(1).nm.get(5)
    sh.both(lambda side: flip(base(side, 0, 1) + ".dat", off + 16 + 4 + 50))
    out = sh.run("volume.scrub -volumeId 1 -dryRun")
    assert "volume 1 [corrupt_needle] on s0: re-copy needle 5 from s1" in out
    out = sh.run("volume.scrub -volumeId 1 -apply")
    assert "volume 1: needle 5 re-written from s1" in out
    assert get(port, 0, 1, 5) == (200, blobs[5])
    assert sh.run("volume.scrub -volumeId 1").endswith("no silent damage found")

    # 2. vol 3 encoded in place (all 14 shards on s0); shard 3 flipped is
    # located, deleted, and ec.rebuild restores it byte for byte
    def encode_in_place(side):
        post_json(side.url(0) + "/admin/ec/generate", {"volume": 3})
        post_json(side.url(0) + "/admin/ec/mount", {"volume": 3})
    sh.both(encode_in_place)
    saved = str(tmp_path / "ec03")
    shutil.copyfile(base(port, 0, 3) + ".ec03", saved)
    assert same_bytes(saved, base(ref, 0, 3) + ".ec03")
    sh.both(lambda side: flip(base(side, 0, 3) + ".ec03", 17))
    out = sh.run("volume.scrub -volumeId 3 -dryRun")
    assert "volume 3 [corrupt_shard] on s0: delete corrupt shard 3" in out
    out = sh.run("volume.scrub -volumeId 3 -apply")
    assert "volume 3: corrupt shard 3 deleted on s0" in out
    assert not os.path.exists(base(port, 0, 3) + ".ec03")
    sh.run("ec.rebuild -volumeId 3")
    assert same_bytes(base(port, 0, 3) + ".ec03", saved)
    assert sh.run("volume.scrub -volumeId 3").endswith("no silent damage found")

    # 3. a flipped parity row of the online volume: re-armed
    sh.both(lambda side: flip(base(side, 2, 4) + geometry.to_ext(10), 5))
    out = sh.run("volume.scrub -volumeId 4 -apply")
    assert "volume 4: parity re-encoded to watermark" in out
    assert sh.run("volume.scrub -volumeId 4").endswith("no silent damage found")

    # 4. a needle written to s0's replica only (the longer .dat since the
    # re-copy appended there): detect names s1 diverged with s0 the source,
    # and /admin/scrub/sync copies the needle over
    with pinned_clock():
        for side in (ref, port):
            status, _, out = http_request(
                "POST", f"{side.url(0)}/{fid(1, 77)}?type=replicate", b"lonely", OCTET)
            assert status == 201, out
    sh.beat()
    tasks = [tasks_of(mod.detect(types.SimpleNamespace(topo=side.master.topo)), side)
             for mod, side in ((ref_scrub, ref), (scrub, port))]
    assert tasks[0] == tasks[1] and len(tasks[1]) == 1
    fs = tasks[1][0]["params"]["findings"]
    assert [(f["kind"], f["node"], f["source_node"]) for f in fs] == [
        ("replica_divergence", "s1", "s0")]
    applied = []
    for mod, side, env in ((ref_scrub, ref, sh.envs[0]), (scrub, port, sh.envs[1])):
        found = mod.detect(types.SimpleNamespace(topo=side.master.topo))
        actions = mod.plan_scrub_repairs(env, found[0].params["findings"])
        applied.append(side.norm(mod.apply_scrub_repairs(env, actions)))
    assert applied[0] == applied[1] == ["volume 1: re-synced from s0 (+1 needles, -0 stale)"]
    assert get(port, 1, 1, 77) == (200, b"lonely")
    v0, v1 = (vs.store.get_volume(1) for vs in port.servers[:2])
    assert v0.needle_map_digest() == v1.needle_map_digest()
    sh.beat()
    assert scrub.detect(types.SimpleNamespace(topo=port.master.topo)) == []
    st = get_json(port.url(0) + "/admin/scrub/status")["counters"]
    assert st["repairs"]["corrupt_needle"] == 1 and st["repairs"]["corrupt_shard"] == 1
    assert st["bytes"]["batched"] > 0
    assert get_json(port.url(1) + "/admin/scrub/status")["counters"]["repairs"][
        "replica_divergence"] == 1
    assert get_json(port.url(2) + "/admin/scrub/status")["counters"]["repairs"][
        "parity_mismatch"] == 1


def test_volume_verbs_equal_reference(shells):
    sh = shells
    ref, port = sh.ref, sh.port
    blobs = seeded_blobs(31, 40)
    for side in (ref, port):
        allocate(side, 1, [0, 1], replication="001")
        allocate(side, 2, [0])
        allocate(side, 5, [0])
    with pinned_clock():
        for side in (ref, port):
            for nid, data in blobs.items():
                write(side, 0, 1, nid, data)
                write(side, 0, 2, nid, data)
            for nid in range(1, 41, 3):
                delete(side, 1, 1, nid)
    for env in sh.envs:
        env.acquire_lock()
    out = sh.run("volume.vacuum -garbageThreshold 0.2 -dryRun")
    assert "vacuum volume 1 on s0" in out and "vacuum volume 1 on s1" in out
    assert sh.run("volume.vacuum -garbageThreshold 0.2") == "vacuumed: 1@s0, 1@s1"
    v0 = port.servers[0].store.get_volume(1)
    assert v0.deleted_count() == 0 and same_bytes(base(port, 0, 1) + ".dat",
                                                  base(ref, 0, 1) + ".dat")
    assert same_bytes(base(port, 0, 1) + ".dat", base(port, 1, 1) + ".dat")
    sh.run("volume.fsck -volumeId 1")
    # a needle on s0's replica only: volume.check.disk copies its raw
    # record over (needle_blob, then write_needle_blob)
    with pinned_clock():
        for side in (ref, port):
            status, _, out = http_request(
                "POST", f"{side.url(0)}/{fid(1, 200)}?type=replicate", b"one side", OCTET)
            assert status == 201, out
    assert sh.run("volume.check.disk") == "volume 1: copied needle 200 s0 -> s1"
    assert get(port, 1, 1, 200) == (200, b"one side")
    v0, v1 = (vs.store.get_volume(1) for vs in port.servers[:2])
    assert v0.needle_map_digest() == v1.needle_map_digest()
    for verb in ("volume.copy -volumeId 2 -source {0} -target {2}",
                 "volume.move -volumeId 2 -source {2} -target {1}",
                 "volume.mark -volumeId 5 -node {0} -readonly",
                 "volume.mark -volumeId 5 -node {0} -writable",
                 "volume.unmount -volumeId 5 -node {0}",
                 "volume.mount -volumeId 5 -node {0}",
                 "volume.delete -volumeId 1 -node {1}",
                 "volume.fix.replication -dryRun",
                 "volume.fix.replication",
                 "volume.check.disk",
                 "volume.configure.replication -volumeId 2 -replication 000",
                 "volume.balance -dryRun",
                 "volume.balance",
                 "volume.server.evacuate -node {0}",
                 "volume.delete.empty",
                 "volume.vacuum.disable",
                 "volume.vacuum.enable",
                 "volume.server.leave -node {2}"):
        # the same server, by its own cluster's address, in each shell
        line_ref = verb.format(*ref.ids)
        line_port = verb.format(*port.ids)
        outs = []
        for side, env, runner, line in ((ref, sh.envs[0], ref_run, line_ref),
                                        (port, sh.envs[1], run_command, line_port)):
            side.beat()
            outs.append(side.norm(runner(env, line)))
        assert outs[0] == outs[1], (verb, outs)
        assert sh.layout(ref) == sh.layout(port), verb
    assert port.master.vacuum_enabled and port.servers[2]._leaving
    assert not port.servers[0].store.volume_ids()  # evacuated
    for nid in (2, 3, 5):
        holder = next(i for i, vs in enumerate(port.servers) if vs.store.get_volume(2))
        assert get(port, holder, 2, nid) == (200, blobs[nid])


def test_codec_failure_fails_volume_scrub(monkeypatch):
    side = port_side(("r1", "r1"))
    try:
        allocate(side, 7, [1])
        for nid, data in seeded_blobs(6, 20, lo=900, hi=901).items():
            write(side, 1, 7, nid, data)
        env = CommandEnv(side.master.url)
        env.acquire_lock()
        assert run_command(env, "volume.scrub").endswith("no silent damage found")

        def boom(*a, **kw):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(scrub, "crc32c_batch", boom)
        with pytest.raises(ShellError, match=f"codec_failed on {side.ids[1]}.*kernel launch"):
            run_command(env, "volume.scrub -volumeId 7")
    finally:
        side.stop()
