"""The port's volume admin plane held against the JAX package: replicated
writes and deletes, vacuum, and the volume copy and admin routes.

A port master and volume servers run at `device="cpu"` in this process.
Byte equality needs one clock: `pinned_clock()` freezes `time.time` (the
servers' `last_modified`) and `time.time_ns` (every needle module's append
stamp, which then counts up from one value per volume) for the writes, so
two replicas that see the same writes in the same order hold byte-equal
`.dat` and `.idx` files, and so does a JAX `Volume` given the same
history. Both sides run with the native front door off
(`SEAWEEDFS_TPU_DISABLE_FASTLANE=1`), so their Python handlers answer: the
engine stamps needles from the C clock, which `pinned_clock()` cannot
reach, and `tests/test_torch_fastlane.py` holds the two engines against
each other. Where a JAX server answers beside the port's (`twin()`), the
same requests go to both and the answers are compared with each server's
address replaced by its index. Tolerance 0 throughout.
"""

from __future__ import annotations

import contextlib
import json
import re
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.types import ReplicaPlacement as RefPlacement
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.maintenance import scrub as scrub_mod
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage import file_id
from seaweedfs_tpu_torch.util import faults
from tests._threads import stop_history_loops  # noqa: F401

OCTET = {"Content-Type": "application/octet-stream"}
COOKIE = 0x1234


@contextlib.contextmanager
def pinned_clock(at: int | None = None):
    """Freeze time.time and time.time_ns for every module (both packages'
    needle stamps and both servers' last_modified) at `at` (now, in whole
    seconds, unless given) while writes land. Yields the second."""
    frozen = int(time.time()) if at is None else at
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: float(frozen))
        mp.setattr(time, "time_ns", lambda: frozen * 10**9)
        yield frozen


def fid(vid: int, nid: int, cookie: int = COOKIE) -> str:
    return f"{vid},{file_id.format_needle_id_cookie(nid, cookie)}"


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


class Side:
    """One cluster: a master and volume servers, named s0, s1, ... in the
    order they started."""

    def __init__(self, master, servers) -> None:
        self.master = master
        self.servers = servers

    @property
    def ids(self) -> list[str]:
        return [vs.url.split("//", 1)[1] for vs in self.servers]

    def url(self, i: int) -> str:
        return self.servers[i].url

    def norm(self, value):
        """`value` with every server address replaced by its name."""
        if isinstance(value, dict):
            return {self.norm(k): self.norm(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self.norm(v) for v in value]
        if isinstance(value, str):
            for i, sid in enumerate(self.ids):
                value = value.replace(sid, f"s{i}")
            return re.sub(r"/tmp/[^ '\"]*", "<dir>", value)
        return value

    def beat(self) -> None:
        for vs in self.servers:
            vs.heartbeat_once()

    def stop(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def port_side(racks, master_kw=None, **vs_kw) -> Side:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        m = MasterServer(port=0, pulse_seconds=1, **(master_kw or {}))
        m.start()
        servers = []
        for rack in racks:
            vs = VolumeServer([tempfile.mkdtemp()], m.url, port=0, rack=rack,
                              pulse_seconds=1, max_volume_count=20, scrub_rate_mb=0,
                              device="cpu", **vs_kw)
            vs.start()
            servers.append(vs)
    return Side(m, servers)


def ref_side(racks, master_kw=None) -> Side:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        m = RefMasterServer(port=0, pulse_seconds=1, **(master_kw or {}))
        m.start()
        servers = []
        for rack in racks:
            vs = RefVolumeServer([tempfile.mkdtemp()], m.url, port=0, rack=rack,
                                 pulse_seconds=1, max_volume_count=20, scrub_rate_mb=0)
            vs.start()
            servers.append(vs)
    return Side(m, servers)


@contextlib.contextmanager
def twin(racks=("r1", "r1", "r2"), master_kw=None):
    """(JAX side, port side) over the same racks."""
    ref = ref_side(racks, master_kw)
    try:
        port = port_side(racks, master_kw)
        try:
            yield ref, port
        finally:
            port.stop()
    finally:
        ref.stop()


def allocate(side: Side, vid: int, holders, replication="000", collection="") -> None:
    for i in holders:
        post_json(side.url(i) + "/admin/allocate_volume",
                  {"volume": vid, "replication": replication, "collection": collection})
    side.beat()


def write(side: Side, i: int, vid: int, nid: int, data: bytes) -> None:
    status, _, out = http_request("POST", f"{side.url(i)}/{fid(vid, nid)}", data, OCTET)
    assert status == 201, out


def delete(side: Side, i: int, vid: int, nid: int) -> None:
    status, _, out = http_request("DELETE", f"{side.url(i)}/{fid(vid, nid)}")
    assert status == 202, out


def seeded_blobs(seed: int, n: int, lo: int = 100, hi: int = 6000) -> dict:
    rng = np.random.default_rng(seed)
    return {nid: rng.bytes(int(rng.integers(lo, hi))) for nid in range(1, n + 1)}


def ref_history(d: str, vid: int, blobs: dict, deleted, last_modified: int,
                replication: str = "001"):
    """The same writes and deletes straight into a JAX Volume."""
    rv = RefVolume(d, "", vid, replica_placement=RefPlacement.parse(replication))
    for nid, data in blobs.items():
        n = RefNeedle(cookie=COOKIE, id=nid, data=data)
        n.last_modified = last_modified
        n.set_has_last_modified()
        rv.write_needle(n)
    for nid in deleted:
        rv.delete_needle(RefNeedle(cookie=COOKIE, id=nid))
    return rv


# --- replication ---------------------------------------------------------------
@pytest.fixture
def replicated(tmp_path):
    side = port_side(("r1", "r1"), master_kw={"garbage_threshold": 0.99})
    try:
        yield side
    finally:
        side.stop()


def test_replicated_writes_and_deletes_reach_both_replicas(replicated, tmp_path):
    side = replicated
    a = get_json(f"{side.master.url}/dir/assign?replication=001")
    vid = int(a["fid"].split(",")[0])
    holders = [vs for vs in side.servers if vs.store.get_volume(vid) is not None]
    assert len(holders) == 2
    blobs = seeded_blobs(1, 40)
    deleted = sorted(np.random.default_rng(2).choice(list(blobs), 12, replace=False).tolist())
    with pinned_clock() as lm:
        for nid, data in blobs.items():  # alternate the primary
            write(side, nid % 2, vid, nid, data)
        for nid in deleted:
            delete(side, nid % 2, vid, nid)
    v0, v1 = (vs.store.get_volume(vid) for vs in side.servers)
    assert v0.file_count() == v1.file_count() == len(blobs)
    assert v0.deleted_count() == v1.deleted_count() == len(deleted)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    with pinned_clock(lm):
        rv = ref_history(str(ref_dir), vid, blobs, deleted, lm)
    try:
        for ext in (".dat", ".idx"):
            assert same_bytes(v0.base_name + ext, v1.base_name + ext), ext
            assert same_bytes(v0.base_name + ext, rv.base_name + ext), ext
        assert v0.needle_map_digest() == v1.needle_map_digest()
    finally:
        rv.close()
    for nid, data in blobs.items():
        for i in (0, 1):
            status, _, body = http_request("GET", f"{side.url(i)}/{fid(vid, nid)}")
            assert (status, body if status == 200 else None) == (
                (404, None) if nid in deleted else (200, data))


def test_replica_failure_fails_the_write(replicated):
    side = replicated
    a = get_json(f"{side.master.url}/dir/assign?replication=001")
    vid = int(a["fid"].split(",")[0])
    write(side, 0, vid, 1, b"first")
    # the other holder answers 500 (read only): the write is not acknowledged
    post_json(side.url(1) + "/admin/volume/readonly", {"volume": vid, "readonly": True})
    status, _, out = http_request("POST", f"{side.url(0)}/{fid(vid, 2)}", b"second", OCTET)
    assert status == 500 and b"replica write to" in out
    status, _, out = http_request("DELETE", f"{side.url(0)}/{fid(vid, 1)}")
    assert status == 500
    post_json(side.url(1) + "/admin/volume/readonly", {"volume": vid, "readonly": False})
    # the fan-out seam, armed on one server only
    faults.arm("volume.replicate.fanout", "error", key=side.ids[0])
    try:
        status, _, out = http_request("POST", f"{side.url(0)}/{fid(vid, 3)}", b"third", OCTET)
        assert status == 500 and b"injected fault" in out
        write(side, 1, vid, 4, b"fourth")  # the other server's fan-out is not armed
    finally:
        faults.disarm_all()
    assert side.servers[0].store.get_volume(vid).nm.get(4) is not None


def test_vacuum_equals_reference_and_master_round(replicated, tmp_path):
    side = replicated
    a = get_json(f"{side.master.url}/dir/assign?replication=001")
    vid = int(a["fid"].split(",")[0])
    blobs = seeded_blobs(3, 48)
    deleted = list(range(1, 48, 3))
    with pinned_clock() as lm:
        for nid, data in blobs.items():
            write(side, 0, vid, nid, data)
        for nid in deleted:
            delete(side, 1, vid, nid)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    with pinned_clock(lm):
        rv = ref_history(str(ref_dir), vid, blobs, deleted, lm)
    try:
        garbage = rv.garbage_level()
        rv.compact()
        rv.commit_compact()
        side.beat()
        # disabled, the master's round does nothing; enabled, it compacts
        # every holder over the threshold
        assert post_json(f"{side.master.url}/vol/vacuum/disable")["vacuum"] == "disabled"
        get_json(f"{side.master.url}/vol/vacuum?garbageThreshold=0.2")
        vols = [vs.store.get_volume(vid) for vs in side.servers]
        assert all(v.deleted_count() == len(deleted) for v in vols)
        post_json(f"{side.master.url}/vol/vacuum/enable")
        get_json(f"{side.master.url}/vol/vacuum?garbageThreshold=0.2")
        for v in vols:
            assert v.deleted_count() == 0 and v.file_count() == len(blobs) - len(deleted)
            for ext in (".dat", ".idx"):
                assert same_bytes(v.base_name + ext, rv.base_name + ext), ext
        # /admin/vacuum answers as the JAX handler: the garbage it found
        out = post_json(side.url(0) + "/admin/vacuum", {"volume": vid})
        assert out == {"ok": True, "garbage_was": 0.0}
        assert garbage > 0.2
    finally:
        rv.close()
    for nid in list(blobs)[:10]:
        status, _, body = http_request("GET", f"{side.url(1)}/{fid(vid, nid)}")
        assert (status, body) == ((404, b"") if nid in deleted else (200, blobs[nid]))


# --- the admin routes against the JAX handlers ------------------------------------
def ask(side: Side, method: str, i: int, path: str, payload=None):
    """(status, answer) of one route on server i: JSON decoded, bytes kept."""
    body = None if payload is None else json.dumps(payload).encode()
    status, hdrs, out = http_request(method, side.url(i) + path, body,
                                     {"Content-Type": "application/json"} if body else None)
    if "json" in hdrs.get("Content-Type", ""):
        return status, side.norm(json.loads(out))
    return status, out


def test_admin_routes_answer_as_reference():
    with twin() as (ref, port):
        blobs = seeded_blobs(5, 30)
        for side in (ref, port):
            allocate(side, 3, [0])
        with pinned_clock():
            for side in (ref, port):
                for nid, data in blobs.items():
                    write(side, 0, 3, nid, data)
                for nid in (4, 9):
                    delete(side, 0, 3, nid)

        def both(method, i, path, payload=None):
            got, want = (ask(s, method, i, path, payload) for s in (port, ref))
            assert got == want, (path, got, want)
            return got

        assert both("GET", 0, "/admin/volume/files?volume=3")[0] == 200
        assert both("GET", 0, "/admin/volume/files?volume=99")[0] == 404
        needles = both("GET", 0, "/admin/volume/needles?volume=3")[1]["needles"]
        assert len(needles) == len(blobs) - 2
        for n in needles[:6]:
            both("GET", 0, f"/admin/volume/needle_blob?volume=3&offset={n['offset']}"
                           f"&size={n['size']}")
        assert both("GET", 0, "/admin/fsck?volume=3")[1]["ok"] is True
        # the copy plane: s2 pulls volume 3 from s0; unmount and mount back
        for side in (ref, port):
            side.beat()
        st_p = ask(port, "POST", 2, "/admin/volume/copy", {"volume": 3, "source": port.url(0)})
        st_r = ask(ref, "POST", 2, "/admin/volume/copy", {"volume": 3, "source": ref.url(0)})
        assert st_p == st_r and st_p[0] == 200
        for ext in (".dat", ".idx"):
            a = port.servers[2].store.get_volume(3).base_name + ext
            assert same_bytes(a, port.servers[0].store.get_volume(3).base_name + ext)
            assert same_bytes(a, ref.servers[2].store.get_volume(3).base_name + ext)
        assert both("POST", 2, "/admin/volume/copy",
                    {"volume": 3, "source": "http://unused"})[0] == 409
        assert both("POST", 2, "/admin/volume/unmount", {"volume": 3}) == (200, {"ok": True})
        assert port.servers[2].store.get_volume(3) is None
        assert both("POST", 2, "/admin/volume/mount", {"volume": 3})[0] == 200
        # a flipped byte: fsck names the needle, the scrub pass finds it
        n = needles[3]
        for side in (ref, port):
            path = side.servers[0].store.get_volume(3).base_name + ".dat"
            with open(path, "r+b") as f:
                f.seek(n["offset"] + 40)
                b = f.read(1)
                f.seek(n["offset"] + 40)
                f.write(bytes([b[0] ^ 0xFF]))
        status, out = both("GET", 0, "/admin/fsck?volume=3")
        assert out["ok"] is False and [e["id"] for e in out["errors"]] == [n["id"]]
        got, want = (ask(s, "POST", 0, "/admin/scrub/run", {"volume": 3}) for s in (port, ref))
        assert got[0] == want[0] == 200

        def strip(fs):
            return [{k: v for k, v in f.items() if k != "detected_at"} for f in fs]

        assert strip(got[1]["findings"]) == strip(want[1]["findings"])
        assert [f["needle"] for f in got[1]["findings"]] == [n["id"]]
        for key in ("needles_checked", "bytes_scanned", "findings"):
            assert got[1]["stats"][key] == want[1]["stats"][key], key
        status, st = ask(port, "GET", 0, "/admin/scrub/status")
        assert status == 200 and st["counters"]["findings"]["corrupt_needle"] == 1
        assert [f["needle"] for f in st["unresolved"]] == [n["id"]]
        # configure_replication rewrites the superblock byte in place
        both("POST", 0, "/admin/volume/configure_replication",
             {"volume": 3, "replication": "010"})
        assert str(port.servers[0].store.get_volume(3).super_block.replica_placement) == "010"
        assert both("POST", 0, "/admin/volume/configure_replication",
                    {"volume": 3, "replication": "x"})[0] == 400
        assert both("POST", 0, "/admin/delete_volume", {"volume": 3}) == (200, {"ok": True})
        assert port.servers[0].store.get_volume(3) is None
        # the master drops a collection on every holder
        answers = []
        for side in (ref, port):
            allocate(side, 8, [1, 2], collection="pics")
            m = side.master.url
            answers.append([http_request("POST", f"{m}/col/delete?collection={c}")[::2]
                            for c in ("pics", "")])
            assert all(vs.store.get_volume(8) is None for vs in side.servers)
        assert answers[0] == answers[1]
        assert [st for st, _ in answers[1]] == [200, 400]
        assert json.loads(answers[1][0][1]) == {"ok": True, "deleted": 2}


def test_scrub_run_answers_codec_failed(replicated, monkeypatch):
    side = replicated
    allocate(side, 7, [0])
    for nid, data in seeded_blobs(6, 20, lo=900, hi=901).items():
        write(side, 0, 7, nid, data)
    out = post_json(side.url(0) + "/admin/scrub/run", {"volume": 7})
    assert out["findings"] == [] and out["stats"]["needles_checked"] == 20

    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(scrub_mod, "crc32c_batch", boom)
    status, _, body = http_request("POST", side.url(0) + "/admin/scrub/run", b'{"volume": 7}',
                                   {"Content-Type": "application/json"})
    err = json.loads(body)
    assert status == 500 and err["error"] == "codec_failed"
    assert err["server"] == side.ids[0] and "kernel launch failed" in err["detail"]
    st = get_json(side.url(0) + "/admin/scrub/status")
    assert st["counters"]["codec_failures"] == 1
    assert st["codec_failure"]["error"] == "codec_failed"
    assert st["counters"]["bytes"]["scalar"] == 0


def test_server_leave_stops_heartbeats(replicated):
    side = replicated
    post_json(side.url(1) + "/admin/leave")
    assert side.servers[1]._leaving
    # the server stays up and serves
    assert http_request("GET", side.url(1) + "/status")[0] == 200


def test_scrub_loop_records_findings_and_codec_failures(monkeypatch):
    """-scrub.interval: the loop's passes find a flipped needle, the
    finding rides the heartbeat into the master's topology, and a kernel
    failure is kept on the scrubber while the loop goes on."""
    side = port_side(("r1",), scrub_interval=0.1)
    try:
        vs = side.servers[0]
        allocate(side, 9, [0])
        for nid, data in seeded_blobs(8, 20, lo=700, hi=701).items():
            write(side, 0, 9, nid, data)
        off, _ = vs.store.get_volume(9).nm.get(6)
        with open(vs.store.get_volume(9).base_name + ".dat", "r+b") as f:
            f.seek(off + 40)
            b = f.read(1)
            f.seek(off + 40)
            f.write(bytes([b[0] ^ 0xFF]))

        def wait(cond) -> None:
            deadline = time.monotonic() + 20
            while not cond():
                assert time.monotonic() < deadline
                time.sleep(0.05)

        wait(lambda: vs.scrubber.unresolved())
        assert [(f["kind"], f["needle"]) for f in vs.scrubber.unresolved()] == [
            ("corrupt_needle", 6)]
        vs.heartbeat_once()
        node = side.master.topo.all_nodes()[0]
        assert [f["needle"] for f in node.scrub_findings] == [6]

        def boom(*a, **kw):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(scrub_mod, "crc32c_batch", boom)
        wait(lambda: vs.scrubber.counters["codec_failures"] >= 2)
        assert vs._scrub_thread.is_alive()
        assert get_json(vs.url + "/admin/scrub/status")["codec_failure"]["error"] == "codec_failed"
        monkeypatch.undo()
        passes = vs.scrubber.stats["passes"]
        wait(lambda: vs.scrubber.stats["passes"] > passes)
    finally:
        side.stop()
