"""The port's volume backends and tiering held against the JAX package's
(`storage/backend.py`, `Volume.tier_to_remote` / `tier_to_local`, the
volume server's tier, `/admin/tail` and `/query` routes and the
`volume.tier.*` verbs).

Every backend file and object store does the same seeded operations in
both packages with equal results. The same volume, written under one
frozen clock, is tiered by both: the `.vif` (merged with an online-EC
record), the backend object and every read are equal, and a tiered volume
written by one package opens and serves through the other. Over a JAX and
a port cluster side by side, the tier verbs, `/admin/tail` and `/query`
answer alike. The port runs on `device="cpu"`. Tolerance 0.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage.erasure_coding import encoder as ref_encoder
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage.erasure_coding import encoder
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from tests.test_torch_shell_volume import Shells, base
from tests.test_torch_volume_admin import (
    OCTET,
    allocate,
    fid,
    pinned_clock,
    twin,
    write,
)
from tests._threads import stop_history_loops  # noqa: F401

PKGS = {"port": backend, "ref": ref_backend}


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("kind", ["disk", "mmap", "memory"])
def test_storage_files_equal_reference(tmp_path, kind):
    """Seeded positional writes, reads past the end, truncates and syncs on
    each file kind: every answer equal."""
    rng = np.random.default_rng(len(kind))
    files = []
    for name, mod in PKGS.items():
        path = str(tmp_path / f"{name}.dat")
        files.append({"disk": lambda: mod.DiskFile(path, create=True),
                      "mmap": lambda: (open(path, "wb").close(), mod.MmapFile(path))[1],
                      "memory": mod.MemoryFile}[kind]())
    for step in range(40):
        op = int(rng.integers(0, 4))
        off = int(rng.integers(0, 20000))
        n = int(rng.integers(0, 3000))
        data = rng.bytes(n)
        got = []
        for f in files:
            if op == 0:
                got.append(outcome(lambda: f.write_at(data, off)))
            elif op == 1:
                got.append(outcome(lambda: f.read_at(n, off)))
            elif op == 2 and step % 7 == 0:
                got.append(outcome(lambda: (f.truncate(off), f.file_size())))
            else:
                got.append(outcome(lambda: (f.sync(), f.file_size(), f.writable)))
        assert got[0] == got[1], (step, op)
    for f in files:
        f.close()


def test_object_backends_equal_reference(tmp_path):
    """The local object store: upload, ranged reads, size, download, delete
    (a missing object's read and download) equal; RemoteFile reads over it
    equal and refuses writes alike; s3 and rclone without boto3 or the
    binary raise BackendError in both."""
    src = tmp_path / "blob.bin"
    src.write_bytes(np.random.default_rng(3).bytes(300_000))
    answers = []
    for name, mod in PKGS.items():
        b = mod.configure_backend(f"t-{name}", "local", root=str(tmp_path / name))
        assert mod.get_backend(f"t-{name}") is b and b.kind == "local"
        assert f"t-{name}" in mod.list_backends()
        out = [b.upload_file(str(src), "c/5.dat"), b.object_size("c/5.dat"),
               sorted(os.listdir(tmp_path / name))]
        rf = mod.RemoteFile(b, "c/5.dat", out[0])
        out += [b.read_range("c/5.dat", off, n) for off, n in ((0, 10), (299_990, 50), (7, 0))]
        out += [rf.read_at(100, 1000), rf.file_size(), rf.writable,
                outcome(lambda: rf.write_at(b"x", 0)), outcome(lambda: rf.truncate(1))]
        dst = tmp_path / f"{name}.back"
        b.download_file("c/5.dat", str(dst))
        out.append(dst.read_bytes() == src.read_bytes())
        b.delete_file("c/5.dat")
        b.delete_file("c/5.dat")
        out += [outcome(lambda: b.read_range("c/5.dat", 0, 1)),
                outcome(lambda: b.download_file("c/5.dat", str(dst)))]
        for kind, kw in (("s3", {"bucket": "b"}), ("rclone", {"remote_name": "r"}),
                         ("ftp", {})):
            out.append(outcome(lambda: mod.configure_backend("x", kind, **kw)))
        out.append(outcome(lambda: mod.get_backend("never-configured")))
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][-4:] == [("raised", "BackendError")] * 4


def test_mmap_reads_equal_reference(tmp_path, monkeypatch):
    """SEAWEEDFS_TPU_MMAP_READS=1 opens a volume's .dat through MmapFile in
    both packages: appends past the mapping, reads and a reopen answer
    alike."""
    monkeypatch.setenv("SEAWEEDFS_TPU_MMAP_READS", "1")
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(13)
    blobs = {nid: rng.bytes(int(rng.integers(10, 9000))) for nid in range(1, 30)}
    v, rv = write_both(dirs, 5, dict(list(blobs.items())[:10]), 1_700_000_000)
    assert isinstance(v._dat, backend.MmapFile) and isinstance(rv._dat, ref_backend.MmapFile)
    for nid in range(1, 11):  # map the file, then append past the mapping
        assert v.read_needle(nid).data == rv.read_needle(nid).data == blobs[nid]
    with pinned_clock(1_700_000_000):
        for nid in range(11, 30):
            v.write_needle(Needle(cookie=0x42, id=nid, data=blobs[nid]))
            rv.write_needle(RefNeedle(cookie=0x42, id=nid, data=blobs[nid]))
    for nid, data in blobs.items():
        assert v.read_needle(nid, cookie=0x42).data == rv.read_needle(nid, cookie=0x42).data \
            == data
    v.close()
    rv.close()
    assert read(v.base_name + ".dat") == read(rv.base_name + ".dat")
    v = Volume(dirs[0], "", 5, device="cpu")
    assert [v.read_needle(n).data for n in blobs] == list(blobs.values())
    v.close()


def write_both(dirs, vid: int, blobs: dict, clock_at: int):
    """The same needles into a port and a JAX volume under one clock."""
    with pinned_clock(clock_at):
        v = Volume(dirs[0], "", vid, device="cpu")
        rv = RefVolume(dirs[1], "", vid)
        for nid, data in blobs.items():
            v.write_needle(Needle(cookie=0x42, id=nid, data=data))
            rv.write_needle(RefNeedle(cookie=0x42, id=nid, data=data))
    return v, rv


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("keep_local", [False, True])
@pytest.mark.parametrize("online_vif", [False, True])
def test_tier_round_trip_equals_reference(tmp_path, keep_local, online_vif):
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(7)
    blobs = {nid: rng.bytes(int(rng.integers(10, 20000))) for nid in range(1, 41)}
    v, rv = write_both(dirs, 7, blobs, 1_700_000_000)
    if online_vif:  # the tier record merges with what the EC paths wrote
        encoder.save_volume_info(v.base_name + ".vif", version=3,
                                 ec_online={"block_size": 4096, "sealed": True})
        ref_encoder.save_volume_info(rv.base_name + ".vif", version=3,
                                     ec_online={"block_size": 4096, "sealed": True})
    backend.configure_backend("cold", "local", root=str(tmp_path / "obj-port"))
    ref_backend.configure_backend("cold", "local", root=str(tmp_path / "obj-ref"))
    dat = read(v.base_name + ".dat")
    assert dat == read(rv.base_name + ".dat")
    assert outcome(lambda: v.tier_to_remote("cold")) == \
        outcome(lambda: rv.tier_to_remote("cold")) == ("raised", "VolumeError")
    v.readonly = rv.readonly = True
    with pinned_clock(1_700_000_100):
        assert v.tier_to_remote("cold", keep_local) == \
            rv.tier_to_remote("cold", keep_local) == len(dat)
    for x in (v.base_name, rv.base_name):
        assert os.path.exists(x + ".dat") == keep_local
    assert read(v.base_name + ".vif") == read(rv.base_name + ".vif")
    info = json.loads(read(v.base_name + ".vif"))
    assert info["files"] == [{"backend_id": "cold", "key": "default_7.dat",
                              "file_size": len(dat), "modified_ts": 1_700_000_100}]
    assert ("ec_online" in info) == online_vif
    assert read(str(tmp_path / "obj-port" / "default_7.dat")) == dat == \
        read(str(tmp_path / "obj-ref" / "default_7.dat"))
    assert v.tier_info() == rv.tier_info()
    for nid, data in blobs.items():
        assert v.read_needle(nid, cookie=0x42).data == data
        assert rv.read_needle(nid, cookie=0x42).data == data
    assert outcome(lambda: v.tier_to_remote("cold")) == \
        outcome(lambda: rv.tier_to_remote("cold"))
    assert outcome(lambda: v.write_needle(Needle(id=99, data=b"x"))) == \
        outcome(lambda: rv.write_needle(RefNeedle(id=99, data=b"x")))
    assert v.binary_search_by_append_at_ns(0) == rv.binary_search_by_append_at_ns(0)
    v.tier_to_local()
    rv.tier_to_local()
    assert read(v.base_name + ".dat") == read(rv.base_name + ".dat") == dat
    assert read(v.base_name + ".vif") == read(rv.base_name + ".vif")
    assert not os.listdir(tmp_path / "obj-port") and not os.listdir(tmp_path / "obj-ref")
    assert outcome(v.tier_to_local) == outcome(rv.tier_to_local) == ("raised", "VolumeError")
    v.close()
    rv.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_tiered_volume_opens_across_packages(tmp_path, writer):
    """A volume tiered by one package (its .idx, .vif and backend object
    copied across) opens through the other, readonly, and every needle
    reads equal; destroy() deletes the remote object."""
    dirs = [str(tmp_path / d) for d in ("port", "ref")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(11)
    blobs = {nid: rng.bytes(int(rng.integers(10, 9000))) for nid in range(1, 25)}
    v, rv = write_both(dirs, 3, blobs, 1_700_000_000)
    src, dst = (rv, v) if writer == "ref" else (v, rv)
    dst.close()
    src_mod, dst_mod = (ref_backend, backend) if writer == "ref" else (backend, ref_backend)
    root = str(tmp_path / "objects")
    src_mod.configure_backend("shared", "local", root=root)
    dst_mod.configure_backend("shared", "local", root=root)
    src.readonly = True
    src.tier_to_remote("shared")
    src.close()
    dst_dir = dirs[0] if writer == "ref" else dirs[1]
    for ext in (".idx", ".vif"):
        shutil.copyfile(src.base_name + ext, os.path.join(dst_dir, "3" + ext))
    os.remove(os.path.join(dst_dir, "3.dat"))
    opened = Volume(dst_dir, "", 3, device="cpu") if writer == "ref" else \
        RefVolume(dst_dir, "", 3)
    assert opened.readonly and opened.tier_info()["key"] == "default_3.dat"
    for nid, data in blobs.items():
        assert opened.read_needle(nid, cookie=0x42).data == data
    opened.destroy()
    assert os.listdir(root) == []


# --- the servers: tier verbs, /admin/tail and /query ---------------------------------
@pytest.fixture
def shells():
    with twin(racks=("r1",)) as (ref, port):
        yield Shells(ref, port)


def test_tier_verbs_through_both_servers(shells, tmp_path):
    """volume.tier.configure / upload / info / download / move over a JAX
    and a port volume server holding the same volume: equal output, equal
    `.vif` and backend objects, and every GET equal while tiered."""
    sh = shells
    rng = np.random.default_rng(21)
    blobs = {nid: rng.bytes(int(rng.integers(10, 30000))) for nid in range(1, 31)}
    with pinned_clock(1_700_000_000):
        for side in (sh.ref, sh.port):
            allocate(side, 4, [0])
            for nid, data in blobs.items():
                write(side, 0, 4, nid, data)
    assert read(base(sh.ref, 0, 4) + ".dat") == read(base(sh.port, 0, 4) + ".dat")
    sh.run("lock")
    roots = {"ref": tmp_path / "cold-ref", "port": tmp_path / "cold-port"}
    for name, side in (("ref", sh.ref), ("port", sh.port)):
        post_json(side.url(0) + "/admin/backend/configure",
                  {"id": "cold", "kind": "local", "options": {"root": str(roots[name])}})
    out = sh.run("volume.tier.configure -backend cold2 -kind local -root "
                 + str(tmp_path / "cold2"))
    assert out == "backend 'cold2' (local) configured on: s0"
    with pinned_clock(1_700_000_100):
        out = sh.run("volume.tier.upload -volumeId 4 -dest cold")
    assert out.startswith("volume 4 tiered to cold (")
    assert read(base(sh.ref, 0, 4) + ".vif") == read(base(sh.port, 0, 4) + ".vif")
    assert read(str(roots["ref"] / "default_4.dat")) == read(str(roots["port"] / "default_4.dat"))
    assert not os.path.exists(base(sh.port, 0, 4) + ".dat")
    info = sh.run("volume.tier.info -volumeId 4")
    assert json.loads(info)["remote"]["backend_id"] == "cold"
    for side in (sh.ref, sh.port):
        for nid, data in blobs.items():
            status, _, body = http_request("GET", f"{side.url(0)}/{fid(4, nid)}")
            assert status == 200 and body == data
        status, _, out = http_request("POST", f"{side.url(0)}/{fid(4, 99)}", b"x", OCTET)
        assert status != 201
    errors = []  # already tiered: the same 409 (the two shells' exception classes differ)
    for side, env, runner in ((sh.ref, sh.envs[0], ref_run), (sh.port, sh.envs[1], run_command)):
        with pytest.raises(OSError) as e:
            runner(env, "volume.tier.upload -volumeId 4 -dest cold")
        errors.append(side.norm(str(e.value)))
    assert errors[0] == errors[1] and "already tiered" in errors[0]
    sh.run("volume.tier.download -volumeId 4")
    assert read(base(sh.ref, 0, 4) + ".dat") == read(base(sh.port, 0, 4) + ".dat")
    assert read(base(sh.ref, 0, 4) + ".vif") == read(base(sh.port, 0, 4) + ".vif")
    with pinned_clock(1_700_000_200):
        sh.run("volume.tier.move -volumeId 4 -dest cold2 -keepLocal true")
    assert os.path.exists(base(sh.port, 0, 4) + ".dat")
    assert read(base(sh.ref, 0, 4) + ".vif") == read(base(sh.port, 0, 4) + ".vif")
    for side in (sh.ref, sh.port):
        answers = [get_json(f"{side.url(0)}/admin/volume/tier_info?volume={v}")
                   if v == 4 else http_request("GET", f"{side.url(0)}/admin/volume/"
                                                      f"tier_info?volume={v}")[0]
                   for v in (4, 77)]
        assert answers[0]["remote"]["backend_id"] == "cold2" and answers[1] == 404
    sh.run("unlock")


def test_admin_tail_equals_reference(shells):
    """/admin/tail at since_ns 0, at each needle's stamp and past the last:
    the same bytes from both servers, the .dat's bytes from the first needle
    appended after the stamp."""
    sh = shells
    rng = np.random.default_rng(31)
    blobs = {nid: rng.bytes(int(rng.integers(1, 5000))) for nid in range(1, 21)}
    with pinned_clock(1_700_000_000):
        for side in (sh.ref, sh.port):
            allocate(side, 6, [0])
            for nid, data in blobs.items():
                write(side, 0, 6, nid, data)
    pv = sh.port.servers[0].store.get_volume(6)
    dat = read(pv.base_name + ".dat")
    stamps = [0] + [pv.read_needle(nid).append_at_ns for nid in sorted(blobs)]
    for since in stamps + [stamps[-1] + 1]:
        got = [http_request("GET", f"{side.url(0)}/admin/tail?volume=6&since_ns={since}")
               for side in (sh.ref, sh.port)]
        assert got[0][0] == got[1][0] == 200 and got[0][2] == got[1][2]
        start = pv.binary_search_by_append_at_ns(since) if since else 8
        assert got[1][2] == dat[start:]
    for side in (sh.ref, sh.port):
        assert http_request("GET", f"{side.url(0)}/admin/tail?volume=66")[0] == 404


DOCS = [{"name": "ann", "age": 31, "city": {"name": "Oslo"}, "tags": ["a", "b"]},
        {"name": "bob", "age": 17, "city": {"name": "Lima"}, "tags": ["c"]},
        {"name": "cid", "age": "44", "city": {"name": "Oslo"}},
        {"name": "dee", "age": 25}]
CSV = b"name,age,city\nann,31,Oslo\nbob,17,Lima\ncid,44,Oslo\n"
QUERIES = [
    {"type": "json"},
    {"type": "json", "where": {"field": "age", "op": ">=", "value": 21}},
    {"type": "json", "where": {"field": "city.name", "op": "=", "value": "Oslo"},
     "select": ["name", "tags.1"]},
    {"type": "json", "where": {"or": [{"field": "age", "op": "<", "value": 20},
                                      {"not": {"field": "name", "op": "like",
                                               "value": "%e%"}}]}, "limit": 2},
    {"type": "json", "where": {"field": "age", "op": "~~", "value": 1}},
    {"type": "csv", "where": {"field": "age", "op": ">", "value": "20"},
     "select": ["name"]},
    {"type": "csv", "header": False, "where": {"field": "_3", "op": "=", "value": "Oslo"}},
    {"type": "csv", "delimiter": ";"},
]


@pytest.fixture(scope="module")
def query_shells():
    """One JAX and one port server holding the same JSON-lines, JSON array
    and CSV needles in volume 8."""
    bodies = {1: b"\n".join(json.dumps(d).encode() for d in DOCS),
              2: json.dumps(DOCS).encode(), 3: CSV}
    with twin(racks=("r1",)) as (ref, port):
        with pinned_clock(1_700_000_000):
            for side in (ref, port):
                allocate(side, 8, [0])
                for nid, data in bodies.items():
                    write(side, 0, 8, nid, data)
        yield Shells(ref, port)


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_query_equals_reference(query_shells, q):
    """POST /query over JSON-lines, a JSON array and a CSV needle, and a
    bad fid and a missing needle: equal status and answer."""
    sh = query_shells
    for nid in (1, 2, 3, 9):
        answers = []
        for side in (sh.ref, sh.port):
            status, _, out = http_request(
                "POST", f"{side.url(0)}/query",
                body=json.dumps({"fid": fid(8, nid), **QUERIES[q]}).encode(),
                headers={"Content-Type": "application/json"})
            answers.append((status, json.loads(out)))
        assert answers[0] == answers[1], (nid, answers)
    for side in (sh.ref, sh.port):
        status, _, out = http_request("POST", f"{side.url(0)}/query",
                                      body=json.dumps({"fid": "x,zz"}).encode())
        assert status == 400


def test_tier_route_errors_equal_reference(shells):
    """An unknown backend kind, a writable volume's upload and an untiered
    volume's download: the same status and error from both servers."""
    sh = shells
    answers = []
    for side in (sh.ref, sh.port):
        allocate(side, 2, [0])
        for path, body in (("backend/configure", {"id": "c", "kind": "nope"}),
                           ("backend/configure", {"kind": "local"}),
                           ("volume/tier_upload", {"volume": 2, "backend": "c"}),
                           ("volume/tier_upload", {"volume": 3, "backend": "c"}),
                           ("volume/tier_download", {"volume": 2})):
            status, _, out = http_request("POST", f"{side.url(0)}/admin/{path}",
                                          body=json.dumps(body).encode())
            answers.append((status, json.loads(out)))
    assert answers[:5] == answers[5:]
    assert [a[0] for a in answers[:5]] == [400, 400, 409, 404, 409]
