"""The port's replication plane held against the JAX package's: sinks, the
event dispatcher, `filer.sync` between filers, and the `filer.replicate`
and `filer.backup` commands.

`Replicator` applies one event list to both packages' `LocalSink`s: the
trees are equal, renames, superseded creates (a read that ends in 404) and
skipped system-log events included, and a transient read failure leaves
both untouched. `FilerSyncer` syncs two port clusters one way and both
ways with no event looping back; the parity case runs a port `FilerSyncer`
from a JAX filer to a port filer and back (the wire is shared), the trees
equal by their bytes. `S3Sink` replicates into the port's own S3 gateway.
`run_filer_replicate -once` and `run_filer_backup -once` of each package
over the same port filer write equal trees, byte for byte; `run_filer_sync`
runs end to end on its own threads until it is interrupted.

Every cluster here runs on the CPU (`device="cpu"`), with 4 KiB chunks so
that most files span several.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.command import filer_sync as ref_cmd
from seaweedfs_tpu.filer.filer_client import FilerClient as RefFilerClient
from seaweedfs_tpu.replication import LocalSink as RefLocalSink
from seaweedfs_tpu.replication import Replicator as RefReplicator
from seaweedfs_tpu_torch.command import filer_sync as cmd
from seaweedfs_tpu_torch.filer.filer_client import FilerClient
from seaweedfs_tpu_torch.notification import FileQueue
from seaweedfs_tpu_torch.replication import (
    FilerSink,
    FilerSyncer,
    LocalSink,
    Replicator,
    S3Sink,
)
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests.test_torch_filer_meta import twin

CHUNK = 4096


def seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def disk_tree(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        for name in dirs:
            out[os.path.normpath(os.path.join(rel, name)) + "/"] = None
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.normpath(os.path.join(rel, name))] = f.read()
    return out


def filer_tree(client, root: str) -> dict:
    """{path: bytes, or None for a directory} under root."""
    out = {}

    def walk(d: str) -> None:
        for e in client.list(d).get("Entries") or []:
            if e["IsDirectory"]:
                out[e["FullPath"] + "/"] = None
                walk(e["FullPath"])
            else:
                out[e["FullPath"]] = client.read(e["FullPath"])
    walk(root)
    return out


@contextlib.contextmanager
def port_cluster(tmp, notification_queue=None):
    m = MasterServer(port=0, pulse_seconds=1)
    m.start()
    v = VolumeServer([tempfile.mkdtemp(dir=tmp)], m.url, port=0, pulse_seconds=1,
                     device="cpu")
    v.start()
    v.heartbeat_once()
    f = None
    try:
        f = FilerServer(m.url, port=0, device="cpu", notification_queue=notification_queue)
        f.chunk_size = CHUNK
        f.start()
        yield f
    finally:
        if f is not None:
            f.stop()
        v.stop()
        m.stop()


@contextlib.contextmanager
def clients(*urls):
    cs = [FilerClient(u) for u in urls]
    try:
        yield cs
    finally:
        for c in cs:
            c.close()


@contextlib.contextmanager
def syncer(source_url: str, target_url: str):
    s = FilerSyncer(source_url, target_url)
    try:
        yield s
    finally:
        s.close()


# --- the dispatcher ---------------------------------------------------------------------
def events_and_store():
    """An event list with its source's contents; a path whose read 404s
    was superseded at the source."""
    d = {"full_path": "/d", "is_directory": True}
    f = {"full_path": "/d/f.txt", "is_directory": False}
    g = {"full_path": "/d/g.txt", "is_directory": False}
    gone = {"full_path": "/d/gone 404.txt", "is_directory": False}
    sub = {"full_path": "/d/sub", "is_directory": True}
    h = {"full_path": "/d/sub/h.bin", "is_directory": False}
    store = {"/d/f.txt": b"v2", "/d/g.txt": b"v2", "/d/sub/h.bin": seeded(3000, 1)}
    events = [
        {"old_entry": None, "new_entry": d},
        {"old_entry": None, "new_entry": f},
        {"old_entry": f, "new_entry": f},  # update
        {"old_entry": None, "new_entry": gone},  # superseded create: skipped
        {"old_entry": f, "new_entry": g},  # rename
        {"old_entry": gone, "new_entry": {**gone, "full_path": "/d/gone2.txt"}},
        {"old_entry": None, "new_entry": {"full_path": "/topics/.system/log/x"}},
        {"old_entry": {"full_path": "/topics/.system/log/y"}, "new_entry": None},
        {"old_entry": None, "new_entry": sub},
        {"old_entry": None, "new_entry": h},
        {"old_entry": None, "new_entry": {"full_path": "/e/k.txt"}},
        {"old_entry": {"full_path": "/e/k.txt"}, "new_entry": None},  # delete
    ]
    store["/e/k.txt"] = b"k"
    return events, store


def read_from(store):
    def read(path, entry):
        if path not in store:
            raise IOError(f"GET {path} -> 404")
        return store[path]
    return read


def test_replicator_trees_equal_reference(tmp_path):
    events, store = events_and_store()
    trees = []
    for sink_cls, rep_cls, name in ((RefLocalSink, RefReplicator, "ref"),
                                    (LocalSink, Replicator, "port")):
        rep = rep_cls(sink_cls(str(tmp_path / name)), read_content=read_from(store))
        for ev in events:
            rep.replicate(ev)
        trees.append(disk_tree(tmp_path / name))
    assert trees[1] == trees[0]
    assert trees[1] == {"d/": None, "d/g.txt": b"v2", "d/sub/": None,
                        "d/sub/h.bin": store["/d/sub/h.bin"], "e/": None}


def test_replicator_transient_failure_leaves_the_sink_untouched(tmp_path):
    """A read that fails for another reason raises before the sink moves:
    a rename's old key stays, in both packages."""
    for sink_cls, rep_cls, name in ((RefLocalSink, RefReplicator, "ref"),
                                    (LocalSink, Replicator, "port")):
        sink = sink_cls(str(tmp_path / name))
        sink.create_entry("/a.txt", {}, b"old")

        def read(path, entry):
            raise IOError(f"GET {path} -> 500")  # the path holds "404"; the status does not

        rep = rep_cls(sink, read_content=read)
        with pytest.raises(IOError, match="-> 500"):
            rep.replicate({"old_entry": {"full_path": "/a.txt"},
                           "new_entry": {"full_path": "/b 404"}})
        assert disk_tree(tmp_path / name) == {"a.txt": b"old"}


def test_local_sink_directory_delete_and_missing(tmp_path):
    for sink_cls, name in ((RefLocalSink, "ref"), (LocalSink, "port")):
        sink = sink_cls(str(tmp_path / name))
        sink.create_entry("/x/y/z.bin", {}, None)
        sink.update_entry("/x/w.txt", {}, b"w")
        sink.delete_entry("/x/y", True)
        sink.delete_entry("/nope.txt", False)  # a missing file is no error
    assert disk_tree(tmp_path / "port") == disk_tree(tmp_path / "ref") == {
        "x/": None, "x/w.txt": b"w"}


def test_read_error_text_pins_the_superseded_rule(tmp_path):
    """The port's `FilerClient.read` raises the JAX client's text for a
    missing path, `GET <path> -> 404`, which `Replicator` reads as a
    superseded create by its status suffix."""
    with twin(str(tmp_path)) as (ref, port):
        path = "/no/such 404 file.txt"
        errors = []
        with clients(port.filer.url) as (source,):
            for client in (RefFilerClient(ref.filer.url), source):
                with pytest.raises(IOError) as e:
                    client.read(path)
                errors.append(str(e.value))
            assert errors[1] == errors[0] == f"GET {path} -> 404"
            rep = Replicator(LocalSink(str(tmp_path / "m")),
                             read_content=lambda p, e: source.read(p))
            rep.replicate({"old_entry": None, "new_entry": {"full_path": path}})
        assert disk_tree(tmp_path / "m") == {}


# --- filer.sync -------------------------------------------------------------------------
@pytest.fixture()
def two_port_clusters(tmp_path):
    with port_cluster(str(tmp_path)) as fa, port_cluster(str(tmp_path)) as fb:
        yield fa, fb


def test_one_way_sync(two_port_clusters):
    fa, fb = two_port_clusters
    with clients(fa.url, fb.url) as (ca, cb), syncer(fa.url, fb.url) as ab:
        data = seeded(3 * CHUNK + 100, 2)
        ca.put("/docs/one.bin", data)
        ca.mkdir("/docs/empty")
        assert ab.run_once() >= 2
        assert cb.read("/docs/one.bin") == data
        assert cb.get_entry("/docs/empty")["is_directory"]
        ca.rename("/docs/one.bin", "/docs/two.bin")
        ab.run_once()
        assert not cb.exists("/docs/one.bin") and cb.read("/docs/two.bin") == data
        ca.delete("/docs/two.bin")
        ab.run_once()
        assert not cb.exists("/docs/two.bin")
        assert filer_tree(cb, "/docs") == filer_tree(ca, "/docs")


def test_bidirectional_no_loop(two_port_clusters):
    fa, fb = two_port_clusters
    with clients(fa.url, fb.url) as (ca, cb), \
            syncer(fa.url, fb.url) as ab, syncer(fb.url, fa.url) as ba:
        assert ab.source_signature == fa.filer.signature == ba.target_signature
        ca.put("/from_a.txt", b"written on A")
        cb.put("/from_b.bin", seeded(2 * CHUNK, 3))
        for _ in range(4):  # alternating rounds converge and do not bounce
            ab.run_once()
            ba.run_once()
        assert cb.read("/from_a.txt") == b"written on A"
        assert ca.read("/from_b.bin") == seeded(2 * CHUNK, 3)
        # replayed events carry the source's signature: nothing more applies
        assert ab.run_once() == 0
        assert ba.run_once() == 0


def test_filer_sink_signature_attached(two_port_clusters):
    _, fb = two_port_clusters
    sink = FilerSink(fb.url, extra_signature=777)
    try:
        sink.create_entry("/tag.txt", {"is_directory": False}, b"x")
        sink.create_entry("/tagdir", {"is_directory": True}, None)
        sink.delete_entry("/tagdir", True)
    finally:
        sink.close()
    evs = fb.filer.events_since(0)
    tagged = [e for e in evs if e.new_entry and e.new_entry.full_path == "/tag.txt"]
    assert tagged and 777 in tagged[-1].signatures
    deleted = [e for e in evs if e.old_entry and not e.new_entry
               and e.old_entry.full_path == "/tagdir"]
    assert deleted and 777 in deleted[-1].signatures


def test_run_forever_on_threads_converges(two_port_clusters):
    """Both directions on threads with a stop event, as `run_filer_sync`
    builds them; the stop ends both loops."""
    fa, fb = two_port_clusters
    stop = threading.Event()
    with clients(fa.url, fb.url) as (ca, cb), \
            syncer(fa.url, fb.url) as ab, syncer(fb.url, fa.url) as ba:
        threads = [threading.Thread(target=s.run_forever, args=(0.2, stop), daemon=True)
                   for s in (ab, ba)]
        for t in threads:
            t.start()
        try:
            files = {f"/t/a{i}.bin": seeded(500 * i + 1, 10 + i) for i in range(6)}
            for i, (path, body) in enumerate(files.items()):
                (ca if i % 2 else cb).put(path, body)
            deadline = time.time() + 20
            while time.time() < deadline:
                if all(cb.exists(p) and ca.exists(p) for p in files):
                    break
                time.sleep(0.1)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert filer_tree(ca, "/t") == filer_tree(cb, "/t") == {
            "/t/" + p.rsplit("/", 1)[1]: b for p, b in files.items()}


def test_run_filer_sync_end_to_end(two_port_clusters, monkeypatch, capsys):
    """The CLI's own threads sync both ways until its sleep is interrupted."""
    fa, fb = two_port_clusters
    with clients(fa.url, fb.url) as (ca, cb):
        ca.put("/cli/old.txt", b"before the cursors")

        def sleep(seconds):
            # the syncers' threads run: write on both sides, wait, interrupt
            ca.put("/cli/a.txt", b"A")
            cb.put("/cli/b.txt", b"B")
            deadline = time.time() + 20
            while time.time() < deadline and not (cb.exists("/cli/a.txt")
                                                  and ca.exists("/cli/b.txt")):
                time.sleep(0.05)
            raise KeyboardInterrupt

        monkeypatch.setattr(cmd, "time", types.SimpleNamespace(sleep=sleep))
        before = set(threading.enumerate())
        assert cmd.run_filer_sync(["-a", fa.url, "-b", fb.url, "-interval", "0.2"]) == 0
        loops = [t for t in set(threading.enumerate()) - before
                 if getattr(getattr(t, "_target", None), "__qualname__", "")
                 == "FilerSyncer.run_forever"]
        assert len(loops) == 2
        for t in loops:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in loops)
        assert cb.read("/cli/a.txt") == b"A" and ca.read("/cli/b.txt") == b"B"
        assert not cb.exists("/cli/old.txt")  # older than the cursors
    out = capsys.readouterr().out
    assert f"sync {fa.url} -> {fb.url} (sig {fa.filer.signature})" in out
    assert f"sync {fb.url} -> {fa.url} (sig {fb.filer.signature})" in out


def test_port_syncer_between_jax_and_port_filers(tmp_path):
    """The parity case: a port FilerSyncer carries a JAX filer's history to
    a port filer, and another carries the port filer's own writes back."""
    with twin(str(tmp_path)) as (ref, port):
        ref_url, port_url = ref.filer.url, port.filer.url
        with clients(port_url) as (cp,), syncer(ref_url, port_url) as jp, \
                syncer(port_url, ref_url) as pj:
            cr = RefFilerClient(ref_url)
            cr.put("/x/small.txt", b"small")
            cr.put("/x/big.bin", seeded(5 * CHUNK + 7, 4))
            cr.mkdir("/x/dir")
            cr.put("/x/gone.bin", seeded(100, 5))
            cr.rename("/x/big.bin", "/x/dir/big.bin")
            cr.delete("/x/gone.bin")
            cp.put("/y/from_port.bin", seeded(2 * CHUNK + 1, 6))
            cp.put("/y/inline.txt", b"i")
            for _ in range(3):
                jp.run_once()
                pj.run_once()
            ref_tree = filer_tree(cr, "/x") | filer_tree(cr, "/y")
            assert filer_tree(cp, "/x") | filer_tree(cp, "/y") == ref_tree
            assert ref_tree["/x/dir/big.bin"] == seeded(5 * CHUNK + 7, 4)
            assert "/x/gone.bin" not in ref_tree and "/x/big.bin" not in ref_tree
            assert jp.run_once() == 0 and pj.run_once() == 0  # no loop across packages


# --- S3 sink ------------------------------------------------------------------------------
def test_s3_sink_into_the_port_gateway(tmp_path):
    from seaweedfs_tpu_torch.s3api import S3Client, S3Server

    with port_cluster(str(tmp_path)) as filer:
        s3 = S3Server(filer.url, port=0, config={"identities": [
            {"name": "admin", "credentials": [{"accessKey": "k", "secretKey": "s"}],
             "actions": ["Admin"]}]})
        s3.start()
        try:
            sink = S3Sink(s3.url, "mirror", access_key="k", secret_key="s", prefix="backup")
            rep = Replicator(sink, read_content=lambda path, entry: b"payload-1")
            rep.replicate({"old_entry": None, "new_entry": {"full_path": "/docs/a.txt"}})
            rep.replicate({"old_entry": None,
                           "new_entry": {"full_path": "/docs/sub", "is_directory": True}})
            rep.replicate({"old_entry": None, "new_entry": {"full_path": "/docs/sub/c.txt"}})
            client = S3Client(s3.url, "k", "s")
            assert client.get_object("mirror", "backup/docs/a.txt") == b"payload-1"
            rep.replicate({"old_entry": {"full_path": "/docs/a.txt"},
                           "new_entry": {"full_path": "/docs/b.txt"}})  # rename
            keys = [c["key"] for c in client.list_objects("mirror", prefix="backup/")["contents"]]
            assert "backup/docs/a.txt" not in keys and "backup/docs/b.txt" in keys
            assert "backup/docs/sub/c.txt" in keys
            rep.replicate({"old_entry": {"full_path": "/docs/b.txt"}, "new_entry": None})
            rep.replicate({"old_entry": {"full_path": "/docs/sub", "is_directory": True},
                           "new_entry": None})  # the subtree goes
            assert client.list_objects("mirror", prefix="backup/")["contents"] == []
            S3Sink(s3.url, "mirror", access_key="k", secret_key="s")  # the bucket exists: fine
        finally:
            s3.stop()


# --- filer.replicate and filer.backup ----------------------------------------------------
def write_history(client) -> None:
    client.put("/pics/a.bin", seeded(3000, 7))
    client.put("/pics/sub/b.txt", b"hello backup")
    client.put("/pics/big.bin", seeded(4 * CHUNK + 11, 8))
    client.mkdir("/pics/empty")
    client.put("/pics/old.bin", seeded(10, 9))
    client.rename("/pics/old.bin", "/pics/sub/new.bin")
    client.put("/pics/tmp.bin", b"t")
    client.delete("/pics/tmp.bin")
    client.put("/pics/a.bin", seeded(3100, 10))  # an overwrite


def test_replicate_once_equals_reference(tmp_path, capsys):
    spool = str(tmp_path / "spool")
    with port_cluster(str(tmp_path), notification_queue=FileQueue(spool)) as filer:
        with clients(filer.url) as (c,):
            write_history(c)
            want = filer_tree(c, "/pics")
        trees = []
        for run, name in ((ref_cmd.run_filer_replicate, "ref"),
                          (cmd.run_filer_replicate, "port")):
            out = str(tmp_path / name)
            assert run(["-notification.spool", spool, "-source", filer.url,
                        "-sink.local", out, "-once"]) == 0
            trees.append(disk_tree(out))
    assert trees[1] == trees[0]
    assert {k: v for k, v in trees[1].items() if k.startswith("pics")} == {
        k.lstrip("/").rstrip("/") + ("/" if v is None else ""): v for k, v in want.items()
    } | {"pics/": None}
    assert cmd.run_filer_replicate(["-notification.spool", spool, "-source", filer.url]) == 1
    assert "need a -sink" in capsys.readouterr().out


def test_replicate_once_into_a_filer_sink(tmp_path):
    spool = str(tmp_path / "spool")
    with port_cluster(str(tmp_path), notification_queue=FileQueue(spool)) as src, \
            port_cluster(str(tmp_path)) as dst:
        with clients(src.url, dst.url) as (cs, cd):
            write_history(cs)
            assert cmd.run_filer_replicate(["-notification.spool", spool, "-source", src.url,
                                            "-sink.filer", dst.url, "-once"]) == 0
            assert filer_tree(cd, "/pics") == filer_tree(cs, "/pics")


def test_backup_once_equals_reference(tmp_path, capsys):
    with port_cluster(str(tmp_path)) as filer:
        with clients(filer.url) as (c,):
            write_history(c)
            want = filer_tree(c, "/pics")
        trees = []
        for run, name in ((ref_cmd.run_filer_backup, "ref"), (cmd.run_filer_backup, "port")):
            out = str(tmp_path / name)
            assert run(["-filer", filer.url, "-output", out, "-once", "-path", "/pics"]) == 0
            trees.append(disk_tree(out))
    assert trees[1] == trees[0]
    assert trees[1]["pics/sub/b.txt"] == b"hello backup"
    assert trees[1]["pics/a.bin"] == want["/pics/a.bin"] == seeded(3100, 10)
    assert trees[1]["pics/big.bin"] == want["/pics/big.bin"]
    assert "initial backup of /pics complete" in capsys.readouterr().out
