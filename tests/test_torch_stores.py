"""The port's filer stores held against the JAX package's, kind for kind:
`leveldb` (`filer/kvstore.py`), `lsm` (`filer/lsm.py`), `etcd`
(`filer/etcd.py`, against `tests/fake_etcd.py`), `redis`, `mysql` and
`postgres` (`filer/stores_gated.py`, against `tests/fake_redis.py` and the
sqlite-backed DB-API shim of `tests/fake_dbapi.py`), and `make_store` over
every kind.

Each case runs the same seeded operations through a JAX `Filer` on the JAX
store and a port `Filer` on the port store: creates, an update, hard links,
renames of a file and a directory, a recursive delete, paged listings and
the store's kv namespace. The trees, the pages and the freed chunks must be
equal, and the on-disk files of the two embedded engines (`LocalKV`,
`LsmKV`) equal byte for byte after the same puts and deletes. Tolerance:
byte equality.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from seaweedfs_tpu.filer import Entry as RefEntry
from seaweedfs_tpu.filer import FileChunk as RefFileChunk
from seaweedfs_tpu.filer import Filer as RefFiler
from seaweedfs_tpu.filer import filerstore as ref_filerstore
from seaweedfs_tpu.filer import kvstore as ref_kvstore
from seaweedfs_tpu.filer import lsm as ref_lsm
from seaweedfs_tpu.filer import stores_gated as ref_gated
from seaweedfs_tpu_torch.filer import Entry, FileChunk, Filer
from seaweedfs_tpu_torch.filer import filerstore as port_filerstore
from seaweedfs_tpu_torch.filer import kvstore as port_kvstore
from seaweedfs_tpu_torch.filer import lsm as port_lsm
from seaweedfs_tpu_torch.filer import stores_gated as port_gated

from .fake_dbapi import install
from .fake_etcd import FakeEtcd
from .fake_redis import FakeRedis

KINDS = ["leveldb", "lsm", "etcd", "redis", "mysql", "postgres", "memory", "sqlite"]


class Pkg:
    def __init__(self, name, entry, chunk, filer, filerstore, kvstore, lsm, gated):
        self.name = name
        self.Entry = entry
        self.FileChunk = chunk
        self.Filer = filer
        self.filerstore = filerstore
        self.kvstore = kvstore
        self.lsm = lsm
        self.gated = gated


REF = Pkg("ref", RefEntry, RefFileChunk, RefFiler, ref_filerstore, ref_kvstore,
          ref_lsm, ref_gated)
PORT = Pkg("port", Entry, FileChunk, Filer, port_filerstore, port_kvstore,
           port_lsm, port_gated)


def make(pkg: Pkg, kind: str, tmp_path, request):
    """One package's store of `kind`, through `make_store` where the kind
    needs no injected client (redis takes its fake as `client=`)."""
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    if kind == "redis":
        return pkg.gated.RedisStore(client=FakeRedis())
    if kind in ("mysql", "postgres"):
        driver = "pymysql" if kind == "mysql" else "psycopg2"
        uninstall = install(driver, str(d / f"{driver}.db"))
        request.addfinalizer(uninstall)
        return pkg.filerstore.make_store(kind)
    if kind == "etcd":
        fake = FakeEtcd()
        request.addfinalizer(fake.stop)
        return pkg.filerstore.make_store(kind, fake.endpoint)
    if kind == "sqlite":
        return pkg.filerstore.make_store(kind, str(d / "meta.db"))
    if kind == "memory":
        return pkg.filerstore.make_store(kind)
    return pkg.filerstore.make_store(kind, str(d / kind))


def _file(pkg: Pkg, path: str, content=b"", size=0, chunks=()):
    e = pkg.Entry(full_path=path)
    e.attributes.mtime = e.attributes.crtime = 1_700_000_000.0
    e.attributes.mime = "application/octet-stream"
    e.attributes.file_size = size or len(content)
    e.content = content
    e.chunks = [pkg.FileChunk(file_id=fid, offset=i * 100, size=100, etag=f"{i:032x}")
                for i, fid in enumerate(chunks)]
    return e


def _ops(filer, pkg: Pkg, seed: int) -> dict:
    """A seeded history; returns what each step answered."""
    rng = np.random.default_rng(seed)
    out = {}
    names = [f"f{i:02d}" for i in rng.permutation(24)]
    for i, name in enumerate(names):
        d = f"/s/d{i % 3}"
        if i % 4 == 0:
            filer.create_entry(_file(pkg, f"{d}/{name}", size=300,
                                     chunks=[f"{3 + i % 2},{i:02x}{j}" for j in range(3)]))
        else:
            filer.create_entry(_file(pkg, f"{d}/{name}", rng.bytes(int(rng.integers(1, 64)))))
    upd = filer.find_entry(f"/s/d1/{names[1]}")
    upd.content = b"updated"
    upd.attributes.file_size = 7
    filer.update_entry(upd)
    # the SQL kinds have no kv namespace, so no hard links (in both packages)
    has_kv = type(filer.store).kv_put is not pkg.filerstore.FilerStore.kv_put
    if has_kv:
        out["nlink"] = filer.create_hard_link(f"/s/d0/{names[0]}", "/s/link").hard_link_counter
    else:
        with pytest.raises(NotImplementedError):
            filer.create_hard_link(f"/s/d0/{names[0]}", "/s/link")
    filer.rename(f"/s/d2/{names[2]}", "/s/d2/renamed")
    filer.rename("/s/d1", "/s/moved")
    out["freed"] = sorted(c.file_id for c in filer.delete_entry("/s/d2", recursive=True))
    with pytest.raises(Exception, match="not empty"):
        filer.delete_entry("/s", recursive=False)
    filer.create_entry(_file(pkg, "/s/d2/again", b"x"))
    out["pages"] = [
        [e.name for e in filer.list_entries("/s/moved", last, inclusive, 3)]
        for last, inclusive in [("", False), (sorted(names)[3], False),
                                (sorted(names)[3], True), ("zz", False)]
    ]
    # the meta log's 2 s flusher may or may not have written /topics by
    # now: flushed here, both sides list it
    filer.log_buffer.flush()
    out["root"] = [e.name for e in filer.list_entries("/", limit=10)]
    if has_kv:
        store = filer.store
        store.kv_put("k/one", b"\x00\x01raw")
        store.kv_put("k/two", b"2")
        store.kv_put("k/two", b"22")
        out["kv"] = [store.kv_get("k/one"), store.kv_get("k/two"), store.kv_get("k/none")]
    return out


def _tree(filer) -> dict:
    """Every entry under the root by path, times the filer stamps dropped and
    a hard link's random id reduced to its presence; the meta log's own
    segments (/topics) are left out."""
    out = {}
    pending = ["/"]
    while pending:
        d = pending.pop()
        for e in filer.list_entries(d, limit=1 << 20):
            if e.full_path.startswith("/topics"):
                continue
            rec = e.to_dict()
            for k in ("mtime", "crtime"):
                rec["attributes"].pop(k)
            if "hard_link_id" in rec:
                rec["hard_link_id"] = bool(rec["hard_link_id"])
            if e.is_directory:
                pending.append(e.full_path)
            out[e.full_path] = rec
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_operations_equal_reference(kind, tmp_path, request):
    ref = RefFiler(make(REF, kind, tmp_path, request))
    port = Filer(make(PORT, kind, tmp_path, request))
    try:
        assert type(port.store).__name__ == type(ref.store).__name__
        got, want = _ops(port, PORT, seed=3), _ops(ref, REF, seed=3)
        assert got == want
        assert len(got["freed"]) == 6
        tree = _tree(port)
        assert tree == _tree(ref)
        assert "/s/moved" in tree and "/s/d1" not in tree and "/s/d2/again" in tree
        if kind not in ("mysql", "postgres"):
            assert got["kv"] == [b"\x00\x01raw", b"22", None]
            # the hard link shares its target's record through the kv namespace
            assert got["nlink"] == port.find_entry("/s/link").hard_link_counter == 2
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("kind", ["leveldb", "lsm", "sqlite", "mysql", "postgres"])
def test_reopened_store_lists_equal(kind, tmp_path, request):
    """The persistent kinds reopen on the same path with every entry."""
    trees = []
    for pkg in (REF, PORT):
        f = pkg.Filer(make(pkg, kind, tmp_path, request))
        _ops(f, pkg, seed=5)
        f.close()
        again = pkg.Filer(make(pkg, kind, tmp_path, request))
        try:
            trees.append(_tree(again))
            if kind not in ("mysql", "postgres"):
                assert again.store.kv_get("k/one") == b"\x00\x01raw"
        finally:
            again.close()
    assert trees[0] == trees[1] and "/s/moved" in trees[1]


def test_root_listing_excludes_itself(tmp_path, request):
    for kind in KINDS:
        got = []
        for pkg in (REF, PORT):
            sub = tmp_path / kind
            sub.mkdir(exist_ok=True)
            store = make(pkg, kind, sub, request)
            store.insert_entry(pkg.Entry(full_path="/", is_directory=True))
            store.insert_entry(_file(pkg, "/a", b"1"))
            store.insert_entry(pkg.Entry(full_path="/d", is_directory=True))
            got.append([e.full_path for e in store.list_entries("/", "", False, 10)])
            store.close()
        assert got[0] == got[1] == ["/a", "/d"], kind


# --- make_store ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,path", [
    ("sqlite", None), ("lsm", None), ("leveldb", None), ("nope", None),
])
def test_make_store_refusals_equal_reference(kind, path):
    errs = []
    for pkg in (REF, PORT):
        with pytest.raises(ValueError) as e:
            pkg.filerstore.make_store(kind, path)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kind", ["redis", "mysql", "postgres"])
def test_gated_kinds_raise_without_their_driver(kind, monkeypatch):
    """With no driver importable the gated kinds refuse at construction,
    with the JAX package's message."""
    import sys

    for mod in ("redis", "pymysql", "psycopg2"):
        monkeypatch.setitem(sys.modules, mod, None)
    errs = []
    for pkg in (REF, PORT):
        with pytest.raises(RuntimeError, match="requires") as e:
            pkg.filerstore.make_store(kind)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_etcd_entries_live_in_etcd(tmp_path, request):
    fakes = []
    for pkg in (REF, PORT):
        fake = FakeEtcd()
        request.addfinalizer(fake.stop)
        f = pkg.Filer(pkg.filerstore.make_store("etcd", fake.endpoint))
        f.create_entry(_file(pkg, "/e/a.bin", b"payload"))
        f.close()
        fakes.append(fake)
    ref_keys = sorted(k for k in fakes[0].kv if not k.startswith(b"e/topics"))
    port_keys = sorted(k for k in fakes[1].kv if not k.startswith(b"e/topics"))
    assert port_keys == ref_keys and b"e/e\x00a.bin" in port_keys


# --- the embedded engines, byte for byte ---------------------------------------------
def _kv_history(kv, seed: int, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    oracle = {}
    for _ in range(n):
        k = f"key{int(rng.integers(300)):03d}".encode()
        if rng.random() < 0.3:
            kv.delete(k)
            oracle.pop(k, None)
        else:
            v = rng.bytes(int(rng.integers(1, 40)))
            kv.put(k, v)
            oracle[k] = v
    return oracle


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", [11, 12])
def test_lsm_kv_equals_reference_on_disk(seed, tmp_path):
    kvs = []
    for pkg in (REF, PORT):
        kv = pkg.lsm.LsmKV(str(tmp_path / pkg.name), memtable_bytes=700, max_tables=3)
        oracle = _kv_history(kv, seed)
        assert dict(kv.scan(b"key", b"kez")) == oracle
        assert all(kv.get(f"key{i:03d}".encode()) == oracle.get(f"key{i:03d}".encode())
                   for i in range(300))
        kvs.append((kv, oracle))
    (ref_kv, want), (port_kv, got) = kvs
    assert got == want
    assert len(port_kv._tables) == len(ref_kv._tables) > 0
    for kv, _ in kvs:
        kv.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    again = PORT.lsm.LsmKV(str(tmp_path / "port"))
    try:
        assert dict(again.scan(b"key", b"kez")) == got
    finally:
        again.close()


def test_lsm_overwrite_delete_and_compaction(tmp_path):
    for pkg in (REF, PORT):
        kv = pkg.lsm.LsmKV(str(tmp_path / pkg.name), memtable_bytes=512, max_tables=2)
        for round_no in range(5):
            for i in range(50):
                kv.put(f"k{i:03d}".encode(), f"v{round_no}-{i}".encode())
        for i in range(0, 50, 3):
            kv.delete(f"k{i:03d}".encode())
        kv.flush()
        assert len(kv._tables) <= 2
        for i in range(50):
            want = None if i % 3 == 0 else f"v4-{i}".encode()
            assert kv.get(f"k{i:03d}".encode()) == want, i
        kv.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("engine", ["lsm", "leveldb"])
def test_torn_log_tail_recovers(engine, tmp_path):
    """A crash mid-append leaves a torn record at the log's end: both
    engines reopen with every whole record and keep writing."""
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.name)
        kv = pkg.lsm.LsmKV(d) if engine == "lsm" else pkg.kvstore.LocalKV(d)
        kv.put(b"good", b"value")
        kv.close()
        logs = [n for n in os.listdir(d) if "wal" in n or n.endswith(".log")]
        assert logs, os.listdir(d)
        with open(os.path.join(d, logs[0]), "ab") as f:
            f.write(b"\x01\x30\x00")
        kv2 = pkg.lsm.LsmKV(d) if engine == "lsm" else pkg.kvstore.LocalKV(d)
        assert kv2.get(b"good") == b"value"
        kv2.put(b"after", b"crash")
        assert kv2.get(b"after") == b"crash"
        kv2.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("seed", [21, 22])
def test_local_kv_equals_reference_on_disk(seed, tmp_path):
    kvs = []
    for pkg in (REF, PORT):
        kv = pkg.kvstore.LocalKV(str(tmp_path / pkg.name))
        oracle = _kv_history(kv, seed)
        assert dict(kv.scan(b"key", b"kez")) == oracle
        kvs.append((kv, oracle))
    assert kvs[0][1] == kvs[1][1]
    for kv, _ in kvs:
        kv.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    again = PORT.kvstore.LocalKV(str(tmp_path / "port"))
    try:
        assert dict(again.scan(b"key", b"kez")) == kvs[1][1]
    finally:
        again.close()


def test_lsm_resident_bytes_bounded(tmp_path):
    """Cold data lives on disk in the port's LsmKV too: its resident
    footprint equals the JAX one's and stays far below the stored bytes."""
    sizes = []
    for pkg in (REF, PORT):
        kv = pkg.lsm.LsmKV(str(tmp_path / pkg.name), memtable_bytes=64 * 1024, max_tables=4)
        rng = np.random.default_rng(4)
        for i in range(4000):
            kv.put(f"k{i:06d}".encode(), rng.bytes(256))
        kv.flush()
        sizes.append(kv.resident_bytes())
        assert kv.get(b"k000000") is not None
        kv.close()
    assert sizes[0] == sizes[1] < 4000 * 256 / 5
