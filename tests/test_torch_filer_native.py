"""The port's filer behind its native front door (`server/filer.py`'s
`_fl_*` over the filer mode of `csrc/fastlane.cpp`), held against the JAX
filer behind its engine.

Each case starts a JAX cluster (master, volume server, filer) and a port
cluster (`device="cpu"`), every server behind its fastlane engine, sends
the same seeded requests to both filers and compares what comes back:
status, body and the headers that carry no clock (tolerance 0), the
entries each store holds after the drain, the journal frames, the
front-door metrics (native and fallback counts by reason) and the lease
events. Set aside are only what differs by construction: the stamps the
engine writes from the C clock (an entry's and its chunk's mtime) and the
fids of chunks (each master leases its own volume's key range). These are
the 14 cases of `tests/test_filer_native.py`, plus a filer mode the engine
refuses (the port raises), two port filers taking distinct gateway
ordinals (`tests/test_qos.py::TestLeaseShardingE2E`), and natively written
chunk files read natively after the drain (where the JAX filer's first
reads miss its engine's cache).

The JAX filer with a disk store journals in the temp directory, so each
case points `tempfile.tempdir` at its own folder.
"""

from __future__ import annotations

import json
import os
import re
import socket
import tempfile
import threading
import time
import types
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.filerstore import MemoryStore as RefMemoryStore
from seaweedfs_tpu.security import SecurityConfig as RefSecurityConfig
from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.stats import default_registry as ref_registry
from seaweedfs_tpu.stats import events as ref_events
from seaweedfs_tpu.stats import trace as ref_trace
from seaweedfs_tpu.storage import fastlane as ref_fl_mod
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_notify import SYSTEM_TREE_PREFIX
from seaweedfs_tpu_torch.filer.filerstore import MemoryStore
from seaweedfs_tpu_torch.security import SecurityConfig
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.stats import default_registry
from seaweedfs_tpu_torch.stats import events
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage import fastlane as fl_mod
from tests._threads import stop_history_loops  # noqa: F401

# headers that carry a clock, a random trace id or a connection detail
VARYING = {"date", "last-modified", "server", "connection", "keep-alive",
           "x-sw-trace-id"}


class Side:
    """One package's master and volume server behind their engines, and
    the filers started on them."""

    def __init__(self, pkg: str, root: str, security=None) -> None:
        self.pkg = pkg
        self.root = os.path.join(root, pkg)
        os.makedirs(self.root, exist_ok=True)
        self.ref = pkg == "ref"
        self.dev = {} if self.ref else {"device": "cpu"}
        self.filer_cls = RefFilerServer if self.ref else FilerServer
        self.fl_mod = ref_fl_mod if self.ref else fl_mod
        self.events = ref_events if self.ref else events
        self.registry = ref_registry if self.ref else default_registry
        self.trace = ref_trace if self.ref else trace
        self.filers: list = []
        self.m = (RefMasterServer if self.ref else MasterServer)(port=0, pulse_seconds=1)
        self.m.start()
        self.v = self.volume("v", security)

    def volume(self, name: str, security=None):
        sec = {"security": security} if security is not None else {}
        v = (RefVolumeServer if self.ref else VolumeServer)(
            [os.path.join(self.root, name)], self.m.url, port=0, pulse_seconds=1,
            **self.dev, **sec)
        v.start()
        assert v.fastlane is not None
        return v

    def filer(self, **kw):
        f = self.filer_cls(self.m.url, port=0, **self.dev, **kw)
        f.start()
        self.filers.append(f)
        return f

    def stop(self) -> None:
        for f in reversed(self.filers):
            f.stop()
        self.v.stop()
        self.m.stop()


@pytest.fixture
def twin(tmp_path, monkeypatch):
    own_tmp = tmp_path / "tmpdir"
    own_tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(own_tmp))
    ref = Side("ref", str(tmp_path))
    try:
        port = Side("port", str(tmp_path))
        try:
            yield ref, port
        finally:
            port.stop()
    finally:
        ref.stop()


def filers(twin, warm: bool = True, **kw) -> list:
    """A filer on each side, each behind its engine in filer mode. `warm`
    looks every volume up through each filer's client first: the JAX
    filer's drain keeps a natively written chunk entry in the engine's
    cache only when its volume is in that vid cache (else the first read
    goes to Python, whose answer carries other headers than the engine's
    relay; see test_drained_chunk_entries_stay_cached)."""
    out = [side.filer(**kw) for side in twin]
    assert all(f._fl_filer_on for f in out)
    if warm:
        for side, f in zip(twin, out):
            warm_vids(side, f)
    return out


def warm_vids(side, f) -> None:
    """Look every volume of the side's server up through the filer's client."""
    for vid in side.v.store.volume_ids():
        f.client.lookup(vid)


def answer(method: str, url: str, body: bytes | None = None, headers=None):
    """(status, headers but VARYING, body) of one request."""
    st, hdrs, data = http_request(method, url, body, headers or {})
    return st, {k.lower(): v for k, v in hdrs.items() if k.lower() not in VARYING}, data


def both(fs, method: str, path: str, body: bytes | None = None, headers=None):
    """The same request to the JAX and the port filer; equal answers."""
    got = [answer(method, f.url + path, body, headers) for f in fs]
    assert got[1] == got[0], (method, path, got)
    return got[1]


def both_meta(fs, path: str) -> dict:
    """`?metadata=true` of one path on both filers: equal entries, stamps
    and fids aside."""
    got = []
    for f in fs:
        st, _, body = http_request("GET", f.url + path + "?metadata=true")
        got.append((st, aside(json.loads(body))))
    assert got[1] == got[0] and got[1][0] == 200, (path, got)
    return got[1][1]


def seeded(seed: int, *sizes: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in sizes]


def aside(d: dict) -> dict:
    """An entry's dict with the C clock's stamps and chunk fids set aside."""
    d = json.loads(json.dumps(d))
    attrs = d.get("attributes", {})
    for k in ("mtime", "crtime"):
        attrs.pop(k, None)
    for c in d.get("chunks") or []:
        assert re.fullmatch(r"\d+,[0-9a-f]+", c.pop("file_id"))
        c.pop("modified_ts_ns", None)
    return d


def entries(f, root: str = "/") -> list[dict]:
    """Every entry under `root` after the drain, stamps and fids aside."""
    f._fl_filer_drain()
    out = []

    def walk(d: str) -> None:
        for e in f.filer.list_entries(d, limit=1 << 31):
            if e.full_path.startswith(("/etc/", "/topics/")):
                continue
            out.append(aside(e.to_dict()))
            if e.is_directory:
                walk(e.full_path)

    walk(root)
    return out


def same_entries(fs, root: str = "/") -> list[dict]:
    got = [entries(f, root) for f in fs]
    assert got[1] == got[0]
    return got[1]


def front(fs) -> dict:
    got = [f.fastlane.front_metrics() for f in fs]
    assert got[1] == got[0]
    return got[1]


def wait(fn, timeout: float = 10.0, msg: str = "condition") -> None:
    deadline = time.time() + timeout
    while not fn():
        assert time.time() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.05)


# --- TestNativeFilerPath --------------------------------------------------------
def test_inline_and_chunk_served_natively(twin):
    fs = filers(twin)
    small = b"tiny"
    (payload,) = seeded(1, 64 * 1024)
    # inline (<= SMALL_CONTENT_LIMIT): no volume hop at all
    st, _, body = both(fs, "POST", "/a/small.txt", small, {"Content-Type": "text/plain"})
    assert st == 201 and json.loads(body)["md5"]
    st, hdrs, body = both(fs, "GET", "/a/small.txt")
    assert st == 200 and body == small and hdrs["content-type"] == "text/plain"
    # chunk-backed (> inline limit): leased fid + native upload
    st, _, body = both(fs, "POST", "/a/big.bin", payload)
    assert st == 201
    md5 = json.loads(body)["md5"]
    st, hdrs, body = both(fs, "GET", "/a/big.bin")
    assert st == 200 and body == payload
    assert hdrs["etag"] == f'"{md5}"'  # the entry's md5, not the chunk's CRC
    # ranged read rides the relay; a conditional one ends in the engine
    st, _, body = both(fs, "GET", "/a/big.bin", headers={"Range": "bytes=100-199"})
    assert st == 206 and body == payload[100:200]
    assert both(fs, "GET", "/a/big.bin", headers={"If-None-Match": f'"{md5}"'})[0] == 304
    for f in fs:
        stats = f.fastlane.stats()
        assert stats["native_writes"] == 2
        assert stats["native_reads"] >= 3  # one read may take the relay fallback
    # the drained entries are real store entries (the metadata surface)
    d = both_meta(fs, "/a/big.bin")
    assert d["attributes"]["file_size"] == len(payload) and len(d["chunks"]) == 1
    ents = same_entries(fs)
    assert [e["full_path"] for e in ents] == ["/a", "/a/big.bin", "/a/small.txt"]
    assert front(fs)["write"]["native"] == 2


def test_hot_chunk_promotion(twin):
    """A small chunk-backed object's first read relays to the volume; its
    body is then promoted into the filer engine's inline cache, so repeat
    reads never touch the volume (and an overwrite replaces the
    promotion through the meta-log)."""
    fs = filers(twin)
    payload, payload2 = seeded(2, 8192, 9000)  # > inline limit, <= promotion cap
    assert both(fs, "POST", "/hot/a.bin", payload)[0] == 201
    st, _, body = both(fs, "GET", "/hot/a.bin")
    assert st == 200 and body == payload
    for side, f in zip(twin, fs):
        # three GETs in a row that leave the volume's native reads alone:
        # the object is promoted and stays promoted
        deadline = time.time() + 10
        quiet = 0
        while quiet < 3:
            before = side.v.fastlane.stats()["native_reads"]
            st, _, body = http_request("GET", f.url + "/hot/a.bin")
            assert st == 200 and body == payload
            quiet = quiet + 1 if side.v.fastlane.stats()["native_reads"] == before else 0
            assert time.time() < deadline, f"{side.pkg}: object never promoted"
    st, _, body = both(fs, "GET", "/hot/a.bin", headers={"Range": "bytes=100-199"})
    assert st == 206 and body == payload[100:200]
    assert both(fs, "POST", "/hot/a.bin", payload2)[0] == 201
    st, _, body = both(fs, "GET", "/hot/a.bin")
    assert st == 200 and body == payload2
    same_entries(fs)


def test_meta_log_invalidates_cache(twin):
    fs = filers(twin)
    assert both(fs, "POST", "/c/x.bin", b"q" * 5000)[0] == 201
    # a delete (acked natively: the entry is cached) tombstones the path at
    # once, and the drain's meta event then purges it: the read after it is
    # the tombstone's 404 or, once drained, the Python path's, whose bodies
    # differ, so only the status is compared
    assert both(fs, "DELETE", "/c/x.bin")[0] in (200, 204)
    assert [http_request("GET", f.url + "/c/x.bin")[0] for f in fs] == [404, 404]
    # a rename invalidates the old path and serves the new one
    assert both(fs, "POST", "/c/a.bin", b"r" * 5000)[0] == 201
    assert both(fs, "POST", "/c/b.bin?mv.from=/c/a.bin", b"")[0] == 200
    assert both(fs, "GET", "/c/a.bin")[0] == 404
    st, _, body = both(fs, "GET", "/c/b.bin")
    assert st == 200 and body == b"r" * 5000
    # an overwrite through the native path replaces the cached blob
    assert both(fs, "POST", "/c/b.bin", b"s" * 4000)[0] == 201
    st, _, body = both(fs, "GET", "/c/b.bin")
    assert st == 200 and body == b"s" * 4000
    assert [e["full_path"] for e in same_entries(fs)] == ["/c", "/c/b.bin"]


def _frames(server_cls, buf: bytes) -> list[tuple]:
    """A journal's frames as one package's filer parses them."""
    return list(server_cls._fl_parse_frames(server_cls, buf))


def test_journal_replay_after_crash(twin):
    """An acked native write whose entry never reached the store (the
    process died before the drain) is recovered from the journal. The two
    journals hold the same frames but for the C clock's mtime and the fid;
    either package parses either journal to the same frames, and the same
    frames applied through either package's `_fl_apply` make byte-equal
    entries."""
    (payload,) = seeded(3, 10000)
    journals, first = [], []
    for side in twin:
        store = os.path.join(side.root, "filer_store")
        os.makedirs(store)
        f1 = side.filer(store_kind="lsm", store_path=store)
        assert f1._fl_filer_on
        f1._fl_filer_drain = lambda *a, **k: 0  # a Python stall: nothing drains
        first.append([
            answer("POST", f1.url + "/crash/keep.txt", b"survives"),
            answer("POST", f1.url + "/crash/keep.bin", payload),
        ])
        assert f1.filer.find_entry("/crash/keep.txt") is None  # stalled
        with open(f1._fl_journal_path, "rb") as fh:
            journals.append(fh.read())
        if side.ref:
            assert f1._fl_journal_path == os.path.join(tempfile.gettempdir(),
                                                       "filer_native.journal")
        else:  # inside the store's own directory
            assert f1._fl_journal_path == os.path.join(store, "filer_native.journal")
        f1.stop()  # crash: the frames are never applied
        side.filers.remove(f1)
    assert first[1] == first[0] and [a[0] for a in first[0]] == [201, 201]
    parsed = [[_frames(cls, j) for j in journals] for cls in (RefFilerServer, FilerServer)]
    assert parsed[0] == parsed[1]  # each journal parses alike in both packages

    def no_clock(frames):
        return [(k, size, md5, path, mime, content)
                for k, size, _mtime, md5, path, _fid, mime, content in frames]

    assert no_clock(parsed[1][1]) == no_clock(parsed[1][0])
    assert [fr[0] for fr in parsed[1][1]] == [1, 0]  # inline, then chunk
    # the JAX journal's frames through both packages' _fl_apply: equal
    # entries but for crtime, the Python clock when the entry was made
    applied = []
    for cls, filer_cls, store_cls in ((RefFilerServer, RefFiler, RefMemoryStore),
                                      (FilerServer, Filer, MemoryStore)):
        stub = types.SimpleNamespace(filer=filer_cls(store_cls()), fastlane=None,
                                     _reclaim_chunks=lambda chunks: None,
                                     _fl_applying=threading.local())
        for fr in parsed[0][0]:
            cls._fl_apply(stub, *fr)
        applied.append([stub.filer.find_entry(p).to_dict()
                        for p in ("/crash", "/crash/keep.txt", "/crash/keep.bin")])
        for d in applied[-1]:
            d["attributes"].pop("crtime")
    assert applied[1] == applied[0]
    # the restarted filers replay their journals
    fs = []
    for side in twin:
        store = os.path.join(side.root, "filer_store")
        fs.append(side.filer(store_kind="lsm", store_path=store))
    for f in fs:
        e = f.filer.find_entry("/crash/keep.txt")
        assert e is not None and e.content == b"survives"
    st, _, body = both(fs, "GET", "/crash/keep.bin")
    assert st == 200 and body == payload
    same_entries(fs, "/crash")


def test_secured_cluster_stays_native(twin):
    """jwt.signing + jwt.signing.read configured: the filer signs its own
    upload/read tokens and the whole filer data path stays on the engines
    (the volume's engine checks the JWTs)."""
    fs = []
    for side in twin:
        side.v.stop()
        sec_cls = RefSecurityConfig if side.ref else SecurityConfig
        sec = sec_cls(write_key="w-secret", read_key="r-secret")
        side.v = side.volume("v2", sec)
        f = side.filer(security=sec)
        assert f._fl_filer_on
        warm_vids(side, f)
        fs.append(f)
    (payload,) = seeded(5, 30000)
    assert both(fs, "POST", "/sec/x.bin", payload)[0] == 201
    st, _, body = both(fs, "GET", "/sec/x.bin")
    assert st == 200 and body == payload
    for side, f in zip(twin, fs):
        stats = f.fastlane.stats()
        assert stats["native_writes"] >= 1 and stats["native_reads"] >= 1
        vstats = side.v.fastlane.stats()
        assert vstats["native_writes"] >= 1 and vstats["native_reads"] >= 1
    same_entries(fs)


# --- TestNativeDeleteAndFrontDoor -----------------------------------------------
def test_native_delete_read_your_deletes(twin):
    """A DELETE of a cached entry acks natively (journal + cache
    tombstone) and an immediate GET 404s before the drain lands; the store
    catches up behind it. The writes are drained first: in the JAX filer a
    write's drain landing after the delete's tombstone puts the entry back
    in the engine's cache (test_create_drained_after_its_delete)."""
    fs = filers(twin)
    (chunk,) = seeded(6, 20000)
    assert both(fs, "POST", "/d/i.txt", b"inline")[0] == 201
    assert both(fs, "POST", "/d/c.bin", chunk)[0] == 201
    for f in fs:
        f._fl_filer_drain()
    before = front(fs)["delete"]["native"]
    # the reads after each delete are answered by the engine's tombstone
    # or, once the drain has applied the delete, by the Python path, so
    # only the writes' and the deletes' counts must be equal

    for path in ("/d/i.txt", "/d/c.bin"):
        assert both(fs, "DELETE", path)[0] == 204
        # the engine's tombstone or, once the drain has applied the delete,
        # the Python path answers: the status is what must not vary
        got = [http_request("GET", f.url + path)[0] for f in fs]
        assert got == [404, 404], f"read-your-deletes violated for {path}"
    fm = [f.fastlane.front_metrics() for f in fs]
    assert [(m["write"], m["delete"]) for m in fm] == [(fm[0]["write"], fm[0]["delete"])] * 2
    assert fm[1]["delete"]["native"] == before + 2, "deletes left the native path"
    for f in fs:
        wait(lambda f=f: f.filer.find_entry("/d/i.txt") is None
             and f.filer.find_entry("/d/c.bin") is None, 5, "the drained deletes")
    # write-after-delete reuses the path cleanly
    assert both(fs, "POST", "/d/i.txt", b"again")[0] == 201
    st, _, body = both(fs, "GET", "/d/i.txt")
    assert st == 200 and body == b"again"
    same_entries(fs)


def test_create_drained_after_its_delete(twin):
    """A native write, then its native DELETE before the drain has applied
    the write: when the drain stores the entry after the delete's tombstone,
    the port's engine keeps the tombstone (the port leaves an entry the
    engine journaled as the engine cached it) and a GET in that window
    404s. The JAX filer's meta-log push puts the entry back in the cache,
    so the same GET answers 200 until the delete's frame drains. Each
    filer's drain is held at the write's frame while the test deletes, and
    again after the write is stored while it reads."""
    fs = filers(twin)
    got = []
    for f in fs:
        at_write, deleted, stored, read = (threading.Event() for _ in range(4))
        apply = f._fl_apply

        def held(kind, size, mtime, md5, path, *rest, apply=apply, ev=(
                at_write, deleted, stored, read)):
            if path == "/rd/a.txt" and kind == 1:
                ev[0].set()
                assert ev[1].wait(10)
                apply(kind, size, mtime, md5, path, *rest)
                ev[2].set()
                assert ev[3].wait(10)
                return
            apply(kind, size, mtime, md5, path, *rest)

        f._fl_apply = held
        try:
            assert answer("POST", f.url + "/rd/a.txt", b"short-lived")[0] == 201
            assert at_write.wait(10)
            assert answer("DELETE", f.url + "/rd/a.txt")[0] == 204
            deleted.set()
            assert stored.wait(10)
            got.append(http_request("GET", f.url + "/rd/a.txt")[0])
            read.set()
        finally:
            deleted.set()
            read.set()
        wait(lambda f=f: f.filer.find_entry("/rd/a.txt") is None, 5, "the drained delete")
        del f._fl_apply
    assert got == [200, 404]
    fm = [f.fastlane.front_metrics() for f in fs]
    assert [m["delete"]["native"] for m in fm] == [1, 1]


def _fastlane_lines(text: str) -> list[str]:
    """The filer front's exposition lines, the server label aside."""
    return sorted(re.sub(r'server="[^"]*",?', "", line) for line in text.splitlines()
                  if "SeaweedFS_filer_fastlane_" in line)


def test_front_metrics_exported_and_typed(twin):
    """The front-door counters reach each process registry as
    SeaweedFS_filer_fastlane_{native,fallback}_total with typed reasons."""
    fs = filers(twin)
    assert both(fs, "POST", "/fm/x.txt", b"hello")[0] == 201
    assert both(fs, "GET", "/fm/x.txt")[0] == 200
    # a query read is an EXPECTED fallback with reason=query
    both_meta(fs, "/fm/x.txt")
    fm = front(fs)
    assert fm["write"]["native"] >= 1 and fm["read"]["native"] >= 1
    assert fm["read"]["fallback"]["query"] >= 1
    texts = [side.registry().render() for side in twin]
    lines = [_fastlane_lines(t) for t in texts]
    assert lines[1] == lines[0]
    assert any("SeaweedFS_filer_fastlane_native_total" in x for x in lines[1])
    assert any('reason="query"' in x for x in lines[1])
    # the port's lines hold this filer's counts under its own server label
    server = f"{fs[1].service.host}:{fs[1].fastlane.port}"
    assert f'SeaweedFS_filer_fastlane_fallback_total{{server="{server}",op="read",' \
           f'reason="query"}} {fm["read"]["fallback"]["query"]}' in texts[1]


def _freeze_refresh(f) -> None:
    # hold the background refresh loop off so the pool arithmetic below
    # cannot race a concurrent top-up
    f._fl_lease_backoff_until = time.monotonic() + 300
    time.sleep(0.1)  # let an in-flight refresh finish


def test_lease_pool_upserts_by_volume(twin):
    """The engine holds one lease PER VOLUME: installs upsert by vid,
    remaining sums the pool, lease_count reports live entries (-1 only for
    a stopped engine), and a hostname is refused with a typed error."""
    fs = filers(twin)
    got = []
    for side, f in zip(twin, fs):
        _freeze_refresh(f)
        lib, h = f.fastlane._lib, f.fastlane.handle
        out = [lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 901, 7, 0, 100, b"", b""),
               lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 902, 7, 0, 50, b"", b"")]
        base = int(lib.sw_fl_filer_lease_remaining(h))
        n = f.fastlane.lease_count()
        assert base >= 150 and n >= 2
        # re-leasing vid 901 REPLACES its range, not a second entry
        out.append(lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 901, 7, 1000, 1200,
                                             b"", b""))
        out += [f.fastlane.lease_count() - n, int(lib.sw_fl_filer_lease_remaining(h)) - base]
        rc = int(lib.sw_fl_filer_lease_set(h, b"not-an-ip.example", 1, 903, 7, 0, 10,
                                           b"", b""))
        out += [rc, side.fl_mod.error_str(lib, rc)]
        f.stop()
        side.filers.remove(f)
        out.append(int(lib.sw_fl_filer_lease_count(h)))  # stopped: -1
        got.append(out)
    assert got[1] == got[0]
    assert got[1][2:] == [0, 0, 100, -2, got[1][6], -1] and "IPv4" in got[1][6]


def test_lease_duplicate_grant_keeps_healthy_range(twin):
    """A grant of a vid the pool already holds with a healthy (>= 5000
    unspent keys) range KEEPS it (rc=1); a nearly-spent range is still
    replaced (rc=0, the low-watermark renewal)."""
    fs = filers(twin)
    got = []
    for f in fs:
        _freeze_refresh(f)
        lib, h = f.fastlane._lib, f.fastlane.handle
        out = [lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 911, 7, 0, 20000, b"", b"")]
        base = int(lib.sw_fl_filer_lease_remaining(h))
        out.append(lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 911, 9, 50000, 56000,
                                             b"", b""))
        out.append(int(lib.sw_fl_filer_lease_remaining(h)) - base)
        out.append(lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 912, 7, 0, 1000, b"", b""))
        base = int(lib.sw_fl_filer_lease_remaining(h))
        out.append(lib.sw_fl_filer_lease_set(h, b"127.0.0.1", 1, 912, 7, 30000, 50000,
                                             b"", b""))
        out.append(int(lib.sw_fl_filer_lease_remaining(h)) - base)
        got.append(out)
    assert got[1] == got[0] == [0, 1, 0, 0, 0, 19000]


def _read_response(s, buf: bytes):
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        assert chunk, "connection closed mid-response"
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    n = int(re.search(rb"content-length:\s*(\d+)", head, re.I).group(1))
    while len(rest) < n:
        chunk = s.recv(65536)
        assert chunk, "connection closed mid-body"
        rest += chunk
    return head, rest[:n], rest[n:]


def test_pipelined_request_after_zero_copy_relay(twin):
    """Two GETs pipelined on one connection, the first relayed from the
    volume on the zero-copy lane: the second, already buffered, is
    answered too (not left for the idle sweep)."""
    fs = filers(twin)
    (payload,) = seeded(7, 100 * 1024)  # > the promotion cap: every GET relays
    assert both(fs, "POST", "/pl/a.bin", payload)[0] == 201
    got = []
    for f in fs:
        u = urllib.parse.urlparse(f.url)
        req = f"GET /pl/a.bin HTTP/1.1\r\nHost: {u.hostname}\r\n\r\n".encode()
        with socket.create_connection((u.hostname, u.port), timeout=15) as s:
            s.sendall(req + req)  # both requests in one packet
            head1, body1, buf = _read_response(s, b"")
            head2, body2, _ = _read_response(s, buf)
        got.append([head1.split(b"\r\n", 1)[0], body1 == payload,
                    head2.split(b"\r\n", 1)[0], body2 == payload])
    assert got[1] == got[0]
    assert b" 200 " in got[1][0] and got[1][1] and b" 200 " in got[1][2] and got[1][3]


def test_filer_relayed_write_joins_caller_trace(twin):
    """The span the volume's drain synthesizes for a filer-relayed chunk
    PUT carries the caller's X-Sw-Trace-Id: cluster.trace shows one chain."""
    fs = filers(twin)
    tid = "ab54feedcafe0042"
    (chunk,) = seeded(8, 20000)
    assert both(fs, "POST", "/tr/chunk.bin", chunk, {"X-Sw-Trace-Id": tid})[0] == 201
    for side in twin:
        def joined(side=side) -> bool:
            side.v.fastlane.drain()
            return any(t["trace_id"] == tid and any(s["name"] == "fastlane.append"
                                                    for s in t["spans"])
                       for t in side.trace.collector().traces(limit=200))

        wait(joined, 5, f"{side.pkg}: fastlane.append joining the caller's trace")


def _trace_block(out: str, tid: str) -> list[str]:
    """One trace's lines of `cluster.trace`, durations aside."""
    lines = out.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith(f"trace {tid} "))
    block = [lines[at]]
    for ln in lines[at + 1:]:
        if not ln.startswith("  "):
            break
        block.append(ln)
    return [re.sub(r"[0-9.]+ms", "ms", ln) for ln in block]


def test_native_write_trace_in_cluster_trace(twin):
    """A filer write the engine serves natively (one leased chunk, no
    Python handler) still shows in `cluster.trace` under the caller's
    trace id, with the volume's `fastlane.append` span: the same tree
    from both packages' shells, durations aside."""
    fs = filers(twin)
    tid = "cd54feedcafe0043"
    (chunk,) = seeded(18, 20000)
    assert both(fs, "POST", "/trn/chunk.bin", chunk, {"X-Sw-Trace-Id": tid})[0] == 201
    assert [f.fastlane.front_metrics()["write"]["native"] for f in fs] == [1, 1]
    blocks = []
    for side, f in zip(twin, fs):
        env = (RefCommandEnv if side.ref else CommandEnv)(side.m.url)
        run = ref_run_command if side.ref else run_command

        def shown(side=side, env=env, run=run) -> bool:
            side.v.fastlane.drain()
            return f"trace {tid} " in run(env, "cluster.trace -limit 50")

        wait(shown, 5, f"{side.pkg}: the native write's trace in cluster.trace")
        blocks.append(_trace_block(run(env, "cluster.trace -limit 50"), tid))
    assert blocks[1] == blocks[0]
    assert "roles=volume" in blocks[1][0]
    assert any(ln.strip().startswith("[volume] fastlane.append ") for ln in blocks[1][1:])


def test_lease_survives_volume_deletion(twin):
    """A leased volume deleted before anything was written to it: the
    failed native upload falls back to Python (the client still gets a
    201), drops the lease, and the loop re-leases against the live
    topology so native writes resume. Every lease the loops take is
    journaled as a `lease_churn` event."""
    for side in twin:
        side.events.recorder().enable()
    fs = filers(twin)
    for f in fs:
        lib, h = f.fastlane._lib, f.fastlane.handle
        wait(lambda lib=lib, h=h: int(lib.sw_fl_filer_lease_remaining(h)) > 0, 5,
             "the first lease")
    for side in twin:  # every volume of the server: all empty
        for vid in list(side.v.store.volume_ids()):
            post_json(f"{side.v.url}/admin/delete_volume", {"volume": vid})
    (payload,) = seeded(9, 30000)
    assert both(fs, "POST", "/dead/a.bin", payload)[0] == 201
    st, _, body = both(fs, "GET", "/dead/a.bin")
    assert st == 200 and body == payload
    rng = np.random.default_rng(10)
    for f in fs:
        # each write to a lease on a deleted volume is an acked fallback
        # that prunes that lease; native writes resume on a fresh one
        lib, h = f.fastlane._lib, f.fastlane.handle
        deadline = time.time() + 15
        resumed, i = False, 0
        while time.time() < deadline and not resumed:
            if int(lib.sw_fl_filer_lease_remaining(h)) == 0:
                time.sleep(0.1)
                continue
            before = f.fastlane.stats()["native_writes"]
            st, _, _ = http_request("POST", f.url + f"/dead/b{i}.bin", rng.bytes(30000))
            i += 1
            assert st == 201
            resumed = f.fastlane.stats()["native_writes"] > before
        assert resumed, "native writes never resumed after re-lease"
    st, _, body = both(fs, "GET", "/dead/a.bin")
    assert st == 200 and body == payload
    # every lease the loops took is journaled on each side: leased, or kept
    # where the master granted a volume the pool already holds (how many of
    # each follows the masters' random picks)
    for side in twin:
        churn = side.events.recorder().events(type="lease_churn", limit=0)
        mine = [e for e in churn if e.get("node") == f"127.0.0.1:{side.v.fastlane.port}"]
        assert all(e["attrs"]["count"] == 20000 and e["attrs"]["rc"] in (0, 1)
                   for e in mine)
        assert "leased" in {e["attrs"]["action"] for e in mine}


def test_fs_configure_rules(twin):
    """fs.configure: per-prefix storage rules — TTL defaults on writes,
    read-only prefixes refusing writes and deletes, hot-reloaded from
    /etc/seaweedfs/filer.conf — and the engine defers rule-covered writes
    to Python while unruled paths stay native."""
    fs = filers(twin)
    envs = [RefCommandEnv(twin[0].m.url, filer_url=fs[0].url),
            CommandEnv(twin[1].m.url, filer_url=fs[1].url)]
    runs = (ref_run_command, run_command)

    def shell(line: str) -> str:
        outs = [run(env, line) for run, env in zip(runs, envs)]
        assert outs[1] == outs[0], line
        return outs[1]

    assert "locations" in shell("fs.configure")
    assert "not saved" in shell("fs.configure -locationPrefix /frozen -readOnly")
    assert all(f.filer_conf.match("/frozen/x") is None for f in fs)
    assert "(saved)" in shell("fs.configure -locationPrefix /frozen -readOnly -apply")
    assert all((f.filer_conf.match("/frozen/x") or {}).get("read_only") for f in fs)
    a, b = seeded(11, 9000, 9000)
    st, _, body = both(fs, "POST", "/frozen/a.bin", a)
    assert st == 403 and b"read-only" in body
    assert both(fs, "DELETE", "/frozen/a.bin")[0] == 403
    shell("fs.configure -locationPrefix /tmpdata -ttl 5m -apply")
    assert both(fs, "POST", "/tmpdata/t.bin", b)[0] == 201
    for f in fs:
        f._fl_filer_drain()
        assert f.filer.find_entry("/tmpdata/t.bin").attributes.ttl_sec == 300
    before = [f.fastlane.stats()["native_writes"] for f in fs]
    assert both(fs, "POST", "/plain/p.bin", a)[0] == 201
    assert all(f.fastlane.stats()["native_writes"] > n for f, n in zip(fs, before))
    shell("fs.configure -locationPrefix /frozen -delete -apply")
    assert both(fs, "POST", "/frozen/b.bin", b"x" * 3000)[0] == 201
    same_entries(fs, "/plain")
    same_entries(fs, "/tmpdata")
    fm = [f.fastlane.front_metrics()["write"] for f in fs]
    assert fm[1] == fm[0]


def test_system_tree_prefix_pinned_in_engine():
    """The port's fastlane.cpp mirrors its filer_notify.SYSTEM_TREE_PREFIX
    as a literal (C cannot import it), equal to the JAX package's:
    renaming the tree must update both or the never-invalidated-cache
    guard stops matching."""
    from seaweedfs_tpu.filer.filer_notify import SYSTEM_TREE_PREFIX as REF_PREFIX

    assert SYSTEM_TREE_PREFIX == REF_PREFIX
    src = open(os.path.join(os.path.dirname(__file__), "..", "seaweedfs_tpu_torch",
                            "csrc", "fastlane.cpp")).read()
    needle = f'path.compare(0, {len(SYSTEM_TREE_PREFIX)}, "{SYSTEM_TREE_PREFIX}") == 0'
    assert needle in src, needle


# --- the port's own --------------------------------------------------------------
def test_refused_filer_mode_raises(twin):
    """The engine refuses filer mode when its journal cannot be created (a
    dangling link into a missing directory stands at its path): the port's
    filer raises with the engine's typed error and leaves nothing
    listening, where the JAX filer carries on quietly on the Python path."""
    ref, port = twin
    for side in twin:
        store = os.path.join(side.root, "filer_store")
        os.makedirs(store)
    for d in (tempfile.gettempdir(), os.path.join(port.root, "filer_store")):
        os.symlink(os.path.join(d, "missing", "journal"),
                   os.path.join(d, "filer_native.journal"))
    f = ref.filer(store_kind="lsm", store_path=os.path.join(ref.root, "filer_store"))
    assert f.fastlane is not None and not f._fl_filer_on
    p = FilerServer(port.m.url, port=0, device="cpu", store_kind="lsm",
                    store_path=os.path.join(port.root, "filer_store"))
    try:
        with pytest.raises(RuntimeError, match="filer mode refused") as exc:
            p.start()
        assert fl_mod.error_str(fl_mod._get_lib(), -2) in str(exc.value)
        assert p.fastlane is None and not p._fl_filer_on
        backend = p.service.port
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", backend), timeout=1).close()
    finally:
        p.stop()


def test_drained_chunk_entries_stay_cached(twin):
    """Chunk-backed files the engine wrote are read natively after the
    drain has stored their entries. The JAX filer's meta-log push evicts
    each from the engine's cache when its volume is not in the client's
    vid cache, so every first read there is a `cache_miss` fallback to
    Python; the port leaves an entry the engine journaled as the engine
    cached it. Statuses, bodies, ETags, entries and writes stay equal (the
    engine's relay adds the volume's Content-Type and
    Content-Disposition, which the Python path does not)."""
    fs = filers(twin, warm=False)
    blobs = seeded(12, *([4096] * 32))
    for i, b in enumerate(blobs):
        assert both(fs, "POST", f"/cold/{i}.bin", b)[0] == 201
    same_entries(fs, "/cold")  # every frame drained
    for i in np.random.default_rng(13).permutation(len(blobs)):
        got = [http_request("GET", f"{f.url}/cold/{i}.bin") for f in fs]
        assert [(st, h["ETag"], body) for st, h, body in got] == \
            [(200, got[0][1]["ETag"], blobs[i])] * 2
    fm = [f.fastlane.front_metrics() for f in fs]
    assert fm[1]["write"] == fm[0]["write"] and fm[1]["write"]["native"] == 32
    assert fm[1]["read"]["native"] == 32 and not any(fm[1]["read"]["fallback"].values())
    assert fm[0]["read"]["fallback"]["cache_miss"] == 32 - fm[0]["read"]["native"]


def test_two_filers_get_distinct_ordinals(twin):
    """Two filers registered with one master take the two gateway
    ordinals from its answer, and shard their fid leases by them — in
    both packages alike."""
    got = []
    for side in twin:
        f1 = side.filer()
        f2 = side.filer(peers=[f1.url])
        f1._register_once()  # f1's ordinal, now that f2 is up
        got.append(sorted((f._gateway_ordinal, f._gateway_count) for f in (f1, f2)))
    assert got[1] == got[0] == [(0, 2), (1, 2)]


@pytest.fixture
def port_side(tmp_path, monkeypatch):
    """The port's master and volume server alone, for what only the port
    does (the JAX filer journals in one temp-directory file a host)."""
    own_tmp = tmp_path / "tmpdir"
    own_tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(own_tmp))
    side = Side("port", str(tmp_path))
    try:
        yield side
    finally:
        side.stop()


def test_sibling_stores_keep_their_own_journals(port_side):
    """Two filers whose leveldb stores are sibling directories each
    journal inside their own store. With writes acked on both and drained
    on neither, one restarts and replays only its own frames: the other's
    journal keeps every frame, and its files reach no store but its own."""
    root = port_side.root
    stalled, paths = [], {}
    for name in ("f1", "f2"):
        store = os.path.join(root, name)
        f = port_side.filer(store_kind="leveldb", store_path=store)
        assert f._fl_journal_path == os.path.join(store, "filer_native.journal")
        f._fl_filer_drain = lambda *a, **k: 0  # a Python stall: nothing drains
        paths[name] = [f"/{name}/{i}.txt" for i in range(8)]
        for p in paths[name]:
            assert answer("POST", f.url + p, p.encode())[0] == 201
        stalled.append(f)
    journals = {}
    for name, f in zip(("f1", "f2"), stalled):
        with open(f._fl_journal_path, "rb") as fh:
            journals[name] = fh.read()
        assert [fr[4] for fr in _frames(FilerServer, journals[name])] == paths[name]
        f.stop()  # crash: the frames are never applied
        port_side.filers.remove(f)
    f1 = port_side.filer(store_kind="leveldb", store_path=os.path.join(root, "f1"))
    for p in paths["f1"]:
        e = f1.filer.find_entry(p)
        assert e is not None and e.content == p.encode()
    for p in paths["f2"]:
        assert f1.filer.find_entry(p) is None
    f1._fl_filer_drain()
    with open(os.path.join(root, "f2", "filer_native.journal"), "rb") as fh:
        assert fh.read() == journals["f2"]  # f1's replay and reset left it whole
    f2 = port_side.filer(store_kind="leveldb", store_path=os.path.join(root, "f2"))
    for p in paths["f2"]:
        assert f2.filer.find_entry(p).content == p.encode()
    assert f2.filer.find_entry(paths["f1"][0]) is None


def test_second_engine_on_a_journal_is_refused(port_side):
    """A second filer on a store whose journal a live engine holds raises
    and leaves nothing listening; the first serves on, and its acked
    frames stay in its journal until its own drain applies them."""
    store = os.path.join(port_side.root, "shared")
    f1 = port_side.filer(store_kind="lsm", store_path=store)
    f1._fl_filer_drain = lambda *a, **k: 0
    assert answer("POST", f1.url + "/held/a.txt", b"held")[0] == 201
    f2 = FilerServer(port_side.m.url, port=0, device="cpu", store_kind="lsm",
                     store_path=store)
    try:
        with pytest.raises(RuntimeError, match="another filer's engine"):
            f2.start()
        assert f2.fastlane is None and not f2._fl_filer_on
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", f2.service.port), timeout=1).close()
    finally:
        f2.stop()
    with open(f1._fl_journal_path, "rb") as fh:
        assert [fr[4] for fr in _frames(FilerServer, fh.read())] == ["/held/a.txt"]
    del f1._fl_filer_drain  # the class's drain again
    assert answer("GET", f1.url + "/held/a.txt")[2] == b"held"


@pytest.mark.parametrize("kind", ["leveldb", "sqlite", "memory", "no_path"])
def test_journal_location_by_store(tmp_path, monkeypatch, kind):
    """Each store kind's journal: inside a directory store, beside a file
    store, none for memory, and for a store with no local path one in the
    temp directory named after the front door's host:port."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    d = tmp_path / "store"
    d.mkdir()
    stores = {
        "leveldb": types.SimpleNamespace(path=str(d)),
        "sqlite": types.SimpleNamespace(path=str(tmp_path / "a.db")),
        "memory": MemoryStore(),
        "no_path": types.SimpleNamespace(),
    }
    stub = types.SimpleNamespace(
        filer=types.SimpleNamespace(store=stores[kind]),
        service=types.SimpleNamespace(host="127.0.0.1"),
        fastlane=types.SimpleNamespace(port=18888))
    want = {
        "leveldb": str(d / "filer_native.journal"),
        "sqlite": str(tmp_path / "a.db") + ".fljournal",
        "memory": "",
        "no_path": str(tmp_path / "filer_native-127.0.0.1_18888.journal"),
    }
    assert FilerServer._fl_journal_location(stub) == want[kind]
