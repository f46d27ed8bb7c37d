"""The port's native fastlane engine (`csrc/fastlane.cpp` through
`storage/fastlane.py`) in front of its volume server and master, held
against the JAX package's engine in front of the JAX servers.

Each twin test starts a JAX master and volume server and a port master and
volume server (`device="cpu"`), both with their engines on, drives the same
seeded requests at both and compares status, body and the headers that do
not carry a clock (tolerance 0). The engines stamp needles from the C
clock, which no Python patch reaches, so `.dat` records are compared with
their two stamps (`last_modified`, `append_at_ns`) set aside and every
other byte equal; `.idx` files hold no stamp and are compared whole. These
are the port's counterparts of the volume and master cases of
`tests/test_fastlane.py`, of the engine cases of `tests/test_ec_online.py`
and `tests/test_security.py`, and of the heat rollup fed by native
counters.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ops.rs_kernel import RSCodec as RefCodec
from seaweedfs_tpu.security import SecurityConfig as RefSecurityConfig
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.security import SecurityConfig
from seaweedfs_tpu_torch.security.jwt import gen_read_jwt, gen_write_jwt
from seaweedfs_tpu_torch.server.httpd import get_json, http_request, post_json
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.stats import parse_exposition, trace
from seaweedfs_tpu_torch.storage import fastlane as fl_mod
from seaweedfs_tpu_torch.storage import file_id, idx
from seaweedfs_tpu_torch.storage.erasure_coding import geometry
from seaweedfs_tpu_torch.storage.needle import Needle
from tests._threads import stop_history_loops  # noqa: F401

COOKIE = 0x5EED
BLOCK = 4096  # online-EC rows of 40 KiB keep the cases quick
# headers that carry a clock, a random trace id or a connection detail,
# not the answer
VARYING = {"date", "last-modified", "server", "connection", "keep-alive", "x-sw-trace-id"}


class Pair:
    """One package's master and volume server, both behind their engines."""

    def __init__(self, pkg: str, root: str, master_kw=None, vs_kw=None) -> None:
        master_cls = RefMasterServer if pkg == "ref" else MasterServer
        vs_cls = RefVolumeServer if pkg == "ref" else VolumeServer
        dev = {} if pkg == "ref" else {"device": "cpu"}
        self.pkg = pkg
        self.dir = os.path.join(root, pkg)
        self.master = master_cls(port=0, pulse_seconds=1, **(master_kw or {}))
        self.master.start()
        self.vs = vs_cls([self.dir], self.master.url, port=0, pulse_seconds=1,
                         max_volume_count=20, **dev, **(vs_kw or {}))
        self.vs.start()

    def url(self, vid: int, nid: int, cookie: int = COOKIE) -> str:
        return f"{self.vs.url}/{vid},{file_id.format_needle_id_cookie(nid, cookie)}"

    def allocate(self, vid: int, **kw) -> None:
        post_json(self.vs.url + "/admin/allocate_volume", {"volume": vid, **kw})

    def stop(self) -> None:
        self.vs.stop()
        self.master.stop()


@contextlib.contextmanager
def pairs(root, master_kw=None, vs_kw=None, ref_vs_kw=None):
    """(JAX pair, port pair), each with its engine in front."""
    ref = Pair("ref", str(root), master_kw, ref_vs_kw if ref_vs_kw is not None else vs_kw)
    try:
        port = Pair("port", str(root), master_kw, vs_kw)
        try:
            assert ref.vs.fastlane is not None and port.vs.fastlane is not None
            assert ref.master.fastlane is not None and port.master.fastlane is not None
            yield ref, port
        finally:
            port.stop()
    finally:
        ref.stop()


@pytest.fixture
def twin(tmp_path):
    with pairs(tmp_path) as t:
        yield t


def answer(method: str, url: str, body: bytes | None = None, headers=None):
    """(status, headers but VARYING, body) of one request."""
    st, hdrs, data = http_request(method, url, body, headers or {})
    return st, {k.lower(): v for k, v in hdrs.items() if k.lower() not in VARYING}, data


def both(twin, method: str, vid: int, nid: int, body=None, headers=None, cookie=COOKIE):
    """The same request to the JAX and the port volume server; the
    answers must be equal."""
    got = [answer(method, p.url(vid, nid, cookie), body, headers) for p in twin]
    assert got[1] == got[0], (method, vid, nid)
    return got[1]


def seeded(seed: int, n: int, lo: int = 50, hi: int = 5000) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(lo, hi))) for _ in range(n)]


def records(path_dat: str, path_idx: str) -> list[tuple]:
    """Every record the .idx names, parsed, with its two stamps set aside."""
    with open(path_idx, "rb") as f:
        entries = list(idx.walk_index_blob(f.read()))
    out = []
    with open(path_dat, "rb") as f:
        dat = f.read()
    for key, offset, size in entries:
        if size <= 0 or size == 0xFFFFFFFF:
            out.append((key, offset, size))
            continue
        n = Needle.from_bytes(dat[offset:offset + 16 + size + 4 + 8 + 8], size, 3)
        out.append((key, offset, size, n.cookie, n.id, bytes(n.data), n.flags,
                    bytes(n.name or b""), bytes(n.mime or b""), n.checksum))
    return out


def assert_same_files(twin, vid: int) -> None:
    for p in twin:
        p.vs.fastlane.drain()
    paths = [p.vs.store.get_volume(vid).base_name for p in twin]
    idx_bytes = [open(p + ".idx", "rb").read() for p in paths]
    assert idx_bytes[1] == idx_bytes[0]
    assert os.path.getsize(paths[1] + ".dat") == os.path.getsize(paths[0] + ".dat")
    assert records(paths[1] + ".dat", paths[1] + ".idx") == \
        records(paths[0] + ".dat", paths[0] + ".idx")


# --- the engine in front of the volume server -------------------------------------
def test_engine_fronts_the_data_plane(twin):
    for p in twin:
        p.allocate(7)
    st, _, body = both(twin, "POST", 7, 1, b"x" * 100)
    assert st == 201 and json.loads(body)["size"] == 100
    st, _, data = both(twin, "GET", 7, 1)
    assert st == 200 and data == b"x" * 100
    both(twin, "HEAD", 7, 1)
    both(twin, "GET", 7, 2)  # a miss answers alike
    both(twin, "GET", 7, 1, cookie=COOKIE + 1)  # a wrong cookie too
    for p in twin:
        stats = p.vs.fastlane.stats()
        assert stats["native_writes"] >= 1 and stats["native_reads"] >= 1
    assert twin[1].vs.url.endswith(f":{twin[1].vs.fastlane.port}")
    assert twin[1].vs.node_id.endswith(f":{twin[1].vs.fastlane.port}")


def test_seeded_history_leaves_equal_files(twin):
    """Native writes, native deletes, Python-path overwrites and a
    multipart upload, in one seeded order: equal answers, an equal .idx and
    equal records."""
    for p in twin:
        p.allocate(3)
    blobs = seeded(1, 48)
    rng = np.random.default_rng(2)
    for nid, data in enumerate(blobs, 1):
        both(twin, "POST", 3, nid, data)
    for nid in sorted(rng.choice(np.arange(1, 49), 12, replace=False).tolist()):
        both(twin, "DELETE", 3, nid)
    for nid in (5, 9, 20):  # an overwrite proxies to the Python path
        both(twin, "POST", 3, nid, b"v2-" + blobs[nid - 1][:300])
    for nid in range(1, 49):
        both(twin, "GET", 3, nid)
    assert_same_files(twin, 3)


def test_native_then_python_overwrite_consistent(twin):
    """An overwrite of an engine-written needle proxies to Python — both
    must agree on the live value, and the engine map must follow Python's
    append."""
    for p in twin:
        p.allocate(4)
    assert both(twin, "POST", 4, 1, b"version-one")[0] == 201  # native
    assert both(twin, "POST", 4, 1, b"version-two!")[0] == 201  # proxied
    st, _, data = both(twin, "GET", 4, 1)  # native read, engine map
    assert st == 200 and data == b"version-two!"
    for p in twin:
        v = p.vs.store.get_volume(4)
        p.vs.fastlane.drain()
        assert v.read_needle(v.nm.metrics.maximum_key).data == b"version-two!"
    assert_same_files(twin, 4)


def test_vacuum_under_writes_preserves_data(twin):
    """Vacuum swaps .dat/.idx files; the engine hands the volume back to
    Python across the swap. Data written before and after survives, and
    deleted needles stay gone."""
    for p in twin:
        p.allocate(5)
    blobs = seeded(3, 12, 200, 800)
    for nid, data in enumerate(blobs, 1):
        both(twin, "POST", 5, nid, data)
    for nid in range(2, 13, 2):
        both(twin, "DELETE", 5, nid)
    for p in twin:
        assert post_json(f"{p.vs.url}/admin/vacuum", {"volume": 5})["ok"]
    assert both(twin, "POST", 5, 100, b"post-vacuum")[0] == 201
    assert both(twin, "GET", 5, 100)[2] == b"post-vacuum"
    for nid, data in enumerate(blobs, 1):
        st, _, got = both(twin, "GET", 5, nid)
        assert (st, got) == ((404, b"") if nid % 2 == 0 else (200, data))
    assert_same_files(twin, 5)


def test_restart_replays_engine_written_idx(tmp_path):
    """Needles appended by the engine survive a full server restart through
    the .idx entries the engine wrote."""
    m = MasterServer(port=0, pulse_seconds=1)
    m.start()
    d = str(tmp_path / "v")
    vs = VolumeServer([d], m.url, port=0, pulse_seconds=1, device="cpu")
    vs.start()
    try:
        a = get_json(f"{m.url}/dir/assign")
        assert http_request("POST", f"{vs.url}/{a['fid']}", b"durable-bytes")[0] == 201
        assert vs.fastlane.stats()["native_writes"] == 1
        vs.stop()
        vs = VolumeServer([d], m.url, port=0, pulse_seconds=1, device="cpu")
        vs.start()
        st, _, data = http_request("GET", f"{vs.url}/{a['fid']}")
        assert st == 200 and data == b"durable-bytes"
        assert vs.fastlane.stats()["native_reads"] == 1
    finally:
        vs.stop()
        m.stop()


def test_concurrent_mixed_operations(tmp_path):
    """Many threads write, read, delete and send proxied admin calls at
    once; every surviving value reads back."""
    m = MasterServer(port=0, pulse_seconds=1)
    m.start()
    vs = VolumeServer([str(tmp_path / "v")], m.url, port=0, pulse_seconds=1,
                      max_volume_count=20, device="cpu")
    vs.start()
    n_threads, per = 8, 30
    results: list[tuple[str, bytes]] = []
    errors: list[str] = []
    lock = threading.Lock()

    def worker(t: int) -> None:
        try:
            for i in range(per):
                a = get_json(f"{m.url}/dir/assign")
                u = f"http://{a['publicUrl']}/{a['fid']}"
                payload = f"t{t}-i{i}-".encode() * 20
                st, _, body = http_request("POST", u, payload)
                if st != 201:
                    raise AssertionError(f"write {st}: {body[:80]!r}")
                if i % 5 == 4:
                    if http_request("DELETE", u)[0] != 202:
                        raise AssertionError("delete")
                    continue
                if i % 7 == 0:  # interleave proxied admin traffic
                    http_request("GET", f"http://{a['publicUrl']}/status")
                with lock:
                    results.append((u, payload))
        except Exception as e:  # the first failure of each thread
            with lock:
                errors.append(f"t{t}: {e}")

    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors[:3]
        for u, payload in results:
            st, _, data = http_request("GET", u)
            assert st == 200 and data == payload, u
        assert vs.fastlane.stats()["native_writes"] == n_threads * per
    finally:
        vs.stop()
        m.stop()


def test_range_reads_native(twin):
    """Single-range GETs are served by the engine; unsatisfiable or
    malformed specs get the full body; both packages answer alike."""
    for p in twin:
        p.allocate(6)
    payload = bytes(range(256)) * 4
    both(twin, "POST", 6, 1, payload)
    before = [p.vs.fastlane.stats()["native_reads"] for p in twin]
    for spec, want_st, want in (("bytes=0-4", 206, payload[0:5]),
                                ("bytes=1000-", 206, payload[1000:]),
                                ("bytes=-24", 206, payload[-24:]),
                                ("bytes=500-9999", 206, payload[500:]),
                                ("bytes=9-2", 200, payload), ("bytes=5", 200, payload),
                                ("bytes=abc-def", 200, payload), ("bytes=-", 200, payload)):
        st, hdrs, body = both(twin, "GET", 6, 1, headers={"Range": spec})
        assert (st, body) == (want_st, want), spec
        assert ("content-range" in hdrs) == (want_st == 206), spec
    assert [p.vs.fastlane.stats()["native_reads"] - b for p, b in zip(twin, before)] == [8, 8]


def test_multipart_upload_native(twin):
    """curl -F style multipart uploads parse natively (file name and part
    content type stored); a body with no file part gets Python's answer."""
    for p in twin:
        p.allocate(8)
    boundary = "----testbound7"
    part = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="file"; filename="photo.png"\r\n'
        "Content-Type: image/png\r\n\r\n"
    ).encode() + b"\x89PNG-data-bytes" + f"\r\n--{boundary}--\r\n".encode()
    ctype = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    before = [p.vs.fastlane.stats()["native_writes"] for p in twin]
    st, _, body = both(twin, "POST", 8, 1, part, ctype)
    assert st == 201 and json.loads(body)["name"] == "photo.png"
    st, hdrs, data = both(twin, "GET", 8, 1)
    assert st == 200 and data == b"\x89PNG-data-bytes"
    assert hdrs["content-type"] == "image/png" and "photo.png" in hdrs["content-disposition"]
    nofile = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"field\"\r\n\r\n"
              f"value\r\n--{boundary}--\r\n").encode()
    both(twin, "POST", 8, 2, nofile, ctype)
    assert [p.vs.fastlane.stats()["native_writes"] - b for p, b in zip(twin, before)] == [1, 1]
    assert_same_files(twin, 8)


# --- security: JWTs checked by the engine -------------------------------------------
def test_jwt_verified_natively(tmp_path):
    """With a write key: a valid master-signed token keeps the native write
    path (the engine checks HS256 itself); missing, forged, cross-fid and
    expired tokens fall to Python's 401."""
    sec = SecurityConfig(write_key="sekrit")
    m = MasterServer(port=0, pulse_seconds=1, security=sec)
    m.start()
    vs = VolumeServer([str(tmp_path / "sv")], m.url, port=0, pulse_seconds=1,
                      security=sec, device="cpu")
    vs.start()
    try:
        assert m.fastlane is None  # assigns mint tokens: the Python handler
        a = get_json(f"{m.url}/dir/assign")
        u = f"http://{a['publicUrl']}/{a['fid']}"
        assert http_request("POST", u, b"no-token")[0] == 401
        before = vs.fastlane.stats()["native_writes"]
        headers = {"Authorization": f"BEARER {a['auth']}"}
        assert http_request("POST", u, b"with-token", headers)[0] == 201
        assert vs.fastlane.stats()["native_writes"] == before + 1
        bad = a["auth"][:-4] + ("AAAA" if a["auth"][-4:] != "AAAA" else "BBBB")
        for tok in (bad, gen_write_jwt("sekrit", "999,deadbeef01"),
                    gen_write_jwt("sekrit", a["fid"], expires_sec=-5)):
            assert http_request("POST", u, b"x", {"Authorization": f"BEARER {tok}"})[0] == 401
        assert http_request("DELETE", u, headers=headers)[0] == 202
        assert vs.fastlane.stats()["native_writes"] == before + 1
    finally:
        vs.stop()
        m.stop()


def test_read_jwt_checked_natively(tmp_path):
    """A read key: fid-bound and wildcard read tokens are served by the
    engine, a missing or wrong-key token gets the Python 401, and the JAX
    engine answers the same requests alike."""
    with pairs(tmp_path, vs_kw={"security": SecurityConfig(read_key="read-secret")},
               ref_vs_kw={"security": RefSecurityConfig(read_key="read-secret")}) as t:
        for p in t:
            p.allocate(2)
        assert both(t, "POST", 2, 1, b"readable")[0] == 201
        fid = f"2,{file_id.format_needle_id_cookie(1, COOKIE)}"
        assert both(t, "GET", 2, 1)[0] == 401
        bad = gen_read_jwt("not-the-key", fid)
        assert both(t, "GET", 2, 1, headers={"Authorization": f"BEARER {bad}"})[0] == 401
        before = [p.vs.fastlane.stats()["native_reads"] for p in t]
        for claim in (fid, ""):
            tok = gen_read_jwt("read-secret", claim)
            st, _, body = both(t, "GET", 2, 1, headers={"Authorization": f"BEARER {tok}"})
            assert (st, body) == (200, b"readable")
        assert [p.vs.fastlane.stats()["native_reads"] - b for p, b in zip(t, before)] == [2, 2]


def test_native_hmac_matches_python():
    """The engine's HMAC-SHA256 agrees with hashlib bit for bit."""
    for key, msg in [(b"k", b"message"), (b"x" * 100, b"y" * 1000), (b"", b""),
                     (b"sekrit", b"header.payload")]:
        assert native.hmac_sha256(key, msg) == hmac.new(key, msg, hashlib.sha256).digest()


# --- the engine in front of the master -------------------------------------------
def test_native_assign_profiles(twin):
    """The master's engine mints fids from installed profiles: unique,
    usable end to end, and never reused by Python-served assigns after."""
    for p in twin:
        m = p.master
        get_json(f"{m.url}/dir/assign")  # Python-served: installs the profile
        before = m.fastlane.stats()["native_assigns"]
        fids = set()
        for _ in range(150):
            a = get_json(f"{m.url}/dir/assign")
            assert a["fid"] not in fids, "duplicate fid"
            assert set(a) == {"fid", "url", "publicUrl", "count", "replicas"}
            fids.add(a["fid"])
        assert m.fastlane.stats()["native_assigns"] > before
        a = get_json(f"{m.url}/dir/assign")
        u = f"http://{a['publicUrl']}/{a['fid']}"
        assert http_request("POST", u, b"assign-native")[0] == 201
        assert http_request("GET", u)[2] == b"assign-native"
        m.fastlane.assign_clear()
        assert get_json(f"{m.url}/dir/assign")["fid"] not in fids


def test_assign_write_loadgen(twin):
    """The per-file assign -> write native driver against both masters."""
    for p in twin:
        r = native.loadgen_assign_write("127.0.0.1", p.master.fastlane.port, 4, 300,
                                        bytes(256))
        assert r["ok"] == 300 and r["errors"] == 0, r
        p.vs.fastlane.drain()
        assert sum(p.vs.store.get_volume(v).file_count()
                   for v in p.vs.store.volume_ids()) >= 300


def test_loadgen_binding(twin):
    """The native loadgen drives both engines end to end."""
    n = 200
    for p in twin:
        a = get_json(p.master.url + f"/dir/assign?count={n}")
        port = int(a["publicUrl"].rsplit(":", 1)[1])
        paths = [f"/{a['fid']}"] + [f"/{a['fid']}_{i}" for i in range(1, n)]
        w = native.loadgen("127.0.0.1", port, 4, "POST", paths, bytes(512))
        assert w["ok"] == n and w["errors"] == 0, w
        r = native.loadgen("127.0.0.1", port, 4, "GET", paths)
        assert r["ok"] == n and r["errors"] == 0, r


def test_raft_demote_clears_assign_profiles(tmp_path):
    """The raft node's demote hook is the master's profile clear."""
    m = MasterServer(port=0, pulse_seconds=1, peers=[], raft_dir=str(tmp_path / "r"))
    m.start()
    try:
        m.enable_raft([])
        assert m.raft.on_demote == m._fl_assign_clear
    finally:
        m.stop()


# --- metrics and spans -------------------------------------------------------------
def test_counters_and_histograms_move(twin):
    for p in twin:
        p.allocate(9)
    base = [p.vs.fastlane.metrics() for p in twin]
    both(twin, "POST", 9, 1, b"m" * 2048)
    both(twin, "GET", 9, 1)
    both(twin, "DELETE", 9, 1)
    for p, b in zip(twin, base):
        m = p.vs.fastlane.metrics()
        assert m["bounds_s"] == b["bounds_s"] and len(m["bounds_s"]) + 1 == len(
            m["ops"]["read"]["buckets"])
        for op, nbytes in (("read", 2048), ("write", 2048), ("delete", 0)):
            st, st0 = m["ops"][op], b["ops"][op]
            assert st["count"] == st0["count"] + 1, op
            assert st["bytes"] == st0["bytes"] + nbytes, op
            assert st["seconds_sum"] > st0["seconds_sum"], op
            assert sum(st["buckets"]) == st["count"], op
        vm = p.vs.fastlane.volume_metrics(9)
        assert (vm["reads"], vm["writes"], vm["deletes"]) == (1, 1, 1)
        assert vm["write_bytes"] == vm["read_bytes"] == 2048
    assert [p.vs.fastlane.volume_metrics(99) for p in twin] == [None, None]
    assert twin[1].vs.fastlane.metrics()["bounds_s"] == \
        twin[0].vs.fastlane.metrics()["bounds_s"]


def test_metrics_exported_on_metrics_endpoint(twin):
    """Both packages export the same fastlane families and label names, and
    the port's move with the traffic."""
    fams = []
    for p in twin:
        p.allocate(10)
    both(twin, "POST", 10, 1, b"x" * 100)
    both(twin, "GET", 10, 1)
    for p in twin:
        st, _, text = http_request("GET", f"{p.vs.service.url}/metrics")
        assert st == 200
        server = f"{p.vs._host}:{p.vs.data_port}"
        by_name: dict = {}
        for name, labels, value in parse_exposition(text.decode()):
            if "_fastlane_" in name and labels.get("server") == server:
                by_name.setdefault(name, []).append((labels, value))
        fams.append({n: sorted({tuple(sorted(lb)) for lb, _ in s}) for n, s in by_name.items()})
        req = {lb["op"]: v for lb, v in by_name["SeaweedFS_volume_fastlane_requests_total"]}
        assert req["read"] >= 1 and req["write"] >= 1
        byt = {lb["op"]: v for lb, v in by_name["SeaweedFS_volume_fastlane_bytes_total"]}
        assert byt["write"] >= 100 and byt["read"] >= 100
        assert any(v >= 1 for lb, v in by_name["SeaweedFS_volume_fastlane_request_seconds_bucket"]
                   if lb["op"] == "write")
        vols = by_name["SeaweedFS_volume_fastlane_volume_requests_total"]
        assert any(lb["op"] == "write" and lb["volume"] == "10" and v >= 1 for lb, v in vols)
    assert fams[1] == fams[0]


def test_drained_events_become_trace_spans(twin):
    port = twin[1]
    port.allocate(11)
    assert http_request("POST", port.url(11, 1), b"traced-bytes")[0] == 201
    assert http_request("DELETE", port.url(11, 1))[0] == 202
    port.vs.fastlane.drain()
    spans = [s for t in trace.collector().traces(limit=500) for s in t["spans"]
             if s["name"].startswith("fastlane.") and s["attrs"].get("vid") == 11]
    assert {s["name"] for s in spans} == {"fastlane.append", "fastlane.delete"}
    assert all(s["role"] == "volume" and s["attrs"]["native"] for s in spans)
    assert all(abs(s["start"] - time.time()) < 60 for s in spans)  # the engine's ns stamp


def test_missing_symbol_raises():
    """The library is built from this checkout: binding one that lacks a
    symbol raises instead of degrading."""
    class NoSymbols:
        def __getattr__(self, name):  # what ctypes does for a missing symbol
            raise AttributeError(name)

    with pytest.raises(AttributeError, match="sw_fl_"):
        fl_mod._bind(NoSymbols())
    fl_mod._bind(fl_mod._get_lib())  # the built library has every one


def test_start_failure_raises(tmp_path):
    """A failed sw_fl_start raises with the engine's message, and the
    service it would have fronted is stopped."""
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        vs = VolumeServer([str(tmp_path / "v")], port=busy.getsockname()[1], device="cpu")
        with pytest.raises(RuntimeError, match="fastlane engine failed to start"):
            vs.start()
        assert vs.service._httpd is None
    finally:
        busy.close()


def test_refused_registration_raises(tmp_path):
    """An engine that refuses a volume it serves raises with the engine's
    message; once the engine has stopped the refusal is a plain False (a
    shutdown race), and the volume keeps no hook either way."""
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(str(tmp_path), "", 7)
    try:
        gone = fl_mod.Fastlane(fl_mod._get_lib(), 4095)  # no engine at this handle
        with pytest.raises(RuntimeError, match="refused volume 7: engine handle invalid"):
            gone.register_volume(v)
        assert v._fl_hook is None and 7 not in gone._volumes
        gone.stopped = True
        assert gone.register_volume(v) is False
    finally:
        v.close()


def test_gates_leave_python_serving(tmp_path, monkeypatch):
    """The opt-out and a white list leave the Python service on the
    requested port, as in the JAX package."""
    monkeypatch.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
    assert not fl_mod.available()
    vs = VolumeServer([str(tmp_path / "a")], device="cpu")
    vs.start()
    try:
        assert vs.fastlane is None and vs.data_port == vs.service.port
    finally:
        vs.stop()
    monkeypatch.delenv("SEAWEEDFS_TPU_DISABLE_FASTLANE")
    vs = VolumeServer([str(tmp_path / "b")], device="cpu",
                      security=SecurityConfig(white_list=["127.0.0.1"]))
    vs.start()
    try:
        assert vs.fastlane is None
    finally:
        vs.stop()


# --- online EC through the engine --------------------------------------------------
def test_native_appends_drain_into_online_parity(tmp_path):
    """Native appends to an ecOnline volume stream through the port's
    writer from the drain loop: the engine's stripe accumulator is armed,
    and every parity row equals the JAX writer's encode of the same .dat
    rows."""
    with pairs(tmp_path, master_kw={"ec_online": "hot", "ec_online_block": BLOCK}) as t:
        for p in t:
            p.allocate(12, collection="hot", ecOnline=True, ecOnlineBlock=BLOCK)
        port = t[1]
        v = port.vs.store.get_volume(12)
        assert port.vs.fastlane.ec_online_pending(12) is not None  # armed
        for nid, data in enumerate(seeded(4, 6, BLOCK * 5, BLOCK * 9), 1):
            both(t, "POST", 12, nid, data)
        assert port.vs.fastlane.stats()["native_writes"] == 6
        port.vs.fastlane.drain()
        port.vs._pump_online_ec()  # what the drain loop runs every tick
        assert v.online_ec.stripes >= 2
        assert port.vs.fastlane.ec_online_pending(12)[0] == 0  # re-armed
        rows = v.online_ec.watermark // (BLOCK * geometry.DATA_SHARDS_COUNT)
        with open(v.base_name + ".dat", "rb") as f:
            dat = np.frombuffer(f.read(rows * BLOCK * 10), np.uint8)
        x = dat.reshape(rows, 10, BLOCK).transpose(1, 0, 2).reshape(10, -1)
        want = RefCodec(backend="numpy").encode(x).reshape(4, rows, BLOCK)
        for s in range(4):
            with open(v.base_name + geometry.to_ext(10 + s), "rb") as f:
                got = np.frombuffer(f.read(rows * BLOCK), np.uint8)
            assert np.array_equal(got, want[s].reshape(-1)), f"parity shard {10 + s}"
        assert_same_files(t, 12)


# --- the heat rollup fed by native counters ---------------------------------------
def test_heat_rollup_reads_native_counters(twin):
    """The beat carries each volume's native op counters, equal in both
    packages, and the master's rollup turns them into rates above 0."""
    for p in twin:
        p.allocate(13, collection="heat")
    for nid, data in enumerate(seeded(5, 10), 1):
        both(twin, "POST", 13, nid, data)
        both(twin, "GET", 13, nid)
    beats = []
    for p in twin:
        p.vs.fastlane.drain()
        hb = {v["id"]: v for v in p.vs.store.collect_heartbeat()["volumes"]}
        vm = p.vs.fastlane.volume_metrics(13)
        beats.append((vm["reads"], vm["writes"], vm["read_bytes"], vm["write_bytes"]))
        assert 13 in hb
    assert beats[1] == beats[0] == (10, 10, beats[0][2], beats[0][3])
    port = twin[1]
    rollup = port.master.heat_rollup
    sent = []
    real_feed = rollup.feed

    def feed(node, volumes):
        sent.append([dict(v) for v in volumes])
        return real_feed(node, volumes)

    rollup.feed = feed
    try:
        port.vs.heartbeat_once()
        for nid in range(1, 11):
            http_request("GET", port.url(13, nid))
        time.sleep(1.1)
        port.vs.heartbeat_once()
    finally:
        rollup.feed = real_feed
    mine = [v for beat in sent for v in beat if v["id"] == 13]
    assert mine and {"read_ops", "write_ops", "read_bytes", "write_bytes"} <= set(mine[-1])
    assert mine[-1]["read_ops"] == 20 and mine[-1]["write_ops"] == 10
    lines = "\n".join(rollup.lines())
    rates = {lb.get("collection"): v for n, lb, v in parse_exposition(lines)
             if n == "SeaweedFS_heat_collection_score"}
    assert rates.get("heat", 0) > 0, lines
