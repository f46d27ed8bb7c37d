"""The port's filer HTTP server held against the JAX package's, side by side.

Two clusters run in this process: the JAX package's `MasterServer`, two
`VolumeServer`s and `FilerServer` (its native front door switched off with
SEAWEEDFS_TPU_DISABLE_FASTLANE=1, so its Python handlers, which the port
copies, answer), and the port's, all at `device="cpu"`. Both filers get
`chunk_size = 4096`, set after construction, so the plain MD5 on the CPU
stays cheap. The same seeded requests go to both.

Compared: status, body and headers, apart from `Date`, `Last-Modified`
and the JAX package's trace id header (tracing is not ported); listing
mtimes (and so a listing's `Content-Length`, held to its own body); and
each entry's `?metadata=true`, apart from fids, mtimes, `modified_ts_ns`,
cipher keys and hard-link ids (present on both, their values random). Chunk sizes, offsets, ETags, `is_compressed`, manifests
and the entry's `md5` must be equal.

Every chunked write to the port's main filer must add exactly its chunk
count to `hash_service.batch_blobs`: the chunk ETags went through the
batch path (the CPU's plain `md5_batch` / `crc32c_batch`), and inline
content through `submit`'s idle path on the host.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import math
import re
import tempfile
import time
import types

import numpy as np
import pytest
import torch

from seaweedfs_tpu.server.filer import FilerServer as RefFilerServer
from seaweedfs_tpu.server.master import MasterServer as RefMasterServer
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.filer.wdclient import WeedClient
from seaweedfs_tpu_torch.server.filer import SMALL_CONTENT_LIMIT, FilerServer
from seaweedfs_tpu_torch.server.httpd import get_json, http_request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests._threads import stop_history_loops  # noqa: F401

CHUNK = 4096
VOLATILE_HEADERS = ("Date", "Last-Modified", "X-Sw-Trace-Id")
DATE_CELL = re.compile(rb"\d{4}-\d\d-\d\d \d\d:\d\d")
DEDUP_KW = dict(dedup_avg_bits=10, dedup_min=1024, dedup_max=8192)


class Side:
    def __init__(self, master, vols, filers) -> None:
        self.master = master
        self.vols = vols
        self.filers = filers


def _ref_filer(master_url: str, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        f = RefFilerServer(master_url, port=0, **kw)
        f.chunk_size = CHUNK
        f.start()
    return f


def _port_filer(master_url: str, **kw):
    f = FilerServer(master_url, port=0, device="cpu", **kw)
    f.chunk_size = CHUNK
    f.start()
    return f


class Pair:
    """A JAX filer and a port filer, each on its own cluster."""

    def __init__(self, ref, port) -> None:
        self.ref = ref
        self.port = port
        # the dedup path hashes its ETags with md5_spans (host code)
        self.batched = not port.dedup


@pytest.fixture(scope="module")
def sides():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
        rm = RefMasterServer(port=0, pulse_seconds=1)
        rm.start()
        rvols = [RefVolumeServer([tempfile.mkdtemp()], rm.url, port=0, pulse_seconds=1,
                                 max_volume_count=20) for _ in range(2)]
        for v in rvols:
            v.start()
    pm = MasterServer(port=0, pulse_seconds=1)
    pm.start()
    pvols = [VolumeServer([tempfile.mkdtemp()], pm.url, port=0, pulse_seconds=1,
                          max_volume_count=20, device="cpu") for _ in range(2)]
    for v in pvols:
        v.start()
    ref, port = Side(rm, rvols, []), Side(pm, pvols, [])
    yield ref, port
    for side in (port, ref):
        for f in side.filers:
            f.stop()
        for v in side.vols:
            v.stop()
        side.master.stop()


def _pair(sides, **kw) -> Pair:
    ref, port = sides
    r = _ref_filer(ref.master.url, **kw)
    p = _port_filer(port.master.url, **kw)
    ref.filers.append(r)
    port.filers.append(p)
    return Pair(r, p)


@pytest.fixture(scope="module")
def main(sides):
    return _pair(sides)


# --- comparing -----------------------------------------------------------------
def _headers(h: dict) -> dict:
    return {k: v for k, v in h.items() if k not in VOLATILE_HEADERS}


def _drop_mtimes(obj):
    if isinstance(obj, dict):
        return {k: _drop_mtimes(v) for k, v in obj.items() if k != "Mtime"}
    if isinstance(obj, list):
        return [_drop_mtimes(v) for v in obj]
    return obj


def _body(headers: dict, body: bytes):
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("application/json") and body:
        return _drop_mtimes(json.loads(body))
    if ctype.startswith("text/html"):
        return DATE_CELL.sub(b"<mtime>", body)
    return body


def call(filer, method: str, path: str, body: bytes | None = None, headers=None):
    return http_request(method, filer.url + path, body, headers)


def same(pair: Pair, method: str, path: str, body=None, headers=None):
    """The request to both filers (body: bytes, or a (ref, port) pair);
    status, headers and body must agree. Returns the port's answer."""
    rb, pb = body if isinstance(body, tuple) else (body, body)
    r = call(pair.ref, method, path, rb, headers)
    p = call(pair.port, method, path, pb, headers)
    assert r[0] == p[0], f"{method} {path}: status {r[0]} != {p[0]}: {r[2][:200]!r} {p[2][:200]!r}"
    hr, hp = _headers(r[1]), _headers(p[1])
    if method != "HEAD" and hp.get("Content-Type", "").startswith(
            ("application/json", "text/html")):
        # listings carry mtimes, whose digits set the length
        for h, (_, _, b) in ((hr, r), (hp, p)):
            assert int(h.pop("Content-Length")) == len(b)
    assert hr == hp, f"{method} {path}: headers"
    assert _body(r[1], r[2]) == _body(p[1], p[2]), f"{method} {path}: body"
    return p


def chunks_of(path: str, data: bytes) -> int:
    inline = len(data) <= SMALL_CONTENT_LIMIT or path.startswith("/etc/seaweedfs/")
    return 0 if inline else math.ceil(len(data) / CHUNK)


def put(pair: Pair, path: str, data: bytes, headers=None, method: str = "PUT",
        file_bytes: bytes | None = None):
    """A write through both filers, which must answer 201 with the body's
    MD5; the port's hash service must have batched exactly the write's
    chunk ETags."""
    before = pair.port.hash_service.batch_blobs
    p = same(pair, method, path, data, headers)
    assert p[0] == 201, p[2]
    body = data if file_bytes is None else file_bytes
    if pair.batched:
        assert pair.port.hash_service.batch_blobs - before == chunks_of(path, body)
    assert json.loads(p[2])["md5"] == hashlib.md5(body).hexdigest()
    return p


def _entry(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    for k in ("mtime", "crtime"):
        d["attributes"].pop(k)
    if d.get("hard_link_id"):
        d["hard_link_id"] = "<id>"
    for c in d["chunks"]:
        c["file_id"] = "<fid>"
        c.pop("modified_ts_ns")
        if "cipher_key" in c:
            c["cipher_key"] = "<key>"
    return d


def meta(filer, path: str) -> dict:
    status, _, body = call(filer, "GET", path + "?metadata=true")
    assert status == 200, body
    return json.loads(body)


def same_meta(pair: Pair, path: str) -> tuple[dict, dict]:
    r, p = meta(pair.ref, path), meta(pair.port, path)
    assert _entry(r) == _entry(p), path
    return r, p


def fids_gone(filer, fids) -> bool:
    for fid in fids:
        for url in filer.client.lookup_file_id(fid):
            if http_request("GET", url)[0] != 404:
                return False
    return True


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def text(n: int) -> bytes:
    line = b"the filer stores small files inline and large ones in chunks %06d\n"
    out = b"".join(line % i for i in range(n // len(line) + 1))
    return out[:n]


# --- tests/test_filer.py::TestFilerHTTP's cases, on both -------------------------
def test_small_file_inline(main):
    put(main, "/notes/hello.txt", b"small content", {"Content-Type": "text/plain"})
    p = same(main, "GET", "/notes/hello.txt")
    assert p[2] == b"small content" and p[1]["Content-Type"] == "text/plain"
    _, m = same_meta(main, "/notes/hello.txt")
    assert m["content"] and not m["chunks"]
    # an inline body at the limit, and one a byte past it (one chunk)
    put(main, "/notes/limit.bin", seeded(1, SMALL_CONTENT_LIMIT))
    put(main, "/notes/past.bin", seeded(2, SMALL_CONTENT_LIMIT + 1))
    assert len(same_meta(main, "/notes/past.bin")[1]["chunks"]) == 1


def test_chunked_upload_and_md5(main):
    data = seeded(3, 3 * CHUNK + 1234)
    put(main, "/big/blob.bin", data)
    _, m = same_meta(main, "/big/blob.bin")
    assert [(c["offset"], c["size"]) for c in m["chunks"]] == [
        (0, CHUNK), (CHUNK, CHUNK), (2 * CHUNK, CHUNK), (3 * CHUNK, 1234)]
    assert [c["etag"] for c in m["chunks"]] == [
        hashlib.md5(data[o : o + CHUNK]).hexdigest() for o in range(0, len(data), CHUNK)]
    assert same(main, "GET", "/big/blob.bin")[2] == data
    assert main.port.assign_batch_fallbacks == 0


def test_range_read_across_chunks(main):
    data = bytes(range(256)) * 64  # 4 chunks
    put(main, "/r/data.bin", data)
    start, end = CHUNK - 100, 2 * CHUNK + 99
    p = same(main, "GET", "/r/data.bin", headers={"Range": f"bytes={start}-{end}"})
    assert p[0] == 206 and p[2] == data[start : end + 1]
    assert p[1]["Content-Range"] == f"bytes {start}-{end}/{len(data)}"


@pytest.mark.parametrize("rng,status,lo,hi", [
    ("bytes=-100", 206, -100, None),
    ("bytes=100-", 206, 100, None),
    ("bytes=5000-5000", 206, 5000, 5001),
    ("bytes=0-99999999", 206, 0, None),
    ("bytes=99999-", 416, None, None),
    ("bytes=abc-def", 200, 0, None),
    ("bytes=0-1,5-6", 200, 0, None),
])
def test_ranges(main, rng, status, lo, hi):
    path = "/r/ranges.bin"
    data = seeded(4, 2 * CHUNK + 7)
    if main.port.filer.find_entry(path) is None:
        put(main, path, data)
    p = same(main, "GET", path, headers={"Range": rng})
    assert p[0] == status
    if status == 416:
        assert p[1]["Content-Range"] == f"bytes */{len(data)}" and p[2] == b""
    else:
        assert p[2] == data[lo:hi]


def test_head(main):
    data = seeded(5, CHUNK + 10)
    put(main, "/h/f.bin", data, {"Content-Type": "application/octet-stream"})
    p = same(main, "HEAD", "/h/f.bin")
    assert p[0] == 200 and p[2] == b""
    assert p[1]["X-File-Size"] == p[1]["Content-Length"] == str(len(data))
    p = same(main, "HEAD", "/h/f.bin", headers={"Range": "bytes=10-19"})
    assert p[0] == 206 and p[1]["Content-Range"] == f"bytes 10-19/{len(data)}"
    assert same(main, "HEAD", "/h/missing.bin")[0] == 404


def test_directory_listing(main):
    for name in ["a.txt", "b.txt"]:
        put(main, f"/docs/{name}", b"x")
    listing = same(main, "GET", "/docs")
    assert [e["FullPath"] for e in json.loads(listing[2])["Entries"]] == [
        "/docs/a.txt", "/docs/b.txt"]
    p = same(main, "GET", "/docs?limit=1")
    assert json.loads(p[2])["ShouldDisplayLoadMore"] is True
    p = same(main, "GET", "/docs?lastFileName=a.txt")
    assert [e["FullPath"] for e in json.loads(p[2])["Entries"]] == ["/docs/b.txt"]
    assert same(main, "GET", "/docs", headers={"X-Sw-S3": "1"})[0] == 404


def test_delete_reclaims_chunks(main):
    data = seeded(6, 2 * CHUNK)
    put(main, "/tmp/junk.bin", data)
    r, p = same_meta(main, "/tmp/junk.bin")
    assert same(main, "DELETE", "/tmp/junk.bin")[0] == 204
    assert same(main, "GET", "/tmp/junk.bin")[0] == 404
    for filer, m in ((main.ref, r), (main.port, p)):
        assert fids_gone(filer, [c["file_id"] for c in m["chunks"]])
    # non-empty directories need recursive=true
    put(main, "/tree/sub/f.bin", seeded(7, CHUNK + 1))
    assert same(main, "DELETE", "/tree")[0] == 409
    assert same(main, "DELETE", "/tree?recursive=true")[0] == 204
    assert same(main, "GET", "/tree/sub/f.bin")[0] == 404


def test_overwrite_latest_wins(main):
    put(main, "/v/file.txt", b"version one")
    put(main, "/v/file.txt", b"version TWO!")
    assert same(main, "GET", "/v/file.txt")[2] == b"version TWO!"
    first = seeded(8, 3 * CHUNK)
    put(main, "/v/big.bin", first)
    r, p = same_meta(main, "/v/big.bin")
    put(main, "/v/big.bin", seeded(9, 2 * CHUNK + 5))
    same_meta(main, "/v/big.bin")
    # the overwritten version's blobs are reclaimed
    for filer, m in ((main.ref, r), (main.port, p)):
        assert fids_gone(filer, [c["file_id"] for c in m["chunks"]])


def test_conditional_get(main):
    put(main, "/etag/f.txt", b"cacheable")
    p = same(main, "GET", "/etag/f.txt")
    etag = p[1]["ETag"]
    assert etag == f'"{hashlib.md5(b"cacheable").hexdigest()}"'
    p = same(main, "GET", "/etag/f.txt", headers={"If-None-Match": etag})
    assert p[0] == 304 and p[2] == b""
    assert same(main, "GET", "/etag/f.txt", headers={"If-None-Match": '"x"'})[0] == 200


def test_html_directory_browser(main):
    put(main, "/web/a.txt", b"hello")
    assert same(main, "POST", "/web/sub/?mkdir=true", b"")[0] == 201
    p = same(main, "GET", "/web", headers={"Accept": "text/html,application/xhtml+xml"})
    assert p[1]["Content-Type"].startswith("text/html")
    assert b"a.txt" in p[2] and b"sub/" in p[2] and b"<table" in p[2]
    evil = 'x" onmouseover="alert(1)'
    put(main, f"/web/{__import__('urllib.parse', fromlist=['quote']).quote(evil)}", b"z")
    put(main, "/web/report%231.txt", b"z")
    p = same(main, "GET", "/web", headers={"Accept": "text/html"})
    assert b'href="/web/x%22%20onmouseover' in p[2]
    assert b"report%231.txt" in p[2]
    p = same(main, "GET", "/web?limit=2", headers={"Accept": "text/html"})
    assert b"more" in p[2]
    assert json.loads(same(main, "GET", "/web")[2])["Entries"]


# --- the rest of the write path ------------------------------------------------------
def test_multipart(main):
    data = seeded(10, 2 * CHUNK + 3)
    boundary = "----portfilerboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"up.bin\"\r\nContent-Type: application/x-test\r\n\r\n"
            ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    put(main, "/mp/file.bin", body, headers, method="POST", file_bytes=data)
    p = same(main, "GET", "/mp/file.bin")
    assert p[2] == data and p[1]["Content-Type"] == "application/x-test"
    same_meta(main, "/mp/file.bin")


def test_mv_from(main):
    data = seeded(11, CHUNK + 500)
    put(main, "/mv/a.bin", data)
    p = same(main, "POST", "/mv/b.bin?mv.from=/mv/a.bin", b"")
    assert p[0] == 200 and json.loads(p[2]) == {"ok": True}
    assert same(main, "GET", "/mv/a.bin")[0] == 404
    assert same(main, "GET", "/mv/b.bin")[2] == data
    same_meta(main, "/mv/b.bin")
    assert same(main, "POST", "/mv/c.bin?mv.from=/mv/none.bin", b"")[0] == 409


def test_link_from(main):
    data = seeded(12, 2 * CHUNK + 1)
    put(main, "/ln/a.bin", data)
    p = same(main, "POST", "/ln/b.bin?link.from=/ln/a.bin", b"")
    assert p[0] == 201 and json.loads(p[2]) == {"ok": True, "nlink": 2}
    assert same(main, "GET", "/ln/b.bin")[2] == data
    _, m = same_meta(main, "/ln/b.bin")
    assert m["hard_link_id"] and m["hard_link_counter"] == 2
    # the surviving link keeps the shared chunks
    assert same(main, "DELETE", "/ln/a.bin")[0] == 204
    assert same(main, "GET", "/ln/b.bin")[2] == data
    assert same(main, "POST", "/ln/c.bin?link.from=/ln/none.bin", b"")[0] == 409


def test_meta_entry(main):
    data = seeded(13, 2 * CHUNK + 9)
    put(main, "/me/src.bin", data)
    r, p = meta(main.ref, "/me/src.bin"), meta(main.port, "/me/src.bin")
    bodies = (json.dumps(r).encode(), json.dumps(p).encode())
    q = same(main, "POST", "/me/copy.bin?meta.entry=true", bodies)
    assert q[0] == 201 and json.loads(q[2]) == {"name": "copy.bin"}
    assert same(main, "GET", "/me/copy.bin")[2] == data
    same_meta(main, "/me/copy.bin")
    assert same(main, "POST", "/me/bad.bin?meta.entry=true", b'{"chunks": [{}]}')[0] == 409


def test_mkdir(main):
    assert same(main, "POST", "/dirs/new/", b"")[0] == 201
    assert same(main, "POST", "/dirs/other?mkdir=true", b"")[0] == 201
    listing = json.loads(same(main, "GET", "/dirs")[2])
    # the path is normalized before the trailing-slash test, so the JAX
    # filer writes an empty file at "/dirs/new/"; the port does the same
    assert [(e["FullPath"], e["IsDirectory"]) for e in listing["Entries"]] == [
        ("/dirs/new", False), ("/dirs/other", True)]
    same_meta(main, "/dirs/new")


def test_fs_configure_rule(sides, main):
    conf = {"locations": [
        {"location_prefix": "/ro/", "read_only": True},
        {"location_prefix": "/coll/", "collection": "c1", "ttl": "5m"},
        {"location_prefix": "/badttl/", "ttl": "zz"},
    ]}
    put(main, "/etc/seaweedfs/filer.conf", json.dumps(conf).encode())
    p = same(main, "PUT", "/ro/x.bin", b"data")
    assert p[0] == 403 and "read-only" in json.loads(p[2])["error"]
    assert same(main, "DELETE", "/ro/x.bin")[0] == 403
    data = seeded(14, CHUNK + 77)
    put(main, "/coll/f.bin", data)
    _, m = same_meta(main, "/coll/f.bin")
    assert m["attributes"]["ttl_sec"] == 300
    for side in sides:
        assert "c1" in json.dumps(get_json(side.master.url + "/col/list"))
    put(main, "/badttl/f.bin", data)  # a malformed rule ttl is ignored
    assert same_meta(main, "/badttl/f.bin")[1]["attributes"]["ttl_sec"] == 0
    # the collection a request resolves to, as the JAX filer resolves it
    for path, query in (("/coll/a", {}), ("/coll/a", {"collection": "q"}),
                        ("/etc/x", {}), ("/other", {})):
        req = types.SimpleNamespace(path=path, query=query)
        assert main.port._resolve_collection(req) == main.ref._resolve_collection(req)
    # the rule goes away with the conf
    assert same(main, "DELETE", "/etc/seaweedfs/filer.conf")[0] == 204
    put(main, "/ro/x.bin", b"data")


def test_ttl(main):
    data = seeded(15, CHUNK + 3)
    put(main, "/ttl/f.bin?ttl=3m", data)
    assert same_meta(main, "/ttl/f.bin")[1]["attributes"]["ttl_sec"] == 180
    assert same(main, "GET", "/ttl/f.bin")[2] == data
    # an entry past its TTL is reaped on read
    old = {"full_path": "/ttl/old.txt", "content": b"abc".hex(),
           "attributes": {"mtime": time.time() - 3600, "ttl_sec": 60, "file_size": 3}}
    assert same(main, "POST", "/ttl/old.txt?meta.entry=true",
                json.dumps(old).encode())[0] == 201
    p = same(main, "GET", "/ttl/old.txt")
    assert p[0] == 404 and json.loads(p[2]) == {"error": "/ttl/old.txt expired"}
    assert same(main, "GET", "/ttl/old.txt")[0] == 404


def test_compressed_text_range_read(main):
    data = text(3 * CHUNK + 500)
    put(main, "/z/t.txt", data, {"Content-Type": "text/plain"})
    _, m = same_meta(main, "/z/t.txt")
    assert all(c.get("is_compressed") for c in m["chunks"])
    start, end = CHUNK - 50, 2 * CHUNK + 50
    p = same(main, "GET", "/z/t.txt", headers={"Range": f"bytes={start}-{end}"})
    assert p[2] == data[start : end + 1]
    # decoded through _fetch_whole_chunk into the tiered cache
    assert main.port.chunk_cache.get_chunk(
        main.port.filer.find_entry("/z/t.txt").chunks[1].file_id) == data[CHUNK : 2 * CHUNK]
    assert same(main, "GET", "/z/t.txt")[2] == data


def test_manifest_upload(main):
    n_chunks = 1002
    data = seeded(16, (n_chunks - 1) * CHUNK + 100)
    put(main, "/mf/huge.bin", data)
    r, p = same_meta(main, "/mf/huge.bin")
    assert [(c["is_chunk_manifest"], c["offset"], c["size"]) for c in p["chunks"]] == [
        (True, 0, 1000 * CHUNK), (True, 1000 * CHUNK, CHUNK + 100)]
    inner = main.port._resolved_chunks(main.port.filer.find_entry("/mf/huge.bin"))
    ref_inner = main.ref._resolved_chunks(main.ref.filer.find_entry("/mf/huge.bin"))
    assert len(inner) == n_chunks
    assert [(c.offset, c.size, c.etag) for c in inner] == [
        (c.offset, c.size, c.etag) for c in ref_inner]
    start = 1000 * CHUNK - 60
    q = same(main, "GET", "/mf/huge.bin", headers={"Range": f"bytes={start}-{start + 119}"})
    assert q[2] == data[start : start + 120]
    assert same(main, "GET", "/mf/huge.bin")[2] == data
    assert same(main, "DELETE", "/mf/huge.bin")[0] == 204
    for filer, m, chunks in ((main.ref, r, ref_inner), (main.port, p, inner)):
        assert fids_gone(filer, [c["file_id"] for c in m["chunks"]]
                         + [chunks[0].file_id, chunks[-1].file_id])


def test_cipher(sides):
    pair = _pair(sides, cipher=True)
    data = seeded(17, 3 * CHUNK + 5)
    put(pair, "/c/x.bin", data)
    _, m = same_meta(pair, "/c/x.bin")
    assert all(c.get("cipher_key") for c in m["chunks"])
    # volume servers hold ciphertext
    fid = pair.port.filer.find_entry("/c/x.bin").chunks[0].file_id
    assert pair.port.client.fetch(fid) != data[:CHUNK]
    assert same(pair, "GET", "/c/x.bin")[2] == data
    p = same(pair, "GET", "/c/x.bin", headers={"Range": f"bytes={CHUNK - 9}-{CHUNK + 9}"})
    assert p[2] == data[CHUNK - 9 : CHUNK + 10]
    assert same(pair, "DELETE", "/c/x.bin")[0] == 204


def test_cipher_needs_cryptography(monkeypatch, sides):
    from seaweedfs_tpu_torch.util import cipher

    monkeypatch.setattr(cipher, "AESGCM", None)
    with pytest.raises(RuntimeError, match="cryptography"):
        FilerServer(sides[1].master.url, port=0, device="cpu", cipher=True)


def test_dedup_over_http(sides):
    pair = _pair(sides, dedup=True, **DEDUP_KW)
    data = seeded(18, 64 * 1024)
    put(pair, "/d/a.bin", data)
    put(pair, "/d/b.bin", data)
    same_meta(pair, "/d/a.bin")
    same_meta(pair, "/d/b.bin")
    for filer in (pair.ref, pair.port):
        a = [c.file_id for c in filer.filer.find_entry("/d/a.bin").chunks]
        b = [c.file_id for c in filer.filer.find_entry("/d/b.bin").chunks]
        assert a == b and len(a) > 4  # every chunk of the copy deduped
    # the copy's blobs are index-owned: deleting one file keeps them
    assert same(pair, "DELETE", "/d/a.bin")[0] == 204
    assert same(pair, "GET", "/d/b.bin")[2] == data
    assert pair.port._dedup_managed(pair.port.filer.find_entry("/d/b.bin").chunks[0])
    put(pair, "/d/b.bin", seeded(19, 3000))  # an overwrite keeps them too
    assert same(pair, "GET", "/d/b.bin")[2] == seeded(19, 3000)


def test_meta_info(main):
    r = json.loads(call(main.ref, "GET", "/__meta__/info")[2])
    p = json.loads(call(main.port, "GET", "/__meta__/info")[2])
    assert sorted(r) == sorted(p) and p["chunk_size"] == r["chunk_size"] == CHUNK
    assert p["master"] == main.port.client.master_url


def test_every_chunk_etag_batched(main):
    """Over every write of this file's main pair: the port's hash service
    batched one blob a chunk ETag, failed none, and each multi-chunk upload
    took one batched assign."""
    svc = main.port.hash_service
    assert svc.batch_blobs > 0 and svc.failed_blobs == 0
    assert main.port.assign_batch_fallbacks == 0


# --- the copied pieces against the JAX package's ------------------------------------
def _random_chunks(seed: int, cls, n: int = 12) -> list:
    rng = np.random.default_rng([seed, 30])
    return [cls(file_id=f"{int(rng.integers(1, 9))},{i:x}ab", offset=int(rng.integers(0, 5000)),
                size=int(rng.integers(1, 3000)), modified_ts_ns=int(rng.integers(0, 50)),
                etag=f"e{i}") for i in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_filechunks_equal_reference(seed):
    from seaweedfs_tpu.filer import filechunks as ref_fc
    from seaweedfs_tpu.filer.entry import FileChunk as RefChunk
    from seaweedfs_tpu_torch.filer import filechunks as fc
    from seaweedfs_tpu_torch.filer.entry import FileChunk

    port, ref = _random_chunks(seed, FileChunk), _random_chunks(seed, RefChunk)
    assert [vars(v) for v in fc.read_resolved_chunks(port)] == [
        vars(v) for v in ref_fc.read_resolved_chunks(ref)]
    rng = np.random.default_rng([seed, 31])
    for _ in range(4):
        off, size = int(rng.integers(0, 6000)), int(rng.integers(0, 4000))
        assert [vars(v) for v in fc.view_from_chunks(port, off, size)] == [
            vars(v) for v in ref_fc.view_from_chunks(ref, off, size)]
    assert fc.total_size(port) == ref_fc.total_size(ref)
    live, garbage = fc.separate_garbage_chunks(port)
    r_live, r_garbage = ref_fc.separate_garbage_chunks(ref)
    assert [c.to_dict() for c in live + garbage] == [c.to_dict() for c in r_live + r_garbage]
    # manifests: packed the same, and resolved back to the chunks
    blobs, ref_blobs = {}, {}

    def save(blob, store, cls):
        store[f"m{len(store)}"] = blob
        return cls(file_id=f"m{len(store) - 1}", offset=0, size=len(blob))

    got = fc.maybe_manifestize(lambda b: save(b, blobs, FileChunk), port, batch=5)
    want = ref_fc.maybe_manifestize(lambda b: save(b, ref_blobs, RefChunk), ref, batch=5)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    # gzip stamps the time into its header: compare the packed JSON
    assert {k: gzip.decompress(v) for k, v in blobs.items()} == {
        k: gzip.decompress(v) for k, v in ref_blobs.items()}
    assert fc.unpack_manifest(fc.pack_manifest(port)) == port
    resolved = fc.resolve_chunk_manifest(lambda c: blobs[c.file_id], got)
    assert sorted(c.to_dict()["file_id"] for c in resolved) == sorted(c.file_id for c in port)


def test_filer_conf_equal_reference():
    from seaweedfs_tpu.filer.filer_conf import FilerConf as RefConf
    from seaweedfs_tpu_torch.filer.filer_conf import FilerConf

    raw = json.dumps({"locations": [
        {"location_prefix": "/a/", "collection": "x"},
        {"location_prefix": "/a/b/", "read_only": True},
        {"location_prefix": "/", "ttl": "1d"}]}).encode()
    port, ref = FilerConf.from_bytes(raw), RefConf.from_bytes(raw)
    for conf in (port, ref):
        conf.upsert({"location_prefix": "/c/", "replication": "001"})
        conf.delete("/")
    for path in ("/a/b/c", "/a/x", "/c/1", "/z", "/"):
        assert port.match(path) == ref.match(path)
    assert port.to_bytes() == ref.to_bytes() and port.prefixes() == ref.prefixes()
    assert FilerConf.from_bytes(b"not json").rules == RefConf.from_bytes(b"not json").rules == []


def test_chunk_cache_equal_reference(tmp_path):
    from seaweedfs_tpu.util.chunk_cache import TieredChunkCache as RefCache
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache

    port = TieredChunkCache(mem_limit=3000, disk_dir=str(tmp_path / "p"), disk_limit=20000)
    ref = RefCache(mem_limit=3000, disk_dir=str(tmp_path / "r"), disk_limit=20000)
    rng = np.random.default_rng(32)
    for i in range(60):
        key = f"{int(rng.integers(0, 12))},k"
        if rng.random() < 0.5:
            blob = seeded(i, int(rng.integers(1, 4000)))
            port.set_chunk(key, blob)
            ref.set_chunk(key, blob)
        else:
            assert port.get_chunk(key) == ref.get_chunk(key)
    # a restart over the same directories finds the same disk tiers
    port2 = TieredChunkCache(mem_limit=3000, disk_dir=str(tmp_path / "p"), disk_limit=20000)
    ref2 = RefCache(mem_limit=3000, disk_dir=str(tmp_path / "r"), disk_limit=20000)
    for i in range(12):
        assert port2.get_chunk(f"{i},k") == ref2.get_chunk(f"{i},k")


def test_cipher_interoperates_with_reference():
    from seaweedfs_tpu.util import cipher as ref_cipher
    from seaweedfs_tpu_torch.util import cipher

    data = seeded(33, 5000)
    sealed, key = cipher.encrypt(data)
    assert len(key) == cipher.KEY_SIZE and len(sealed) == cipher.NONCE_SIZE + len(data) + 16
    assert ref_cipher.decrypt(sealed, key) == data
    sealed, key = ref_cipher.encrypt(data)
    assert cipher.decrypt(sealed, key) == data
    with pytest.raises(ValueError):
        cipher.decrypt(b"short", key)


# --- the port alone -------------------------------------------------------------
def test_weed_client(sides):
    port = sides[1]
    c = WeedClient(port.master.url)
    try:
        a = c.assign()
        assert a["fid"] and a["publicUrl"]
        fids, loc, auth = c.assign_batch(3)
        assert fids[1:] == [f"{fids[0]}_1", f"{fids[0]}_2"] and auth == ""
        blobs = [seeded(20 + i, 1000 + i) for i in range(3)]
        for fid, blob in zip(fids, blobs):
            out = c.upload_to(fid, loc, blob)
            assert out["size"] == len(blob)
        vid = int(fids[0].split(",")[0])
        assert c.lookup_cached(vid) is None or c.lookup_cached(vid) == c.lookup(vid)
        assert c.lookup(vid) == c.lookup_cached(vid)
        assert c.lookup_file_id(fids[1]) == [f"http://{u}/{fids[1]}" for u in c.lookup(vid)]
        for fid, blob in zip(fids, blobs):
            assert c.fetch(fid) == blob
            assert c.fetch(fid, range_header="bytes=10-19") == blob[10:20]
        up = c.upload(b"hello weed", collection="wc")
        assert c.fetch(up["fid"]) == b"hello weed"
        c.invalidate(vid)
        assert c.lookup_cached(vid) is None
        c.delete(fids[0])
        c.delete(fids[0])  # idempotent
        with pytest.raises(IOError):
            c.fetch(fids[0])
        assert c.fetch(fids[2]) == blobs[2]
    finally:
        c.close()


def test_filer_needs_a_device(monkeypatch, sides):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        FilerServer(sides[1].master.url, port=0)
    with pytest.raises(ValueError):
        FilerServer(device="cpu")  # neither a master nor a client
