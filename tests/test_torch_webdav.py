"""The port's WebDAV gateway held against the JAX package's, request for
request, case for case with `tests/test_webdav.py` (OPTIONS, PROPFIND at
depth 0 and 1, MKCOL, PUT, GET with ranges, HEAD, PROPPATCH, MOVE, COPY,
DELETE, class-2 locks with their enforcement and expiry, read-only mode),
plus the PROPFIND XML of a seeded tree, COPY and MOVE of trees, and the
`getetag` of bodies that span chunks.

`DavPair` starts one `WebDavServer` of each package over the filers of
`tests/test_torch_filer_meta.py::twin` (a JAX cluster and a port cluster on
`device="cpu"`, both filers at 4 KiB chunks) and sends every request to
both, one side at a time. It holds equal: the status, the DAV, Allow,
MS-Author-Via, Content-Type, ETag, Content-Range, Content-Length and
Lock-Token headers, and the body. Each side's lock tokens are ranked by
first appearance (`tok0`, `tok1`, ...) and a request names them that way;
the times in PROPFIND XML (getlastmodified, creationdate, a collection's
mtime getetag) become `T`; in JSON error bodies addresses become names and
fids ranks (`Norm`). Stored entries are held equal through `Norm` too.
Tolerance: byte equality after that normalization.

Left out of the mirror: nothing of `tests/test_webdav.py`.
"""

from __future__ import annotations

import hashlib
import re
from xml.etree import ElementTree as ET

import numpy as np
import pytest

from seaweedfs_tpu.server.httpd import http_request as ref_http_request
from seaweedfs_tpu.server.webdav import WebDavServer as RefWebDavServer
from seaweedfs_tpu_torch.server.httpd import http_request
from seaweedfs_tpu_torch.server.webdav import WebDavServer

from .test_torch_filer_meta import CHUNK, Norm, seeded, twin
from .test_torch_s3 import entries

NS = {"D": "DAV:"}
LOCKINFO = (b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
            b"<D:lockscope><D:exclusive/></D:lockscope>"
            b"<D:locktype><D:write/></D:locktype></D:lockinfo>")
COMPARED = ("DAV", "Allow", "MS-Author-Via", "Content-Type", "ETag", "Content-Range",
            "Content-Length", "Lock-Token")
TOKEN = re.compile(r"opaquelocktoken:[0-9a-f-]{36}")
TIMES = re.compile(r"<D:(getlastmodified|creationdate)>[^<]*</D:\1>")
MTIME_ETAG = re.compile(r'<D:getetag>"\d+(?:\.\d+)?"</D:getetag>')


class DavPair:
    """A JAX and a port WebDAV gateway; `both()` sends to each."""

    def __init__(self, sides, servers) -> None:
        self.sides = sides
        self.servers = servers
        self.norms = [Norm(s) for s in sides]
        self.tokens: list[dict[str, str]] = [{}, {}]  # side -> token -> name

    def _token_name(self, i: int, token: str) -> str:
        names = self.tokens[i]
        if token not in names:
            names[token] = f"tok{len(names)}"
        return names[token]

    def _real(self, i: int, text: str) -> str:
        """A request's header with token names and {url} made this side's."""
        text = text.replace("{url}", self.servers[i].url)
        for token, name in sorted(self.tokens[i].items(), key=lambda kv: -len(kv[1])):
            text = text.replace(name, token)
        return text

    def _norm(self, i: int, status: int, headers: dict, body: bytes):
        hdrs = {}
        for h in COMPARED:
            if h in headers:
                hdrs[h] = TOKEN.sub(lambda m: self._token_name(i, m.group(0)), headers[h])
        ctype = headers.get("Content-Type", "")
        if "xml" in ctype or "json" in ctype:
            text = TOKEN.sub(lambda m: self._token_name(i, m.group(0)), body.decode())
            text = MTIME_ETAG.sub('<D:getetag>"T"</D:getetag>', TIMES.sub(r"<D:\1>T</D:\1>", text))
            body = self.norms[i].text(text)
            hdrs.pop("Content-Length", None)  # the normalized body is compared
        return status, hdrs, body

    def both(self, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None):
        got = []
        for i, send in enumerate((ref_http_request, http_request)):
            hdrs = {k: self._real(i, v) for k, v in (headers or {}).items()}
            status, rh, rb = send(method, self.servers[i].url + path, body, hdrs)
            got.append(self._norm(i, status, rh, rb))
        want, port = got
        assert port == want, (method, path)
        return port

    def store(self, root: str) -> list:
        trees = [n(entries(s, root)) for n, s in zip(self.norms, self.sides)]
        assert trees[1] == trees[0] and trees[1], root
        return trees[1]


@pytest.fixture(scope="module")
def dav(tmp_path_factory):
    with twin(str(tmp_path_factory.mktemp("dav"))) as sides:
        servers = [RefWebDavServer(sides[0].filer.url, port=0),
                   WebDavServer(sides[1].filer.url, port=0)]
        for s in servers:
            s.start()
        try:
            yield DavPair(sides, servers)
        finally:
            for s in servers:
                s.stop()


def hrefs(body: bytes) -> list[str]:
    root = ET.fromstring(body)
    return [r.find("D:href", NS).text for r in root.findall("D:response", NS)]


def test_options_advertises_dav(dav):
    status, headers, _ = dav.both("OPTIONS", "/")
    assert status == 200
    assert "1, 2" in headers["DAV"]
    assert "PROPFIND" in headers["Allow"]


def test_mkcol_put_get_propfind(dav):
    assert dav.both("MKCOL", "/work")[0] == 201
    payload = seeded(4000, 100)
    status, _, _ = dav.both("PUT", "/work/file.bin", payload,
                            {"Content-Type": "application/octet-stream"})
    assert status == 201
    status, _, body = dav.both("GET", "/work/file.bin")
    assert status == 200 and body == payload
    status, headers, body = dav.both("GET", "/work/file.bin", headers={"Range": "bytes=100-199"})
    assert status == 206 and body == payload[100:200]
    assert headers["Content-Range"] == "bytes 100-199/4000"
    status, _, body = dav.both("PROPFIND", "/work", headers={"Depth": "1"})
    assert status == 207
    assert hrefs(body) == ["/work/", "/work/file.bin"]
    root = ET.fromstring(body)
    length = root.findall("D:response", NS)[1].find(".//D:getcontentlength", NS)
    assert int(length.text) == 4000
    status, headers, body = dav.both("HEAD", "/work/file.bin")
    assert status == 200 and headers["Content-Length"] == "4000" and body == b""
    dav.store("/work")


def test_propfind_depth_zero(dav):
    status, _, body = dav.both("PROPFIND", "/", headers={"Depth": "0"})
    assert status == 207
    assert len(ET.fromstring(body).findall("D:response", NS)) == 1
    assert dav.both("PROPFIND", "/no/such", headers={"Depth": "0"})[0] == 404


def test_proppatch_accepted_and_ignored(dav):
    dav.both("PUT", "/patched.txt", b"p")
    status, _, body = dav.both("PROPPATCH", "/patched.txt",
                               b'<?xml version="1.0"?><D:propertyupdate xmlns:D="DAV:"/>')
    assert status == 207 and hrefs(body) == ["/patched.txt"]
    assert dav.both("PROPPATCH", "/no-such.txt")[0] == 404


def test_move_and_copy(dav):
    dav.both("MKCOL", "/mv")
    dav.both("PUT", "/mv/a.txt", b"move me")
    status, _, _ = dav.both("MOVE", "/mv/a.txt", headers={"Destination": "{url}/mv/b.txt"})
    assert status in (201, 204)
    assert dav.both("GET", "/mv/a.txt")[0] == 404
    assert dav.both("GET", "/mv/b.txt")[2] == b"move me"
    status, _, _ = dav.both("COPY", "/mv/b.txt", headers={"Destination": "{url}/mv/c.txt"})
    assert status in (201, 204)
    assert dav.both("GET", "/mv/b.txt")[2] == b"move me"
    assert dav.both("GET", "/mv/c.txt")[2] == b"move me"
    status, _, _ = dav.both("COPY", "/mv/b.txt",
                            headers={"Destination": "{url}/mv/c.txt", "Overwrite": "F"})
    assert status == 412
    assert dav.both("COPY", "/mv/b.txt")[0] == 400  # no Destination
    assert dav.both("MOVE", "/mv/none.txt", headers={"Destination": "{url}/mv/d.txt"})[0] == 404
    dav.store("/mv")


def test_delete_collection(dav):
    dav.both("MKCOL", "/gone")
    dav.both("PUT", "/gone/x.txt", b"x")
    assert dav.both("DELETE", "/gone")[0] == 204
    assert dav.both("GET", "/gone/x.txt")[0] == 404
    assert dav.both("DELETE", "/gone")[0] == 404
    assert dav.both("MKCOL", "/mv")[0] == 405  # exists


def test_lock_unlock(dav):
    dav.both("PUT", "/locked.txt", b"v")
    status, headers, body = dav.both("LOCK", "/locked.txt", LOCKINFO)
    assert status == 200
    token = headers["Lock-Token"]
    assert re.fullmatch(r"<tok\d+>", token)
    assert "lockdiscovery" in body
    assert dav.both("UNLOCK", "/locked.txt", headers={"Lock-Token": token})[0] == 204


def test_locks_are_enforced(dav):
    """Class-2 semantics for real: second LOCK is 423, mutations without
    the token are 423, the token-holder may write, UNLOCK needs the token."""
    dav.both("PUT", "/guarded.txt", b"v1")
    status, headers, _ = dav.both("LOCK", "/guarded.txt", LOCKINFO)
    assert status == 200
    token = headers["Lock-Token"].strip("<>")
    assert dav.both("LOCK", "/guarded.txt", LOCKINFO)[0] == 423
    for method, extra in (("PUT", {}), ("DELETE", {}),
                          ("MOVE", {"Destination": "{url}/moved.txt"})):
        assert dav.both(method, "/guarded.txt", b"v2", extra)[0] == 423, method
    # the holder refreshes its own lock and may write
    assert dav.both("LOCK", "/guarded.txt", LOCKINFO, {"If": f"(<{token}>)"})[0] == 200
    assert dav.both("PUT", "/guarded.txt", b"v2", {"If": f"(<{token}>)"})[0] == 201
    status, _, _ = dav.both("UNLOCK", "/guarded.txt",
                            headers={"Lock-Token": "<opaquelocktoken:bogus>"})
    assert status == 409
    assert dav.both("UNLOCK", "/guarded.txt", headers={"Lock-Token": f"<{token}>"})[0] == 204
    assert dav.both("PUT", "/guarded.txt", b"v3")[0] == 201
    assert dav.both("GET", "/guarded.txt")[2] == b"v3"


def test_lock_expiry(dav):
    dav.both("PUT", "/expiring.txt", b"v1")
    for s in dav.servers:
        s.lock_timeout = 0.05
    try:
        assert dav.both("LOCK", "/expiring.txt", LOCKINFO)[0] == 200
        import time

        time.sleep(0.1)
        assert dav.both("PUT", "/expiring.txt", b"v2")[0] == 201  # expired: no block
    finally:
        for s in dav.servers:
            s.lock_timeout = 3600.0


def test_read_only_mode(dav):
    ro = [RefWebDavServer(dav.sides[0].filer.url, port=0, read_only=True),
          WebDavServer(dav.sides[1].filer.url, port=0, read_only=True)]
    for s in ro:
        s.start()
    pair = DavPair(dav.sides, ro)
    try:
        for method in ("PUT", "MKCOL", "DELETE", "COPY", "MOVE"):
            assert pair.both(method, "/nope.txt", b"x",
                             {"Destination": "{url}/n2.txt"})[0] == 403, method
        assert pair.both("PROPFIND", "/", headers={"Depth": "0"})[0] == 207
    finally:
        for s in ro:
            s.stop()


def test_collection_lock_covers_members(dav):
    """RFC 4918 depth-infinity: a lock on a collection guards every member,
    and recursive DELETE/MOVE of an ancestor respects locks held below."""
    dav.both("MKCOL", "/proj")
    dav.both("PUT", "/proj/doc.txt", b"v1")
    status, headers, _ = dav.both("LOCK", "/proj", LOCKINFO)
    assert status == 200
    token = headers["Lock-Token"].strip("<>")
    assert dav.both("PUT", "/proj/doc.txt", b"x")[0] == 423
    assert dav.both("DELETE", "/proj/doc.txt")[0] == 423
    assert dav.both("MKCOL", "/proj/sub")[0] == 423
    assert dav.both("LOCK", "/proj/doc.txt", LOCKINFO)[0] == 423
    assert dav.both("PUT", "/proj/doc.txt", b"v2", {"If": f"(<{token}>)"})[0] == 201
    dav.both("UNLOCK", "/proj", headers={"Lock-Token": f"<{token}>"})
    status, headers, _ = dav.both("LOCK", "/proj/doc.txt", LOCKINFO)
    assert status == 200
    child = headers["Lock-Token"].strip("<>")
    assert dav.both("DELETE", "/proj")[0] == 423
    assert dav.both("MOVE", "/proj", headers={"Destination": "{url}/proj2"})[0] == 423
    assert dav.both("DELETE", "/proj", headers={"If": f"(<{child}>)"})[0] == 204
    # the lock went with the resource
    assert dav.both("PUT", "/proj/doc.txt", b"v3")[0] == 201


def seeded_tree(rng: np.random.Generator, root: str, depth: int) -> list[tuple[str, bytes]]:
    """Files under root: 1-4 a directory, sizes log-uniform 1 B-5 chunks."""
    out = []
    for f in range(int(rng.integers(1, 5))):
        n = int(np.exp(rng.uniform(0, np.log(5 * CHUNK))))
        out.append((f"{root}/f{f}.bin", rng.bytes(n)))
    if depth:
        for d in range(int(rng.integers(1, 3))):
            out += seeded_tree(rng, f"{root}/d{d}", depth - 1)
    return out


def put_tree(dav: DavPair, files: list) -> None:
    made = set()
    for path, body in files:
        parts = path.split("/")[1:-1]
        for k in range(1, len(parts) + 1):
            d = "/" + "/".join(parts[:k])
            if d not in made:
                made.add(d)
                assert dav.both("MKCOL", d)[0] == 201
        assert dav.both("PUT", path, body)[0] == 201


@pytest.mark.parametrize("seed", range(3))
def test_propfind_tree_xml_equal_reference(dav, seed):
    """The PROPFIND XML of every directory of a seeded tree, equal; each
    file's getetag is hashlib's MD5 of its body."""
    files = seeded_tree(np.random.default_rng([seed, 41]), f"/tree{seed}", 2)
    put_tree(dav, files)
    bodies = dict(files)
    dirs = sorted({p.rsplit("/", 1)[0] for p, _ in files})
    listed = set()
    for d in dirs:
        status, _, body = dav.both("PROPFIND", d, headers={"Depth": "1"})
        assert status == 207
        for r in ET.fromstring(body).findall("D:response", NS):
            href = r.find("D:href", NS).text
            if href in bodies:
                listed.add(href)
                etag = r.find(".//D:getetag", NS).text
                assert etag == f'"{hashlib.md5(bodies[href]).hexdigest()}"'
                length = int(r.find(".//D:getcontentlength", NS).text)
                assert length == len(bodies[href])
    assert listed == set(bodies)
    dav.store(f"/tree{seed}")


@pytest.mark.parametrize("seed", range(2))
def test_copy_move_tree_equal_reference(dav, seed):
    """COPY of a seeded tree, then MOVE of the copy: the bodies are equal at
    the new paths and gone from the old, the stored entries equal."""
    root = f"/cm{seed}"
    files = seeded_tree(np.random.default_rng([seed, 43]), f"{root}/src", 2)
    put_tree(dav, files)
    assert dav.both("COPY", f"{root}/src",
                    headers={"Destination": "{url}" + f"{root}/copy"})[0] == 201
    assert dav.both("MOVE", f"{root}/copy",
                    headers={"Destination": "{url}" + f"{root}/moved"})[0] == 201
    for path, body in files:
        assert dav.both("GET", path)[2] == body
        assert dav.both("GET", path.replace("/src", "/moved", 1))[2] == body
        assert dav.both("GET", path.replace("/src", "/copy", 1))[0] == 404
    dav.store(root)


def test_getetag_of_chunked_bodies(dav):
    """Bodies that span chunks: the getetag the port filer's hash service
    gave is hashlib's MD5 of the body, as the JAX filer's is."""
    dav.both("MKCOL", "/etag")
    for i, n in enumerate((CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 17)):
        body = seeded(n, 200 + i)
        dav.both("PUT", f"/etag/{i}.bin", body)
        status, _, xml = dav.both("PROPFIND", f"/etag/{i}.bin", headers={"Depth": "0"})
        etag = ET.fromstring(xml).find(".//D:getetag", NS).text
        assert etag == f'"{hashlib.md5(body).hexdigest()}"'
        assert dav.both("GET", f"/etag/{i}.bin")[1]["ETag"] == etag
    dav.store("/etag")
