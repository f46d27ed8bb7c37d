"""The port's cloud replication sinks held against the JAX package's.

Each fake implements the provider's wire protocol server-side, as the JAX
package's own contract tests do: Azure SharedKey verification, the GCS
OAuth2 JWT grant with real RS256 verification, and B2's auth, upload-URL
and SHA-1 handshake (`weed/replication/sink/{azuresink,gcssink,b2sink}`
are the behaviour specs). The port's sinks run end to end against them,
and every fake records the requests it received: the JAX sink and the port
sink make the same calls against one fake, reset between them, under one
frozen clock, and the recorded requests (method, path, headers and body)
must be equal, byte for byte.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from seaweedfs_tpu.replication import Replicator as RefReplicator
from seaweedfs_tpu.replication import cloud_sinks as ref_sinks
from seaweedfs_tpu_torch.replication import Replicator
from seaweedfs_tpu_torch.replication import cloud_sinks

AZ_ACCOUNT = "testaccount"
AZ_KEY = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()
FROZEN_DATE = "Thu, 30 Jul 2026 01:02:03 GMT"
FROZEN_TIME = 1_785_373_323.0  # 2026-07-30 01:02:03 UTC


def _start(handler_cls):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv) -> None:
    srv.shutdown()
    srv.server_close()


class _QuietHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    log: list | None = None  # set per fake: every request received

    def log_message(self, *a):
        pass

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        if self.log is not None:
            self.log.append((self.command, self.path, sorted(self.headers.items()), body))
        return body

    def _reply(self, status: int, body: bytes = b"", ctype="application/json"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


# --- Azure -----------------------------------------------------------------------------
@pytest.fixture()
def fake_azure():
    blobs: dict[str, bytearray] = {}
    rejected: list[str] = []
    log: list = []

    class Handler(_QuietHandler):
        def _verify(self) -> bool:
            parsed = urllib.parse.urlparse(self.path)
            query = dict(urllib.parse.parse_qsl(parsed.query))
            # recomputed from the raw request: any drift between what the
            # client signed and what it sent fails here
            headers = {
                k: v for k, v in self.headers.items()
                if k.lower().startswith("x-ms-")
                or k.lower() in ("content-length", "content-type")
            }
            expect = cloud_sinks.azure_sharedkey_signature(
                AZ_ACCOUNT, AZ_KEY, self.command, headers, parsed.path, query)
            ok = self.headers.get("Authorization") == expect
            if not ok:
                rejected.append(self.path)
            return ok

        def do_PUT(self):
            body = self._body()
            if not self._verify():
                return self._reply(403)
            parsed = urllib.parse.urlparse(self.path)
            blob = urllib.parse.unquote(parsed.path).split("/", 2)[2]
            query = dict(urllib.parse.parse_qsl(parsed.query))
            if query.get("comp") == "appendblock":
                if blob not in blobs:
                    return self._reply(404)
                blobs[blob].extend(body)
                return self._reply(201)
            if self.headers.get("x-ms-blob-type") != "AppendBlob":
                return self._reply(400)
            blobs[blob] = bytearray()
            return self._reply(201)

        def do_DELETE(self):
            self._body()
            if not self._verify():
                return self._reply(403)
            blob = urllib.parse.unquote(urllib.parse.urlparse(self.path).path).split("/", 2)[2]
            if blob in blobs:
                del blobs[blob]
                return self._reply(202)
            return self._reply(404)

    Handler.log = log
    srv, url = _start(Handler)
    try:
        yield blobs, rejected, url, log
    finally:
        _stop(srv)


def test_azure_create_append_delete_signed(fake_azure):
    blobs, rejected, url, _ = fake_azure
    sink = cloud_sinks.AzureSink(AZ_ACCOUNT, AZ_KEY, "ctr", endpoint=url)
    sink.create_entry("/docs/a bin.dat", {}, b"hello " * 100)
    assert bytes(blobs["docs/a bin.dat"]) == b"hello " * 100
    assert rejected == []
    sink.update_entry("/docs/a bin.dat", {}, b"v2")
    assert bytes(blobs["docs/a bin.dat"]) == b"v2"
    sink.delete_entry("/docs/a bin.dat", is_directory=False)
    assert blobs == {}
    sink.delete_entry("/gone.txt", is_directory=False)  # a 404 delete is tolerated
    sink.create_entry("/docs", {"is_directory": True}, None)  # directories are implicit
    assert blobs == {}


def test_azure_large_file_appends_in_blocks(fake_azure):
    blobs, rejected, url, _ = fake_azure
    assert cloud_sinks._APPEND_BLOCK == ref_sinks._APPEND_BLOCK
    sink = cloud_sinks.AzureSink(AZ_ACCOUNT, AZ_KEY, "ctr", endpoint=url)
    payload = bytes(range(256)) * ((cloud_sinks._APPEND_BLOCK + 512) // 256)
    rep = Replicator(sink, read_content=lambda p, e: payload)
    rep.replicate({"old_entry": None, "new_entry": {"full_path": "/big.bin"}})
    assert bytes(blobs["big.bin"]) == payload
    rep.replicate({"old_entry": {"full_path": "/big.bin"},
                   "new_entry": {"full_path": "/big2.bin"}})  # rename: delete + create
    assert "big.bin" not in blobs and bytes(blobs["big2.bin"]) == payload
    assert rejected == []


def test_azure_sharedkey_pinned_vector():
    """The string-to-sign written out by hand per the Storage Services
    auth spec and HMAC'd apart from the implementation."""
    headers = {
        "x-ms-date": FROZEN_DATE,
        "x-ms-version": "2021-08-06",
        "x-ms-blob-type": "AppendBlob",
        "content-length": "0",
        "content-type": "application/octet-stream",
    }
    expected_to_sign = (
        "PUT\n" "\n" "\n" "\n" "\n"   # VERB, encoding, language, length ("0": empty), MD5
        "application/octet-stream\n"  # Content-Type
        "\n" "\n\n\n\n" "\n"          # Date, the four conditionals, Range
        "x-ms-blob-type:AppendBlob\n"
        f"x-ms-date:{FROZEN_DATE}\n"
        "x-ms-version:2021-08-06\n"
        "/testaccount/ctr/a%20b.txt\n"
        "comp:appendblock"
    )
    digest = hmac.new(base64.b64decode(AZ_KEY), expected_to_sign.encode(),
                      hashlib.sha256).digest()
    pinned = f"SharedKey testaccount:{base64.b64encode(digest).decode()}"
    args = ("testaccount", AZ_KEY, "PUT", headers, "/ctr/a%20b.txt", {"comp": "appendblock"})
    assert cloud_sinks.azure_sharedkey_signature(*args) == pinned
    assert ref_sinks.azure_sharedkey_signature(*args) == pinned


@pytest.mark.parametrize("method,headers,path,query", [
    ("GET", {"x-ms-date": FROZEN_DATE, "Range": "bytes=0-9"}, "/c/x", {}),
    ("DELETE", {"x-ms-delete-snapshots": "include", "x-ms-date": FROZEN_DATE}, "/c/d/", {}),
    ("PUT", {"content-length": "7", "content-type": "text/plain", "x-ms-version": "v"},
     "/c/%E2%82%AC", {"comp": "appendblock", "B": "2"}),
])
def test_azure_signature_equals_reference(method, headers, path, query):
    args = (AZ_ACCOUNT, AZ_KEY, method, headers, path, query)
    assert cloud_sinks.azure_sharedkey_signature(*args) == \
        ref_sinks.azure_sharedkey_signature(*args)


def test_azure_wrong_key_rejected(fake_azure):
    blobs, rejected, url, _ = fake_azure
    bad = base64.b64encode(b"wrong-key-wrong-key-wrong-key-!!").decode()
    sink = cloud_sinks.AzureSink(AZ_ACCOUNT, bad, "ctr", endpoint=url)
    with pytest.raises(cloud_sinks.CloudSinkError) as err:
        sink.create_entry("/x.txt", {}, b"data")
    assert err.value.status == 403
    assert rejected and blobs == {}


def test_azure_requests_equal_reference(fake_azure, monkeypatch):
    blobs, rejected, url, log = fake_azure
    monkeypatch.setattr(email.utils, "formatdate", lambda *a, **k: FROZEN_DATE)
    payload = bytes(range(256)) * ((cloud_sinks._APPEND_BLOCK + 300) // 256)
    sent = []
    for sinks, rep_cls in ((ref_sinks, RefReplicator), (cloud_sinks, Replicator)):
        log.clear()
        blobs.clear()
        sink = sinks.AzureSink(AZ_ACCOUNT, AZ_KEY, "ctr", endpoint=url)
        rep = rep_cls(sink, read_content=lambda p, e: payload)
        rep.replicate({"old_entry": None, "new_entry": {"full_path": "/d/big €.bin"}})
        rep.replicate({"old_entry": {"full_path": "/d/big €.bin"},
                       "new_entry": {"full_path": "/d/moved.bin"}})
        sink.create_entry("/d/small.txt", {"attributes": {"mime": "text/plain"}}, b"s")
        sink.delete_entry("/d", is_directory=True)
        sent.append((list(log), {k: bytes(v) for k, v in blobs.items()}))
    assert rejected == []
    assert len(sent[0][0]) == 10  # 3 + 1 + 3 for the rename + 2 + 1
    assert sent[1] == sent[0]


# --- GCS -------------------------------------------------------------------------------
@pytest.fixture()
def fake_gcs():
    pytest.importorskip("cryptography", reason="GCS JWT grant needs RSA")
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption()).decode()
    pub = key.public_key()
    objects: dict[str, bytes] = {}
    state = {"tokens_issued": 0}
    log: list = []

    class Handler(_QuietHandler):
        def do_POST(self):
            body = self._body()
            if self.path == "/token":
                form = dict(urllib.parse.parse_qsl(body.decode()))
                h, c, s = form["assertion"].split(".")
                pub.verify(base64.urlsafe_b64decode(s + "=="), f"{h}.{c}".encode(),
                           padding.PKCS1v15(), hashes.SHA256())  # raises on a bad RS256
                claims = json.loads(base64.urlsafe_b64decode(c + "=="))
                assert claims["iss"] == "svc@proj.iam.gserviceaccount.com"
                state["tokens_issued"] += 1
                return self._reply(200, json.dumps(
                    {"access_token": f"tok-{state['tokens_issued']}",
                     "expires_in": 3600}).encode())
            if self.path.startswith("/upload/storage/v1/b/buck/o"):
                if self.headers.get("Authorization", "").removeprefix("Bearer ") != \
                        f"tok-{state['tokens_issued']}":
                    return self._reply(401)
                q = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(self.path).query))
                assert q["uploadType"] == "media"
                objects[urllib.parse.unquote(q["name"])] = body
                return self._reply(200, b"{}")
            return self._reply(404)

        def do_DELETE(self):
            self._body()
            if not self.path.startswith("/storage/v1/b/buck/o/"):
                return self._reply(404)
            name = urllib.parse.unquote(self.path.split("/o/", 1)[1])
            if objects.pop(name, None) is None:
                return self._reply(404)
            return self._reply(204)

    Handler.log = log
    srv, url = _start(Handler)
    creds = {"client_email": "svc@proj.iam.gserviceaccount.com", "private_key": pem,
             "token_uri": f"{url}/token"}
    try:
        yield creds, objects, state, url, log
    finally:
        _stop(srv)


def test_gcs_jwt_grant_and_object_lifecycle(fake_gcs):
    creds, objects, state, url, _ = fake_gcs
    sink = cloud_sinks.GcsSink("buck", cloud_sinks.service_account_token_provider(creds),
                               endpoint=url)
    sink.create_entry("/a/b c.txt", {"attributes": {"mime": "text/plain"}}, b"gcs-data")
    assert objects["a/b c.txt"] == b"gcs-data"
    assert state["tokens_issued"] == 1
    sink.update_entry("/a/b c.txt", {}, b"v2")
    assert objects["a/b c.txt"] == b"v2"
    assert state["tokens_issued"] == 1  # cached until expiry
    sink.delete_entry("/a/b c.txt", is_directory=False)
    assert objects == {}
    sink.delete_entry("/a", is_directory=True)  # the marker delete: a 404 is fine


def test_gcs_requests_equal_reference(fake_gcs, monkeypatch):
    """The JWT's iat and exp come from the frozen clock; PKCS#1 v1.5
    signing is deterministic, so the grant's body is equal too."""
    creds, objects, state, url, log = fake_gcs
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)
    sent = []
    for sinks in (ref_sinks, cloud_sinks):
        log.clear()
        objects.clear()
        state["tokens_issued"] = 0
        sink = sinks.GcsSink("buck", sinks.service_account_token_provider(creds), endpoint=url)
        sink.create_entry("/a/b c.txt", {"attributes": {"mime": "text/plain"}}, b"gcs-data")
        sink.create_entry("/a/raw.bin", {}, b"\x00\x01")
        sink.delete_entry("/a/b c.txt", is_directory=False)
        sink.delete_entry("/a", is_directory=True)
        sent.append((list(log), dict(objects)))
    assert len(sent[0][0]) == 5
    assert sent[1] == sent[0]


# --- B2 --------------------------------------------------------------------------------
@pytest.fixture()
def fake_b2():
    files: dict[str, list[tuple[str, bytes]]] = {}  # name -> [(id, data)]
    state = {"auth_calls": 0, "upload_urls": 0, "next_id": 0,
             "expire_first_upload_url": False}
    log: list = []

    class Handler(_QuietHandler):
        def do_GET(self):
            self._body()
            if self.path == "/b2api/v2/b2_authorize_account":
                expect = base64.b64encode(b"acct:app-key").decode()
                if self.headers.get("Authorization") != f"Basic {expect}":
                    return self._reply(401)
                state["auth_calls"] += 1
                port = self.server.server_address[1]
                return self._reply(200, json.dumps({
                    "accountId": "acct", "apiUrl": f"http://127.0.0.1:{port}",
                    "authorizationToken": "api-tok"}).encode())
            return self._reply(404)

        def do_POST(self):
            body = self._body()
            if self.path.startswith("/b2api/v2/"):
                if self.headers.get("Authorization") != "api-tok":
                    return self._reply(401)
                call = self.path.rsplit("/", 1)[1]
                req = json.loads(body)
                if call == "b2_list_buckets":
                    return self._reply(200, json.dumps({"buckets": [
                        {"bucketName": "bkt", "bucketId": "bkt-id"}]}).encode())
                if call == "b2_get_upload_url":
                    assert req["bucketId"] == "bkt-id"
                    state["upload_urls"] += 1
                    n = state["upload_urls"]
                    port = self.server.server_address[1]
                    return self._reply(200, json.dumps({
                        "uploadUrl": f"http://127.0.0.1:{port}/upload/{n}",
                        "authorizationToken": f"up-tok-{n}"}).encode())
                if call == "b2_list_file_versions":
                    out = []
                    for name in sorted(files):
                        if name >= req["startFileName"]:
                            out += [{"fileName": name, "fileId": fid} for fid, _ in files[name]]
                    return self._reply(200, json.dumps({"files": out}).encode())
                if call == "b2_delete_file_version":
                    vs = [v for v in files.get(req["fileName"], []) if v[0] != req["fileId"]]
                    if vs:
                        files[req["fileName"]] = vs
                    else:
                        files.pop(req["fileName"], None)
                    return self._reply(200, b"{}")
                return self._reply(400)
            if self.path.startswith("/upload/"):
                n = int(self.path.rsplit("/", 1)[1])
                if (state["expire_first_upload_url"] and n == 1) or \
                        self.headers.get("Authorization") != f"up-tok-{n}":
                    return self._reply(401)
                if hashlib.sha1(body).hexdigest() != self.headers.get("X-Bz-Content-Sha1"):
                    return self._reply(400)
                name = urllib.parse.unquote(self.headers["X-Bz-File-Name"])
                state["next_id"] += 1
                files.setdefault(name, []).append((f"id-{state['next_id']}", body))
                return self._reply(200, b"{}")
            return self._reply(404)

    Handler.log = log
    srv, url = _start(Handler)
    try:
        yield files, state, url, log
    finally:
        _stop(srv)


def test_b2_auth_upload_delete_versions(fake_b2):
    files, state, url, _ = fake_b2
    sink = cloud_sinks.B2Sink("acct", "app-key", "bkt", endpoint=url)
    sink.create_entry("/p/x.txt", {}, b"one")
    sink.create_entry("/p/x.txt", {}, b"two")  # a second version
    assert [d for _, d in files["p/x.txt"]] == [b"one", b"two"]
    assert state["auth_calls"] == 1  # the session is cached
    sink.delete_entry("/p/x.txt", is_directory=False)  # every version goes
    assert files == {}


def test_b2_expired_upload_url_retried(fake_b2):
    files, state, url, _ = fake_b2
    sink = cloud_sinks.B2Sink("acct", "app-key", "bkt", endpoint=url)
    state["expire_first_upload_url"] = True
    sink.create_entry("/y.bin", {}, b"payload")
    assert [d for _, d in files["y.bin"]] == [b"payload"]
    assert state["upload_urls"] == 2  # the first URL answered 401; the sink fetched another


@pytest.mark.parametrize("expire", [False, True])
def test_b2_requests_equal_reference(fake_b2, expire):
    files, state, url, log = fake_b2
    sent = []
    for sinks in (ref_sinks, cloud_sinks):
        log.clear()
        files.clear()
        state.update(auth_calls=0, upload_urls=0, next_id=0, expire_first_upload_url=expire)
        sink = sinks.B2Sink("acct", "app-key", "bkt", endpoint=url)
        sink.create_entry("/p/x y.txt", {"attributes": {"mime": "text/plain"}}, b"one")
        sink.create_entry("/p/x y.txt", {}, b"two")
        sink.create_entry("/p/dir", {"is_directory": True}, None)
        sink.delete_entry("/p/x y.txt", is_directory=False)
        sent.append((list(log), dict(files), dict(state)))
    assert sent[1] == sent[0]
    assert sent[0][2]["upload_urls"] == (2 if expire else 1)
