"""The port's S3 gateway held against the JAX package's, request for request,
case for case with `tests/test_s3.py` (auth, buckets, objects, listing,
multipart, tagging, the circuit breaker), plus unit parity of the signing
and framing helpers on seeded inputs.

`s3_twin()` starts one `S3Server` on each side of
`tests/test_torch_filer_meta.py::twin` (a JAX cluster with its native front
door off and a port cluster on `device="cpu"`, both filers at 4 KiB
chunks). `S3Pair` sends the same request to both gateways, one side at a
time, each through its own package's `S3Client`, and holds the answers
equal: the status, the ETag, Content-Range, Content-Length, Content-Type,
x-amz-version-id, delete-marker and CORS headers, x-amz-meta-* headers,
and the body. Stored entries (`?metadata=true` under a bucket) are held
equal the same way at the end of the tests that write.

`S3Norm` extends `Norm` (addresses named, fids ranked, filer stamps
dropped): the IDs each side generates are ranked by first appearance
(`UploadId`, `VersionId`, `RequestId`, `UserId`, `PolicyId`, IAM access
keys and secrets, as tokens such as `upload0x`), `LastModified`-style
times become `TIME`, and `Last-Modified` is not compared. Tests pass
tokens back in later requests; each side maps them to its own IDs.
Tolerance: byte equality after that normalization.
"""

from __future__ import annotations

import contextlib
import hashlib
import re
import time
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu.iamapi import IamServer as RefIamServer
from seaweedfs_tpu.s3api import S3Client as RefS3Client
from seaweedfs_tpu.s3api import S3Server as RefS3Server
from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu.s3api import circuit_breaker as ref_cb
from seaweedfs_tpu.s3api.sigv4_client import S3Error as RefS3Error
from seaweedfs_tpu.server.httpd import http_request as ref_http_request
from seaweedfs_tpu_torch.iamapi import IamServer
from seaweedfs_tpu_torch.s3api import S3Client, S3Server
from seaweedfs_tpu_torch.s3api import auth as port_auth
from seaweedfs_tpu_torch.s3api import circuit_breaker as port_cb
from seaweedfs_tpu_torch.s3api.sigv4_client import S3Error
from seaweedfs_tpu_torch.server.httpd import get_json, http_request

from .test_torch_filer_meta import CHUNK, Norm, seeded, twin

IDENTITIES = {
    "identities": [
        {
            "name": "admin",
            "credentials": [{"accessKey": "adminKey", "secretKey": "adminSecret"}],
            "actions": ["Admin"],
        },
        {
            "name": "reader",
            "credentials": [{"accessKey": "readKey", "secretKey": "readSecret"}],
            "actions": ["Read", "List"],
        },
        {
            "name": "scoped",
            "credentials": [{"accessKey": "scopedKey", "secretKey": "scopedSecret"}],
            "actions": ["Read:onlybucket", "Write:onlybucket", "List:onlybucket"],
        },
        {
            "name": "tagonly",
            "credentials": [{"accessKey": "tagKey", "secretKey": "tagSecret"}],
            "actions": ["Tagging"],
        },
    ]
}
ADMIN = ("adminKey", "adminSecret")

# response headers held equal (Last-Modified, Date, Server and the JAX
# service's trace header are not)
COMPARED = ("ETag", "Content-Range", "Content-Length", "Content-Type", "Location",
            "x-amz-version-id", "x-amz-delete-marker", "Allow", "Vary",
            "Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
            "Access-Control-Allow-Headers", "Access-Control-Expose-Headers",
            "Access-Control-Max-Age")
LEARNED = (  # IDs a side generates, learned from the element that names them
    ("upload", re.compile(r"<UploadId>([0-9a-f]{32})</UploadId>")),
    ("request", re.compile(r"<RequestId>([0-9a-f-]{36})</RequestId>")),
    ("user", re.compile(r"<UserId>([0-9a-f]{16})</UserId>")),
    ("policy", re.compile(r"<PolicyId>([0-9a-f]{16})</PolicyId>")),
    ("secret", re.compile(r"<SecretAccessKey>([A-Za-z0-9_-]+)</SecretAccessKey>")),
)
VERSION_ID = re.compile(r"\b\d{20}\.[0-9a-f]{8}\b")
ACCESS_KEY = re.compile(r"\bAKID[0-9A-F]{16}\b")
AMZ_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.000Z")


class S3Norm(Norm):
    """`Norm` plus the gateway's generated IDs and times."""

    def __init__(self, side, servers) -> None:
        super().__init__(side)
        for name, url in servers.items():
            self.names[url.split("//")[-1]] = name
        self.token: dict[str, str] = {}
        self.real: dict[str, str] = {}

    def rank(self, kind: str, value: str) -> str:
        if value not in self.token:
            n = sum(t.startswith(kind) for t in self.real)
            self.token[value] = f"{kind}{n}x"
            self.real[self.token[value]] = value
        return self.token[value]

    def learn(self, s: str) -> None:
        for kind, rx in LEARNED:
            for m in rx.finditer(s):
                self.rank(kind, m.group(1))
        for m in VERSION_ID.finditer(s):
            self.rank("vid", m.group(0))
        for m in ACCESS_KEY.finditer(s):
            self.rank("akid", m.group(0))

    def text(self, s: str) -> str:
        s = super().text(s)
        self.learn(s)
        for value in sorted(self.token, key=len, reverse=True):
            s = s.replace(value, self.token[value])
        return AMZ_TIME.sub("TIME", s)

    def unmap(self, obj):
        """Tokens in a request back to this side's own IDs."""
        if isinstance(obj, str):
            for tok in sorted(self.real, key=len, reverse=True):
                obj = obj.replace(tok, self.real[tok])
            return obj
        if isinstance(obj, bytes):
            return self.unmap(obj.decode("latin-1")).encode("latin-1")
        if isinstance(obj, dict):
            return {self.unmap(k): self.unmap(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.unmap(v) for v in obj)
        return obj

    def body(self, body: bytes):
        if body[:1] == b"<" or body[:1] == b"{":
            try:
                return self.text(body.decode())
            except UnicodeDecodeError:
                pass
        return body

    def headers(self, headers: dict) -> dict:
        return {k: self.text(v) for k, v in headers.items()
                if k in COMPARED or k.lower().startswith("x-amz-meta-")}

    def response(self, resp) -> tuple:
        status, headers, body = resp
        return status, self.headers(headers), self.body(body)


class S3Side:
    """One side's gateway (and IAM server), its client class and normalizer."""

    def __init__(self, side, s3, iam, client_cls, error_cls, request_fn) -> None:
        self.side = side
        self.s3 = s3
        self.iam = iam
        self.client_cls = client_cls
        self.error_cls = error_cls
        self.http_request = request_fn
        servers = {"s3": s3.url}
        if iam is not None:
            servers["iam"] = iam.url
        self.norm = S3Norm(side, servers)

    @property
    def name(self) -> str:
        return self.side.name

    def client(self, creds=ADMIN, **kw):
        return self.client_cls(self.s3.url, *self.norm.unmap(tuple(creds)), **kw)


class S3Pair:
    """The same calls on both sides; the answers held equal."""

    def __init__(self, ref: S3Side, port: S3Side) -> None:
        self.ref = ref
        self.port = port
        self.sides = (ref, port)

    def each(self, fn):
        """fn(side) on both sides -> (ref answer, port answer), raw."""
        return fn(self.ref), fn(self.port)

    def call(self, fn):
        """fn(side) -> (status, headers, body) on both; equal after
        normalization; the port's normalized answer."""
        want, got = (s.norm.response(fn(s)) for s in self.sides)
        assert got == want
        return got

    def request(self, method, path, query=None, body=b"", headers=None, creds=ADMIN):
        return self.call(lambda s: s.client(creds).request(
            method, s.norm.unmap(path), s.norm.unmap(query), s.norm.unmap(body),
            s.norm.unmap(headers)))

    def raw(self, method, path, body=None, headers=None):
        """An unsigned request (the JAX side through the JAX client helper)."""
        return self.call(lambda s: s.http_request(
            method, s.s3.url + s.norm.unmap(path), s.norm.unmap(body),
            s.norm.unmap(headers)))

    def api(self, name, *args, creds=ADMIN, **kw):
        """An S3Client method on both sides: equal values, or equal errors
        (re-raised as the port's S3Error)."""
        out = []
        for s in self.sides:
            fn = getattr(s.client(creds), name)
            try:
                value = fn(*s.norm.unmap(args), **s.norm.unmap(kw))
                if name == "head_object" and value is not None:
                    value = s.norm.headers(value)
                if name == "create_multipart":  # the bare UploadId
                    s.norm.rank("upload", value)
                out.append(("ok", s.norm(value) if not isinstance(value, bytes) else value))
            except s.error_cls as e:
                out.append(("err", e.status, e.code, s.norm.text(e.message)))
        want, got = out
        assert got == want, name
        if got[0] == "err":
            raise S3Error(*got[1:])
        return got[1]

    def entry(self, path: str) -> dict:
        """One entry's `?metadata=true` on both sides, normalized; held equal."""
        got = [s.norm(get_json(f"{s.side.filer.url}{urllib.parse.quote(path)}?metadata=true"))
               for s in self.sides]
        assert got[1] == got[0]
        return got[1]

    def store(self, root: str) -> list:
        """Every entry under root on both sides, normalized; held equal."""
        trees = []
        for s in self.sides:
            trees.append(s.norm(entries(s.side, root)))
        want, got = trees
        assert got == want and got, root
        return got


def entries(side, root: str) -> list:
    """`?metadata=true` of every entry under root, depth first."""
    out = []
    status, _, _ = http_request("GET", f"{side.filer.url}{urllib.parse.quote(root)}"
                                "?metadata=true")
    if status != 200:
        return out
    listing = get_json(f"{side.filer.url}{urllib.parse.quote(root)}?limit=1000")
    for e in listing.get("Entries") or []:
        out.append(get_json(f"{side.filer.url}{urllib.parse.quote(e['FullPath'])}"
                            "?metadata=true"))
        if e["IsDirectory"]:
            out += entries(side, e["FullPath"])
    return out


@contextlib.contextmanager
def s3_twin(tmp, config=None, iam: bool = False):
    """A JAX and a port gateway (and IAM server) over `twin()`."""
    started = []
    with twin(tmp) as (ref, port):
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("SEAWEEDFS_TPU_DISABLE_FASTLANE", "1")
                ref_s3 = RefS3Server(ref.filer.url, port=0, config=config)
                ref_s3.start()
                started.append(ref_s3)
                ref_iam = None
                if iam:
                    ref_iam = RefIamServer(ref.filer.url, port=0)
                    ref_iam.start()
                    started.append(ref_iam)
            port_s3 = S3Server(port.filer.url, port=0, config=config)
            port_s3.start()
            started.append(port_s3)
            port_iam = None
            if iam:
                port_iam = IamServer(port.filer.url, port=0)
                port_iam.start()
                started.append(port_iam)
            yield S3Pair(
                S3Side(ref, ref_s3, ref_iam, RefS3Client, RefS3Error, ref_http_request),
                S3Side(port, port_s3, port_iam, S3Client, S3Error, http_request))
        finally:
            for server in reversed(started):
                server.stop()


def bucket_name(request) -> str:
    return "t-" + re.sub(r"[^a-z0-9]+", "-", request.node.name.lower()).strip("-")[:50]


def make_bucket(s3: S3Pair, name: str):
    s3.api("create_bucket", name)
    return name


def drop_bucket(s3: S3Pair, name: str) -> None:
    """Best-effort cleanup, the same on both sides."""
    try:
        listing = s3.api("list_objects", name)
        if listing["contents"]:
            s3.api("delete_objects", name, [c["key"] for c in listing["contents"]])
        s3.api("delete_bucket", name)
    except (S3Error, AssertionError):
        pass


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    with s3_twin(str(tmp_path_factory.mktemp("s3")), IDENTITIES) as pair:
        yield pair


@pytest.fixture()
def bucket(s3, request):
    name = make_bucket(s3, bucket_name(request))
    yield name
    drop_bucket(s3, name)


# --- unit parity on seeded inputs ---------------------------------------------------
def _seeded_request(rng):
    """A method, path, query pairs, headers and signed header names."""
    chars = list("abcdefghijklmnopqrstuvwxyzABC0123456789-_.~ /%+=&é")
    word = lambda n: "".join(rng.choice(chars, size=n))  # noqa: E731
    path = "/" + "/".join(word(int(rng.integers(1, 12))) for _ in range(int(rng.integers(1, 4))))
    query = [(word(int(rng.integers(1, 8))), word(int(rng.integers(0, 8))))
             for _ in range(int(rng.integers(0, 5)))]
    if rng.random() < 0.3:
        query.append(("X-Amz-Signature", word(8)))
    headers = {"host": "127.0.0.1:8333", "x-amz-date": "20261017T120000Z",
               "x-amz-content-sha256": hashlib.sha256(word(16).encode()).hexdigest(),
               "x-amz-meta-note": "  two   spaces  " + word(5)}
    signed = sorted(rng.choice(sorted(headers), size=int(rng.integers(1, 5)), replace=False))
    method = str(rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"]))
    return method, path, query, headers, list(signed)


@pytest.mark.parametrize("seed", range(8))
def test_sigv4_helpers_equal_reference(seed):
    """canonical_request, signing_key and string_to_sign on seeded inputs."""
    rng = np.random.default_rng([seed, 1])
    for _ in range(16):
        method, path, query, headers, signed = _seeded_request(rng)
        payload = str(rng.choice(["UNSIGNED-PAYLOAD", hashlib.sha256(rng.bytes(9)).hexdigest()]))
        args = (method, path, query, headers, signed, payload)
        assert port_auth.canonical_request(*args) == ref_auth.canonical_request(*args)
        assert port_auth.canonical_query(query) == ref_auth.canonical_query(query)
        canon = ref_auth.canonical_request(*args)
        scope = f"2026101{seed}/us-east-1/s3/aws4_request"
        assert port_auth.string_to_sign("20261017T120000Z", scope, canon) == \
            ref_auth.string_to_sign("20261017T120000Z", scope, canon)
        secret = rng.bytes(20).hex()
        key = ("20261017", str(rng.choice(["us-east-1", "eu-west-2"])),
               str(rng.choice(["s3", "iam"])))
        assert port_auth.signing_key(secret, *key) == ref_auth.signing_key(secret, *key)


@pytest.fixture()
def frozen_clock(monkeypatch):
    """One clock for both modules' presigned-expiry checks."""
    now = [1_800_000_000.0]
    for mod in (ref_auth, port_auth):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    return now


def _iams():
    cfg = {"identities": [{"name": "v2", "credentials": [{"accessKey": "AK", "secretKey": "SK"}],
                           "actions": ["Admin"]}]}
    out = []
    for mod in (ref_auth, port_auth):
        iam = mod.IdentityAccessManagement()
        iam.load_config(cfg)
        out.append(iam)
    return out


def _outcome(fn):
    try:
        return ("ok", fn().name)
    except Exception as e:  # the S3ApiError of each package, compared by field
        return ("err", type(e).__name__, getattr(e, "code", ""), getattr(e, "status", 0),
                str(e))


@pytest.mark.parametrize("seed", range(6))
def test_v2_and_presigned_expiry_equal_reference(seed, frozen_clock):
    """V2 header and presigned signatures, V4 presigned expiry, on seeded
    requests under one frozen clock: the same identity or the same error."""
    rng = np.random.default_rng([seed, 2])
    ref_iam, port_iam = _iams()
    for _ in range(12):
        method, path, query, headers, _ = _seeded_request(rng)
        headers = {"Date": "Sat, 17 Oct 2026 12:00:00 GMT", "Content-Type": "text/plain",
                   "x-amz-meta-a": "b"}
        lower = {k.lower(): v for k, v in headers.items()}
        sts = ref_iam._v2_string_to_sign(method, path, query, lower, lower["date"])
        assert port_iam._v2_string_to_sign(method, path, query, lower, lower["date"]) == sts
        sig = ref_iam._v2_sign("SK", sts)
        assert port_iam._v2_sign("SK", sts) == sig
        tamper = rng.random() < 0.3
        auth = f"AWS AK:{'x' + sig[1:] if tamper else sig}"
        answers = [_outcome(lambda iam=iam: iam.authenticate(
            method, path, query, {**headers, "Authorization": auth}, b""))
            for iam in (ref_iam, port_iam)]
        assert answers[1][:4] == answers[0][:4]
        assert answers[0][0] == ("err" if tamper else "ok")
        # presigned V2 around the frozen clock
        expires = str(int(frozen_clock[0]) + int(rng.integers(-5, 6)))
        p_sts = ref_iam._v2_string_to_sign(method, path, query, {}, expires)
        pre = query + [("AWSAccessKeyId", "AK"), ("Expires", expires),
                       ("Signature", ref_iam._v2_sign("SK", p_sts))]
        answers = [_outcome(lambda iam=iam: iam.authenticate(method, path, pre, {}, b""))
                   for iam in (ref_iam, port_iam)]
        assert answers[1][:4] == answers[0][:4]
        # presigned V4: X-Amz-Date and X-Amz-Expires against the clock
        amz = time.strftime("%Y%m%dT%H%M%SZ",
                            time.gmtime(frozen_clock[0] - int(rng.integers(0, 200))))
        q4 = [("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
              ("X-Amz-Credential", f"AK/{amz[:8]}/us-east-1/s3/aws4_request"),
              ("X-Amz-Date", amz), ("X-Amz-Expires", str(int(rng.integers(1, 200)))),
              ("X-Amz-SignedHeaders", "host"), ("X-Amz-Signature", "0" * 64)]
        answers = [_outcome(lambda iam=iam: iam.authenticate(
            "GET", path, q4, {"host": "h"}, b"")) for iam in (ref_iam, port_iam)]
        assert answers[1][:4] == answers[0][:4]


@pytest.mark.parametrize("seed", range(6))
def test_deframe_streaming_body_equal_reference(seed):
    """aws-chunked frames of seeded sizes, with and without the zero
    terminator, and a malformed header."""
    rng = np.random.default_rng([seed, 3])
    data = rng.bytes(int(rng.integers(0, 300_000)))
    cuts = sorted(int(c) for c in rng.integers(0, len(data) + 1, size=int(rng.integers(0, 6))))
    pieces = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]
    body = b"".join(f"{len(p):x};chunk-signature={'0' * 64}\r\n".encode() + p + b"\r\n"
                    for p in pieces)
    if seed % 2 == 0:
        body += f"0;chunk-signature={'0' * 64}\r\n\r\n".encode()
    got = port_auth.deframe_streaming_body(body)
    assert got == ref_auth.deframe_streaming_body(body) == data
    bad = b"zz;chunk-signature=0\r\n" + body
    errors = []
    for mod in (ref_auth, port_auth):
        with pytest.raises(mod.S3ApiError) as ei:
            mod.deframe_streaming_body(bad)
        errors.append((ei.value.code, ei.value.status, ei.value.message))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("seed", range(4))
def test_circuit_breaker_admission_equal_reference(seed):
    """Seeded enter/leave sequences over global and bucket limits: the same
    admissions, SlowDown refusals and counts."""
    rng = np.random.default_rng([seed, 4])
    limits = {"Read": int(rng.integers(0, 3)), "Write": int(rng.integers(1, 3))}
    buckets = {"b0": {"Write": int(rng.integers(1, 3))}, "b1": {"Read": 1}}
    trace = []
    for mod, auth in ((ref_cb, ref_auth), (port_cb, port_auth)):
        cb = mod.CircuitBreaker(global_limits=dict(limits), bucket_limits=dict(buckets))
        stack = contextlib.ExitStack()
        out = []
        draws = np.random.default_rng([seed, 5])
        for _ in range(40):
            if draws.random() < 0.35:
                stack.close()
                stack = contextlib.ExitStack()
                out.append("release")
                continue
            action = str(draws.choice(["Read", "Write", "List"]))
            bucket = str(draws.choice(["", "b0", "b1"]))
            try:
                stack.enter_context(cb.limit(action, bucket))
                out.append(("in", action, bucket))
            except auth.S3ApiError as e:
                out.append(("refused", e.code, e.status, e.message))
            out.append(dict(cb._counts))
        stack.close()
        out.append(dict(cb._counts))
        trace.append(out)
    assert trace[1] == trace[0]
    assert any(x[0] == "refused" for x in trace[1] if isinstance(x, tuple))


def test_listen_backlog_holds_many_clients():
    """64 connections to a port server that accepts none yet all complete
    their handshake within 0.5 s: the listen queue holds them. With
    socketserver's backlog of 5 the seventh SYN is dropped and waits out a
    1 s retransmit; under 20 S3 clients those waits reached 3 s on the CPU
    and past the 30 s client timeout on the card."""
    import socket

    from seaweedfs_tpu_torch.server import httpd

    server = httpd._Server(("127.0.0.1", 0), httpd.BaseHTTPRequestHandler)
    socks = []
    try:
        for _ in range(64):
            sock = socket.create_connection(server.server_address, timeout=0.5)
            socks.append(sock)
        assert len(socks) == 64
    finally:
        for sock in socks:
            sock.close()
        server.server_close()


def test_filer_client_keeps_a_connection_a_thread():
    """The gateway's filer hop: every call of one thread rides one
    keep-alive connection (the JAX client opens one a call), and a body
    sent without a type carries urllib's default type, which the filer
    stores as the entry's mime."""
    from seaweedfs_tpu_torch.filer.filer_client import FilerClient
    from seaweedfs_tpu_torch.server.httpd import HTTPService, Response

    svc = HTTPService(port=0)
    seen = []

    @svc.route("GET", r"/.*")
    @svc.route("PUT", r"/.*")
    @svc.route("POST", r"/.*")
    @svc.route("DELETE", r"/.*")
    def echo(req):
        seen.append((req.handler.client_address[1], req.method,
                     req.headers.get("Content-Type")))
        return Response({"Entries": []})

    svc.start()
    fc = FilerClient(svc.url)
    try:
        fc.put("/a", b"x")
        fc.get("/a")
        fc.get_entry("/a")
        fc.mkdir("/d")
        fc.list("/d")
        fc.delete("/a")
        fc.put("/b", b"y", "text/plain")
    finally:
        fc.close()
        svc.stop()
    assert len({port for port, _, _ in seen}) == 1
    assert [(m, t) for _, m, t in seen] == [
        ("PUT", "application/x-www-form-urlencoded"), ("GET", None), ("GET", None),
        ("POST", "application/x-www-form-urlencoded"), ("GET", None), ("DELETE", None),
        ("PUT", "text/plain")]


class RawPeer:
    """A bare HTTP/1.1 peer on a socket: each request is counted with its
    connection's number, then answered by `answer(n, line)` for the n-th
    request and its request line (bytes to send, or None to hold the
    request unanswered), and the
    connection is closed after its answer when `close_after` is set."""

    def __init__(self, answer, close_after: bool = False) -> None:
        import socket
        import threading

        self.answer, self.close_after = answer, close_after
        self.seen = []  # (connection number, request line)
        self.closed = threading.Event()  # set after each closed connection
        self.release = threading.Event()
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.url = f"http://127.0.0.1:{self.listener.getsockname()[1]}"
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        import threading

        n_conn = 0
        while True:
            try:
                sock, _ = self.listener.accept()
            except OSError:
                return
            n_conn += 1
            threading.Thread(target=self._conn, args=(sock, n_conn), daemon=True).start()

    def _conn(self, sock, n_conn: int) -> None:
        buf = b""
        with sock:
            while True:
                while b"\r\n\r\n" not in buf:
                    data = sock.recv(65536)
                    if not data:
                        return
                    buf += data
                head, _, buf = buf.partition(b"\r\n\r\n")
                line = head.split(b"\r\n")[0].decode()
                self.seen.append((n_conn, line))
                out = self.answer(len(self.seen), line)
                if out is None:
                    self.release.wait(10)
                    return
                sock.sendall(out)
                if self.close_after:
                    break
        self.closed.set()

    def stop(self) -> None:
        self.release.set()
        self.listener.close()


def ok_answer(n: int, line: str) -> bytes:
    head = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\n"
    return head if line.startswith("HEAD ") else head + b"ok"


@pytest.mark.parametrize("method,idempotent,resent", [
    ("GET", False, True), ("HEAD", False, True), ("POST", True, True),
    ("POST", False, False), ("PUT", False, False)])
def test_pooled_http_resends_only_an_idle_closed_connection(method, idempotent, resent):
    """A keep-alive socket the peer closed while it sat idle fails the next
    request before any answer: a GET, a HEAD and a write the caller
    declares idempotent go out once more on a new connection; any other
    write raises."""
    from seaweedfs_tpu_torch.server.httpd import PooledHTTP

    peer = RawPeer(ok_answer, close_after=True)
    pool = PooledHTTP(timeout=5)
    try:
        assert pool.request(method, peer.url + "/a", b"" if method != "GET" else None,
                            idempotent=idempotent)[0] == 200
        assert peer.closed.wait(5)
        if resent:
            status, _, _ = pool.request(method, peer.url + "/b",
                                        b"" if method != "GET" else None,
                                        idempotent=idempotent)
            assert status == 200
            assert [c for c, _ in peer.seen] == [1, 2]
        else:
            with pytest.raises(OSError):
                pool.request(method, peer.url + "/b", b"")
            assert [c for c, _ in peer.seen] == [1]
    finally:
        pool.close()
        peer.stop()


@pytest.mark.parametrize("reused", [False, True])
def test_pooled_http_never_resends_a_timeout(reused):
    """A GET the peer holds past the pool's timeout raises TimeoutError
    after one send, on a new connection and on a reused one: a stalled
    peer is reported, never waited out twice."""
    from seaweedfs_tpu_torch.server.httpd import PooledHTTP

    stall_at = 2 if reused else 1
    peer = RawPeer(lambda n, line: None if n >= stall_at else ok_answer(n, line))
    pool = PooledHTTP(timeout=0.3)
    try:
        if reused:
            assert pool.request("GET", peer.url + "/a")[0] == 200
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            pool.request("GET", peer.url + "/slow")
        assert time.perf_counter() - t0 < 2.0
        assert [line for _, line in peer.seen][-1] == "GET /slow HTTP/1.1"
        assert len(peer.seen) == stall_at
    finally:
        pool.close()
        peer.stop()


def test_a_filer_get_past_its_timeout_answers_500(s3, bucket):
    """The gateway's filer GET of an object that the filer holds past the
    hop's timeout reaches the S3 client as 500 InternalError, sent to the
    filer once; a re-send would have answered 200 from the second, quick
    read and hidden the stall."""
    import threading

    side = s3.port
    client = side.client()
    client.put_object(bucket, "slow", b"x" * 100)
    filer = side.side.filer
    real = filer._do_read
    reads = []
    release = threading.Event()

    def held_read(req, head):
        if not head and req.path.endswith(f"/{bucket}/slow") and "metadata" not in req.query:
            reads.append(req.path)
            if len(reads) == 1:
                release.wait(10)
        return real(req, head)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(filer, "_do_read", held_read)
        mp.setattr(side.s3.fc._pool, "timeout", 0.5)
        try:
            with pytest.raises(S3Error) as ei:
                client.get_object(bucket, "slow")
            assert (ei.value.status, ei.value.code) == (500, "InternalError")
            assert len(reads) == 1
        finally:
            release.set()
        assert client.get_object(bucket, "slow") == b"x" * 100
    assert len(reads) == 2
    client.delete_object(bucket, "slow")


# --- auth -----------------------------------------------------------------------------
class TestAuth:
    def test_bad_access_key(self, s3):
        with pytest.raises(S3Error) as ei:
            s3.api("list_buckets", creds=("nobody", "nosecret"))
        assert ei.value.code == "InvalidAccessKeyId"

    def test_bad_signature(self, s3):
        with pytest.raises(S3Error) as ei:
            s3.api("list_buckets", creds=("adminKey", "WRONG"))
        assert ei.value.code == "SignatureDoesNotMatch"

    def test_reader_cannot_write(self, s3, bucket):
        with pytest.raises(S3Error) as ei:
            s3.api("put_object", bucket, "x", b"data", creds=("readKey", "readSecret"))
        assert ei.value.code == "AccessDenied"

    def test_scoped_identity(self, s3):
        scoped = ("scopedKey", "scopedSecret")
        s3.api("create_bucket", "onlybucket")
        s3.api("put_object", "onlybucket", "k", b"v", creds=scoped)
        assert s3.api("get_object", "onlybucket", "k", creds=scoped) == b"v"
        with pytest.raises(S3Error):
            s3.api("put_object", "otherbucket", "k", b"v", creds=scoped)
        s3.store("/buckets/onlybucket")
        s3.api("delete_objects", "onlybucket", ["k"])
        s3.api("delete_bucket", "onlybucket")


class TestBuckets:
    def test_create_list_delete(self, s3, bucket):
        assert bucket in s3.api("list_buckets")
        assert s3.api("head_bucket", bucket)
        with pytest.raises(S3Error) as ei:
            s3.api("create_bucket", bucket)
        assert ei.value.code == "BucketAlreadyExists"
        s3.request("GET", "/")

    def test_delete_nonempty_rejected(self, s3, bucket):
        s3.api("put_object", bucket, "keep.txt", b"x")
        with pytest.raises(S3Error) as ei:
            s3.api("delete_bucket", bucket)
        assert ei.value.code == "BucketNotEmpty"

    def test_missing_bucket(self, s3):
        with pytest.raises(S3Error) as ei:
            s3.api("get_object", "nosuchbucket", "k")
        assert ei.value.code == "NoSuchBucket"


class TestObjects:
    def test_put_get_roundtrip(self, s3, bucket):
        data = b"hello s3 world"
        etag = s3.api("put_object", bucket, "greeting.txt", data, "text/plain")
        assert etag == hashlib.md5(data).hexdigest()
        assert s3.api("get_object", bucket, "greeting.txt") == data
        s3.request("GET", f"/{bucket}/greeting.txt")
        s3.store(f"/buckets/{bucket}")

    def test_nested_keys(self, s3, bucket):
        s3.api("put_object", bucket, "a/b/c/deep.bin", b"deep")
        assert s3.api("get_object", bucket, "a/b/c/deep.bin") == b"deep"
        s3.store(f"/buckets/{bucket}")

    def test_big_object_range(self, s3, bucket):
        data = seeded(3 * CHUNK + 17, 11)  # four chunks, not inlined
        s3.api("put_object", bucket, "big.bin", data)
        assert s3.api("get_object", bucket, "big.bin") == data
        piece = s3.api("get_object", bucket, "big.bin", range_header="bytes=100-199")
        assert piece == data[100:200]
        # across a chunk edge, with its Content-Range
        status, headers, body = s3.request(
            "GET", f"/{bucket}/big.bin", headers={"Range": f"bytes={CHUNK - 5}-{CHUNK + 4}"})
        assert status == 206 and body == data[CHUNK - 5 : CHUNK + 5]
        assert headers["Content-Range"] == f"bytes {CHUNK - 5}-{CHUNK + 4}/{len(data)}"
        s3.store(f"/buckets/{bucket}")

    def test_metadata_headers(self, s3, bucket):
        s3.api("put_object", bucket, "m.txt", b"x", metadata={"purpose": "test", "owner": "me"})
        headers = s3.api("head_object", bucket, "m.txt")
        assert headers["x-amz-meta-purpose"] == "test"
        assert headers["x-amz-meta-owner"] == "me"
        s3.store(f"/buckets/{bucket}")
        s3.entry(f"/buckets/{bucket}")  # the bucket entry, with its meta marker

    def test_copy(self, s3, bucket):
        s3.api("put_object", bucket, "src.txt", b"copy me")
        s3.request("PUT", f"/{bucket}/dst.txt",
                   headers={"x-amz-copy-source": f"/{bucket}/src.txt"})
        assert s3.api("get_object", bucket, "dst.txt") == b"copy me"
        s3.store(f"/buckets/{bucket}")

    def test_missing_key(self, s3, bucket):
        with pytest.raises(S3Error) as ei:
            s3.api("get_object", bucket, "ghost")
        assert ei.value.code == "NoSuchKey"

    def test_delete_object_idempotent(self, s3, bucket):
        s3.api("put_object", bucket, "bye.txt", b"x")
        s3.api("delete_object", bucket, "bye.txt")
        s3.api("delete_object", bucket, "bye.txt")  # 204 both times
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "bye.txt")

    def test_batch_delete(self, s3, bucket):
        for i in range(5):
            s3.api("put_object", bucket, f"batch/{i}.txt", b"x")
        deleted = s3.api("delete_objects", bucket, [f"batch/{i}.txt" for i in range(5)])
        assert len(deleted) == 5
        assert s3.api("list_objects", bucket, prefix="batch/")["contents"] == []
        s3.store(f"/buckets/{bucket}")


class TestListing:
    @pytest.fixture()
    def tree(self, s3, bucket):
        keys = ["2023/jan/a.txt", "2023/feb/b.txt", "2024/mar/c.txt", "root1.txt", "root2.txt"]
        for k in keys:
            s3.api("put_object", bucket, k, b"x")
        return keys

    def test_flat_list(self, s3, bucket, tree):
        out = s3.api("list_objects", bucket)
        assert [c["key"] for c in out["contents"]] == sorted(tree)
        s3.request("GET", f"/{bucket}", query=[("list-type", "2")])

    def test_prefix(self, s3, bucket, tree):
        out = s3.api("list_objects", bucket, prefix="2023/")
        assert [c["key"] for c in out["contents"]] == ["2023/feb/b.txt", "2023/jan/a.txt"]

    def test_delimiter_common_prefixes(self, s3, bucket, tree):
        out = s3.api("list_objects", bucket, delimiter="/")
        assert out["common_prefixes"] == ["2023/", "2024/"]
        assert [c["key"] for c in out["contents"]] == ["root1.txt", "root2.txt"]

    def test_prefix_and_delimiter(self, s3, bucket, tree):
        out = s3.api("list_objects", bucket, prefix="2023/", delimiter="/")
        assert out["common_prefixes"] == ["2023/feb/", "2023/jan/"]
        assert out["contents"] == []

    def test_pagination(self, s3, bucket, tree):
        seen, token = [], ""
        for _ in range(10):
            out = s3.api("list_objects", bucket, max_keys=2, continuation_token=token)
            seen += [c["key"] for c in out["contents"]]
            if not out["is_truncated"]:
                break
            token = out["next_token"]
        assert seen == sorted(tree)

    def test_v1_marker_pagination(self, s3, bucket, tree):
        out = s3.api("list_objects", bucket, max_keys=3, v2=False)
        assert out["is_truncated"]
        out2 = s3.api("list_objects", bucket, max_keys=10, v2=False,
                      continuation_token=out["next_token"])
        got = [c["key"] for c in out["contents"]] + [c["key"] for c in out2["contents"]]
        assert got == sorted(tree)
        s3.request("GET", f"/{bucket}", query=[("max-keys", "3")])


class TestMultipart:
    def test_multipart_roundtrip(self, s3, bucket):
        part_size = 2 * CHUNK + 5
        parts_data = [seeded(part_size, 20 + i) for i in range(3)]
        upload_id = s3.api("create_multipart", bucket, "mp/asm.bin")
        parts = []
        for i, p in enumerate(parts_data, start=1):
            parts.append((i, s3.api("upload_part", bucket, "mp/asm.bin", upload_id, i, p)))
        assert sorted(s3.api("list_parts", bucket, "mp/asm.bin", upload_id)) == [1, 2, 3]
        s3.request("GET", f"/{bucket}/mp/asm.bin", query={"uploadId": upload_id})
        s3.request("GET", f"/{bucket}", query={"uploads": ""})
        s3.store(f"/buckets/{bucket}")
        etag = s3.api("complete_multipart", bucket, "mp/asm.bin", upload_id, parts)
        assert etag.endswith("-3")
        digests = b"".join(hashlib.md5(p).digest() for p in parts_data)
        assert etag == f"{hashlib.md5(digests).hexdigest()}-3"
        assert s3.api("get_object", bucket, "mp/asm.bin") == b"".join(parts_data)
        s3.store(f"/buckets/{bucket}")

    def test_multipart_small_parts_inline(self, s3, bucket):
        upload_id = s3.api("create_multipart", bucket, "mp/tiny.bin")
        parts = []
        for i, p in enumerate([b"aaa", b"bbb"], start=1):
            parts.append((i, s3.api("upload_part", bucket, "mp/tiny.bin", upload_id, i, p)))
        s3.api("complete_multipart", bucket, "mp/tiny.bin", upload_id, parts)
        assert s3.api("get_object", bucket, "mp/tiny.bin") == b"aaabbb"
        s3.store(f"/buckets/{bucket}")

    def test_abort(self, s3, bucket):
        upload_id = s3.api("create_multipart", bucket, "mp/gone.bin")
        s3.api("upload_part", bucket, "mp/gone.bin", upload_id, 1, b"data")
        s3.api("abort_multipart", bucket, "mp/gone.bin", upload_id)
        with pytest.raises(S3Error) as ei:
            s3.api("list_parts", bucket, "mp/gone.bin", upload_id)
        assert ei.value.code == "NoSuchUpload"

    def test_complete_with_missing_part(self, s3, bucket):
        upload_id = s3.api("create_multipart", bucket, "mp/bad.bin")
        s3.api("upload_part", bucket, "mp/bad.bin", upload_id, 1, b"data")
        with pytest.raises(S3Error) as ei:
            s3.api("complete_multipart", bucket, "mp/bad.bin", upload_id, [(1, "x"), (2, "y")])
        assert ei.value.code == "InvalidPart"

    def test_out_of_order_rejected(self, s3, bucket):
        upload_id = s3.api("create_multipart", bucket, "mp/ooo.bin")
        with pytest.raises(S3Error) as ei:
            s3.api("complete_multipart", bucket, "mp/ooo.bin", upload_id, [(2, "x"), (1, "y")])
        assert ei.value.code == "InvalidPartOrder"


class TestSecurityRegressions:
    def test_tagging_identity_cannot_delete_bucket(self, s3, bucket):
        """DELETE /bucket?tagging must hit the tagging handler, never
        delete-bucket."""
        tag = ("tagKey", "tagSecret")
        s3.request("DELETE", f"/{bucket}", query={"tagging": ""}, creds=tag)
        assert s3.api("head_bucket", bucket), "bucket must survive DeleteBucketTagging"
        status, _, body = s3.request("DELETE", f"/{bucket}", creds=tag)
        assert status == 403 and "AccessDenied" in body

    def test_copy_requires_source_read(self, s3, bucket):
        s3.api("create_bucket", "secrets-src")
        s3.api("put_object", "secrets-src", "classified.txt", b"top secret")
        if not s3.api("head_bucket", "onlybucket"):
            s3.api("create_bucket", "onlybucket")
        status, _, body = s3.request(
            "PUT", "/onlybucket/stolen.txt",
            headers={"x-amz-copy-source": "/secrets-src/classified.txt"},
            creds=("scopedKey", "scopedSecret"))
        assert status == 403 and "AccessDenied" in body
        s3.api("delete_objects", "secrets-src", ["classified.txt"])
        s3.api("delete_bucket", "secrets-src")

    def test_head_reports_content_length(self, s3, bucket):
        data = seeded(2 * CHUNK + 7, 12)  # chunked, not inlined
        s3.api("put_object", bucket, "sized.bin", data)
        headers = s3.api("head_object", bucket, "sized.bin")
        assert int(headers["Content-Length"]) == len(data)
        assert headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'

    def test_presigned_get(self, s3, bucket):
        s3.api("put_object", bucket, "signed.txt", b"presigned!")
        urls = dict(zip(("ref", "port"), s3.each(
            lambda s: s.client().presign_url("GET", bucket, "signed.txt"))))
        status, _, body = s3.call(lambda s: s.http_request("GET", urls[s.name]))
        assert status == 200 and body == b"presigned!"
        # tampered signature is rejected
        status, _, _ = s3.call(lambda s: s.http_request(
            "GET", urls[s.name].replace("X-Amz-Signature=", "X-Amz-Signature=0")))
        assert status == 403


class TestListingOrder:
    def test_dot_before_slash_pagination(self, s3, bucket):
        """Keys come back in full-key order: 'a.txt' < 'a/x' ('.' < '/'),
        though the filer sorts 'a' before 'a.txt'."""
        s3.api("put_object", bucket, "a/x", b"1")
        s3.api("put_object", bucket, "a.txt", b"2")
        out = s3.api("list_objects", bucket)
        assert [c["key"] for c in out["contents"]] == ["a.txt", "a/x"]
        seen, token = [], ""
        for _ in range(5):
            page = s3.api("list_objects", bucket, max_keys=1, continuation_token=token)
            seen += [c["key"] for c in page["contents"]]
            if not page["is_truncated"]:
                break
            token = page["next_token"]
        assert seen == ["a.txt", "a/x"]

    def test_generic_delimiter(self, s3, bucket):
        for k in ["img-1.png", "img-2.png", "doc-1.txt", "plain"]:
            s3.api("put_object", bucket, k, b"x")
        out = s3.api("list_objects", bucket, delimiter="-")
        assert out["common_prefixes"] == ["doc-", "img-"]
        assert [c["key"] for c in out["contents"]] == ["plain"]


class TestTagging:
    def test_object_tagging_lifecycle(self, s3, bucket):
        s3.api("put_object", bucket, "tagged.txt", b"x")
        s3.api("put_object_tagging", bucket, "tagged.txt", {"env": "prod", "team": "storage"})
        assert s3.api("get_object_tagging", bucket, "tagged.txt") == \
            {"env": "prod", "team": "storage"}
        s3.store(f"/buckets/{bucket}")
        s3.api("delete_object_tagging", bucket, "tagged.txt")
        assert s3.api("get_object_tagging", bucket, "tagged.txt") == {}
        s3.request("PUT", f"/{bucket}", query={"tagging": ""},
                   body=b"<Tagging><TagSet><Tag><Key>b</Key><Value>1</Value></Tag>"
                        b"</TagSet></Tagging>")
        s3.request("GET", f"/{bucket}", query={"tagging": ""})


class TestCircuitBreaker:
    def test_slowdown(self):
        answers = []
        for mod, auth in ((ref_cb, ref_auth), (port_cb, port_auth)):
            cb = mod.CircuitBreaker(global_limits={"Write": 1})
            with cb.limit("Write", "b"):
                with pytest.raises(auth.S3ApiError) as ei:
                    with cb.limit("Write", "b"):
                        pass
                answers.append((ei.value.code, ei.value.status, ei.value.message))
            with cb.limit("Write", "b"):  # released afterwards
                pass
        assert answers[1] == answers[0]
        assert answers[1][0] == "SlowDown"
