"""The port's IAM API held against the JAX package's, case for case with
`tests/test_iam.py` (the policy-to-action mapping, the user, key and policy
lifecycle with the S3 gateway's live reload, and the filer's LocalKV store),
through `s3_twin(iam=True)` of `tests/test_torch_s3.py`: the same form
requests to both IAM servers, answers equal after `S3Norm` (generated user
ids, request ids, access keys and secrets ranked by first appearance).

State carried across: the identity document the JAX `IamServer` writes
loads into the port's `IdentityAccessManagement` and authorizes the same
seeded signed requests, and a port gateway serving it from its own filer
takes it live; a JAX filer store holding buckets written by the JAX
gateway (policy, versioning with retained versions, CORS, lifecycle, ACLs,
tags, x-amz-meta, an open multipart upload), copied by
`filer.dedup.copy_store` into a port filer, answers through the port
gateway exactly as through the JAX one. Tolerance: byte equality.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from seaweedfs_tpu.filer.kvstore import LocalKV as RefLocalKV
from seaweedfs_tpu.filer.kvstore import LocalKVStore as RefLocalKVStore
from seaweedfs_tpu.filer import Entry as RefEntry
from seaweedfs_tpu.filer import Filer as RefFiler
from seaweedfs_tpu.iamapi.iam_server import policy_to_actions as ref_policy_to_actions
from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu_torch.filer import Entry, Filer
from seaweedfs_tpu_torch.filer.dedup import copy_store
from seaweedfs_tpu_torch.filer.filerstore import MemoryStore
from seaweedfs_tpu_torch.filer.kvstore import LocalKV, LocalKVStore
from seaweedfs_tpu_torch.iamapi.iam_server import policy_to_actions
from seaweedfs_tpu_torch.s3api import S3Client, S3Server
from seaweedfs_tpu_torch.s3api import auth as port_auth
from seaweedfs_tpu_torch.s3api.sigv4_client import S3Error
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_request

from .test_torch_filer_meta import Side, seeded
from .test_torch_s3 import S3Pair, S3Side, s3_twin

ADMIN_POLICY = ('{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
                '"Action":"s3:*","Resource":"arn:aws:s3:::*"}]}')


def both_map(doc: dict) -> list:
    got, want = policy_to_actions(doc), ref_policy_to_actions(doc)
    assert got == want
    return got


class TestPolicyMapping:
    def test_admin_star(self):
        doc = {"Statement": [{"Effect": "Allow", "Action": "s3:*", "Resource": "arn:aws:s3:::*"}]}
        assert both_map(doc) == ["Admin"]

    def test_scoped_read_write(self):
        doc = {"Statement": [{"Effect": "Allow",
                              "Action": ["s3:GetObject", "s3:PutObject", "s3:ListBucket"],
                              "Resource": ["arn:aws:s3:::mybucket/*"]}]}
        assert both_map(doc) == ["Read:mybucket", "Write:mybucket", "List:mybucket"]

    def test_deny_ignored(self):
        doc = {"Statement": [{"Effect": "Deny", "Action": "s3:*", "Resource": "arn:aws:s3:::*"}]}
        assert both_map(doc) == []

    def test_tagging(self):
        doc = {"Statement": [{"Effect": "Allow", "Action": "s3:GetObjectTagging",
                              "Resource": "arn:aws:s3:::b/*"}]}
        assert both_map(doc) == ["Tagging:b"]


@pytest.mark.parametrize("seed", range(4))
def test_policy_mapping_seeded_equal_reference(seed):
    rng = np.random.default_rng([seed, 11])
    acts = ["s3:*", "*", "s3:GetObject", "s3:HeadObject", "s3:PutObject", "s3:DeleteObject",
            "s3:AbortMultipartUpload", "s3:CreateBucket", "s3:ListBucket",
            "s3:PutObjectTagging", "iam:CreateUser"]
    res = ["arn:aws:s3:::*", "arn:aws:s3:::", "arn:aws:s3:::b1/*", "arn:aws:s3:::b2*",
           "arn:aws:s3:::b3/k", "arn:aws:iam:::user/x"]
    for _ in range(16):
        stmts = [{"Effect": str(rng.choice(["Allow", "Deny"])),
                  "Action": [str(a) for a in rng.choice(acts, size=int(rng.integers(1, 4)))],
                  "Resource": [str(r) for r in rng.choice(res, size=int(rng.integers(0, 3)))]}
                 for _ in range(int(rng.integers(1, 4)))]
        both_map({"Statement": stmts if len(stmts) > 1 else stmts[0]})


def iam_call(pair: S3Pair, action: str, creds=None, **params) -> ET.Element:
    """The same IAM form request to both IAM servers; the port's answer,
    normalized, parsed."""

    def send(side):
        body = urllib.parse.urlencode({"Action": action, **side.norm.unmap(params)}).encode()
        ctype = {"Content-Type": "application/x-www-form-urlencoded"}
        if creds:
            client = side.client_cls(side.iam.url, *side.norm.unmap(tuple(creds)),
                                     service="iam")
            return client.request("POST", "/", body=body, headers=ctype)
        return side.http_request("POST", f"{side.iam.url}/", body, ctype)

    _, _, text = pair.call(send)
    return ET.fromstring(text)


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def _find_text(root: ET.Element, name: str) -> str:
    for el in root.iter():
        if _strip(el.tag) == name and el.text:
            return el.text
    return ""


@pytest.fixture(scope="module")
def iam_stack(tmp_path_factory):
    with s3_twin(str(tmp_path_factory.mktemp("iam")), iam=True) as pair:
        yield pair


@pytest.fixture(scope="module")
def admin_creds(iam_stack):
    """Bootstrap the first admin on both sides: unsigned requests are
    allowed until an identity holds Admin and credentials."""
    root = iam_call(iam_stack, "CreateUser", UserName="alice")
    assert _find_text(root, "UserName") == "alice"
    assert _find_text(root, "UserId") == "user0x"
    root = iam_call(iam_stack, "CreateAccessKey", UserName="alice")
    ak, sk = _find_text(root, "AccessKeyId"), _find_text(root, "SecretAccessKey")
    assert (ak, sk) == ("akid0x", "secret0x")
    iam_call(iam_stack, "PutUserPolicy", UserName="alice", PolicyName="admin",
             PolicyDocument=ADMIN_POLICY)
    return ak, sk


def identity_docs(pair: S3Pair) -> list:
    """`/etc/iam/identity.json` of both filers, normalized; held equal."""
    docs = []
    for s in pair.sides:
        status, _, body = http_request("GET", f"{s.side.filer.url}/etc/iam/identity.json")
        assert status == 200
        docs.append(json.loads(s.norm.text(body.decode())))
    assert docs[1] == docs[0]
    return docs[1]


def wait_for_key(side, creds, timeout=10.0) -> float:
    """Seconds until a request signed with creds succeeds on side's gateway."""
    t0 = time.monotonic()
    client = side.client(creds)
    while True:
        status, _, _ = client.request("GET", "/")
        if status == 200:
            return time.monotonic() - t0
        assert time.monotonic() - t0 < timeout, f"{side.name}: no reload in {timeout} s"
        time.sleep(0.05)


class TestIamLifecycle:
    def test_s3_hot_reload(self, iam_stack, admin_creds):
        """Both gateways pick up IAM-managed identities live."""
        for side in iam_stack.sides:
            wait_for_key(side, admin_creds)
        iam_stack.api("create_bucket", "alice-bucket", creds=admin_creds)
        assert "alice-bucket" in iam_stack.api("list_buckets", creds=admin_creds)
        iam_stack.api("put_object", "alice-bucket", "hello.txt", b"from alice",
                      creds=admin_creds)
        assert iam_stack.api("get_object", "alice-bucket", "hello.txt",
                             creds=admin_creds) == b"from alice"
        doc = identity_docs(iam_stack)
        assert doc["identities"][0]["actions"] == ["Admin"]
        with pytest.raises(S3Error) as ei:
            iam_stack.api("list_buckets", creds=("AKIDFFFFFFFFFFFFFFFF", "nope"))
        assert ei.value.status == 403 and ei.value.code == "InvalidAccessKeyId"

    def test_locked_after_bootstrap(self, iam_stack, admin_creds):
        root = iam_call(iam_stack, "CreateUser", UserName="mallory")
        assert _find_text(root, "Code") in ("AccessDenied", "InvalidAccessKeyId")

    def test_list_and_delete(self, iam_stack, admin_creds):
        iam_call(iam_stack, "CreateUser", creds=admin_creds, UserName="bob")
        root = iam_call(iam_stack, "ListUsers", creds=admin_creds)
        assert "bob" in [el.text for el in root.iter() if _strip(el.tag) == "UserName"]
        root = iam_call(iam_stack, "CreateAccessKey", creds=admin_creds, UserName="bob")
        key_id = _find_text(root, "AccessKeyId")
        root = iam_call(iam_stack, "ListAccessKeys", creds=admin_creds, UserName="bob")
        assert _find_text(root, "AccessKeyId") == key_id
        iam_call(iam_stack, "GetUserPolicy", creds=admin_creds, UserName="alice")
        iam_call(iam_stack, "CreatePolicy", creds=admin_creds, PolicyName="ro",
                 PolicyDocument=ADMIN_POLICY.replace("s3:*", "s3:Get*"))
        iam_call(iam_stack, "UpdateUser", creds=admin_creds, UserName="bob",
                 NewUserName="bobby")
        iam_call(iam_stack, "DeleteAccessKey", creds=admin_creds, UserName="bobby",
                 AccessKeyId=key_id)
        root = iam_call(iam_stack, "ListAccessKeys", creds=admin_creds, UserName="bobby")
        assert _find_text(root, "AccessKeyId") == ""
        identity_docs(iam_stack)
        iam_call(iam_stack, "DeleteUser", creds=admin_creds, UserName="bobby")
        root = iam_call(iam_stack, "GetUser", creds=admin_creds, UserName="bobby")
        assert _find_text(root, "Code") == "NoSuchEntity"
        root = iam_call(iam_stack, "NoSuchAction", creds=admin_creds)
        assert _find_text(root, "Code") == "NotImplemented"


class TestLocalKVStore:
    def test_filer_roundtrip_and_reopen(self, tmp_path):
        names = []
        for filer_cls, entry_cls, store_cls, sub in (
                (RefFiler, RefEntry, RefLocalKVStore, "ref"),
                (Filer, Entry, LocalKVStore, "port")):
            f = filer_cls(store_cls(str(tmp_path / sub)))
            for p in ("/docs/a.txt", "/docs/b.txt", "/docs/sub/c.txt"):
                f.create_entry(entry_cls(full_path=p))
            listed = [e.name for e in f.list_entries("/docs")]
            f.close()
            f2 = filer_cls(store_cls(str(tmp_path / sub)))  # state survives the WAL replay
            assert f2.find_entry("/docs/a.txt") is not None
            names.append((listed, [e.name for e in f2.list_entries("/docs")]))
            f2.close()
        assert names[1] == names[0] == (["a.txt", "b.txt", "sub"],) * 2

    def test_torn_wal_tail_tolerated(self, tmp_path):
        got = []
        for kv_cls, sub in ((RefLocalKV, "ref"), (LocalKV, "port")):
            kv = kv_cls(str(tmp_path / sub))
            kv.put(b"k1", b"v1")
            kv.put(b"k2", b"v2")
            kv.close()
            wal = tmp_path / sub / "wal.log"
            data = wal.read_bytes()
            wal.write_bytes(data[:-3])  # a crash mid-append
            kv2 = kv_cls(str(tmp_path / sub))
            got.append((data, kv2.get(b"k1"), kv2.get(b"k2")))
            kv2.close()
        assert got[1] == got[0]
        assert got[1][1:] == (b"v1", None)

    def test_compaction(self, tmp_path):
        got = []
        for kv_cls, sub in ((RefLocalKV, "ref"), (LocalKV, "port")):
            kv = kv_cls(str(tmp_path / sub), compact_bytes=256)
            for i in range(100):
                kv.put(f"key{i:03d}".encode(), b"x" * 10)
            for i in range(0, 100, 2):
                kv.delete(f"key{i:03d}".encode())
            kv.close()
            kv2 = kv_cls(str(tmp_path / sub), compact_bytes=256)
            got.append((kv2.get(b"key001"), kv2.get(b"key000"),
                        list(kv2.scan(b"key", b"kez")),
                        sorted(p.name for p in (tmp_path / sub).iterdir())))
            kv2.close()
        assert got[1] == got[0]
        assert got[1][0] == b"x" * 10 and got[1][1] is None and len(got[1][2]) == 50


# --- state carried across -------------------------------------------------------------
def _signed(creds, method, path, query, body, host="127.0.0.1:8333"):
    """Headers of a request signed with creds by the port's client."""
    client = S3Client(f"http://{host}", *creds)
    return client._signed_headers(method, path, query, body)


def test_jax_identity_document_authorizes_alike(iam_stack, admin_creds):
    """The identity JSON the JAX IamServer wrote loads into the port's
    IdentityAccessManagement and authorizes the same seeded requests; a port
    gateway given that document in its filer takes it live."""
    ref_side, port_side = iam_stack.sides
    status, _, raw = http_request("GET", f"{ref_side.side.filer.url}/etc/iam/identity.json")
    assert status == 200
    ref_iam, port_iam = ref_auth.IdentityAccessManagement(), port_auth.IdentityAccessManagement()
    ref_iam.load_json(raw)
    port_iam.load_json(raw)
    assert [i.to_dict() for i in port_iam.identities] == [i.to_dict() for i in ref_iam.identities]
    alice = tuple(ref_side.norm.unmap(list(admin_creds)))
    rng = np.random.default_rng(12)
    for _ in range(32):
        creds = alice if rng.random() < 0.7 else ("AKIDFFFFFFFFFFFFFFFF", "x")
        if rng.random() < 0.2:
            creds = (creds[0], "wrong-secret")
        method = str(rng.choice(["GET", "PUT", "DELETE", "HEAD"]))
        path = str(rng.choice(["/", "/b", "/b/k.txt", "/other/x"]))
        body = rng.bytes(int(rng.integers(0, 64))) if method == "PUT" else b""
        query = [("tagging", "")] if rng.random() < 0.2 else []
        headers = _signed(creds, method, path, query, body)
        answers = []
        for iam in (ref_iam, port_iam):
            try:
                ident = iam.authenticate(method, path, query, headers, body)
                bucket, _, key = path.lstrip("/").partition("/")
                answers.append(("ok", ident.name, ident.can_do("Write", bucket, key),
                                ident.can_do("Read", bucket, key)))
            except Exception as e:  # each package's S3ApiError, compared by field
                answers.append(("err", e.code, e.status, str(e)))
        assert answers[1] == answers[0]
    # the JAX-written document, put into the port's filer, reloads the
    # port's gateway: a key of the JAX side's now works there
    iam_stack.api("create_bucket", "carried-bucket", creds=admin_creds)
    doc_url = f"{port_side.side.filer.url}/etc/iam/identity.json"
    status, _, own = http_request("GET", doc_url)
    assert status == 200
    fresh = S3Server(port_side.side.filer.url, port=0)
    fresh.start()
    try:
        status, _, _ = http_request("PUT", doc_url, raw, {"Content-Type": "application/json"})
        assert status == 201
        deadline = time.monotonic() + 10
        client = S3Client(fresh.url, *alice)
        while client.request("GET", "/")[0] != 200:
            assert time.monotonic() < deadline, "the port gateway did not reload"
            time.sleep(0.05)
        assert "carried-bucket" in client.list_buckets()
    finally:
        fresh.stop()
        # the port side's own document back
        http_request("PUT", doc_url, own, {"Content-Type": "application/json"})
    iam_stack.api("delete_bucket", "carried-bucket", creds=admin_creds)


STORE_CONFIG = {"identities": [{"name": "admin",
                                "credentials": [{"accessKey": "adminKey",
                                                 "secretKey": "adminSecret"}],
                                "actions": ["Admin"]}]}
CORS = (b"<CORSConfiguration><CORSRule><AllowedOrigin>*</AllowedOrigin>"
        b"<AllowedMethod>GET</AllowedMethod><ExposeHeader>ETag</ExposeHeader>"
        b"</CORSRule></CORSConfiguration>")
LIFECYCLE = (b"<LifecycleConfiguration><Rule><ID>r</ID><Prefix>tmp/</Prefix>"
             b"<Status>Enabled</Status><Expiration><Days>3</Days></Expiration></Rule>"
             b"</LifecycleConfiguration>")


def test_jax_store_copied_serves_alike(tmp_path):
    """Buckets the JAX gateway wrote, in a JAX filer store copied by
    `copy_store` into a port filer, answer through the port gateway exactly
    as through the JAX gateway: listings, objects whole and ranged, HEAD,
    versions, ACLs, policy, CORS, lifecycle, tags, the open upload."""
    with s3_twin(str(tmp_path), STORE_CONFIG) as pair:
        ref = pair.ref
        c = ref.client()
        c.create_bucket("carry")
        c.request("PUT", "/carry", query={"versioning": ""},
                  body=b"<VersioningConfiguration><Status>Enabled</Status>"
                       b"</VersioningConfiguration>")
        c.request("PUT", "/carry", query={"cors": ""}, body=CORS)
        c.request("PUT", "/carry", query={"lifecycle": ""}, body=LIFECYCLE)
        c.request("PUT", "/carry", query={"policy": ""}, body=json.dumps({
            "Version": "2012-10-17", "Statement": [{
                "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
                "Resource": "arn:aws:s3:::carry/pub/*"}]}).encode())
        c.put_object("carry", "pub/a.txt", b"version one")
        c.put_object("carry", "pub/a.txt", seeded(3 * 4096 + 9, 30),
                     metadata={"colour": "blue"})
        c.put_object("carry", "deep/x/y.bin", seeded(5000, 31))
        c.request("PUT", "/carry/deep/x/y.bin", query={"acl": ""},
                  headers={"x-amz-acl": "public-read"})
        c.put_object_tagging("carry", "deep/x/y.bin", {"k": "v"})
        c.delete_object("carry", "gone.txt")  # a delete marker
        upload = c.create_multipart("carry", "mp.bin")
        c.upload_part("carry", "mp.bin", upload, 1, seeded(4096 + 1, 32))
        c.create_bucket("plain")
        c.put_object("plain", "k", b"plain bytes")

        store = MemoryStore()
        assert copy_store(ref.side.filer.filer.store, store) > 10
        port_filer = FilerServer(ref.side.master.url, port=0, device="cpu", filer=Filer(store))
        port_filer.chunk_size = 4096
        port_filer.start()
        port_s3 = S3Server(port_filer.url, port=0, config=STORE_CONFIG)
        port_s3.start()
        try:
            carried = S3Pair(
                S3Side(Side("ref", ref.side.master, ref.side.vol, [ref.side.filer]), ref.s3,
                       None, ref.client_cls, ref.error_cls, ref.http_request),
                S3Side(Side("port", ref.side.master, ref.side.vol, [port_filer]), port_s3,
                       None, S3Client, S3Error, http_request))
            carried.request("GET", "/")
            for q in ({"list-type": "2"}, {"versions": ""}, {"versioning": ""}, {"cors": ""},
                      {"lifecycle": ""}, {"policy": ""}, {"acl": ""}, {"uploads": ""},
                      {"location": ""}, {"tagging": ""}):
                carried.request("GET", "/carry", query=q)
            _, _, listing = carried.request("GET", "/carry", query={"versions": ""})
            for vid in sorted(set(ET.fromstring(listing).itertext()) & set(
                    carried.port.norm.real)):
                carried.request("GET", "/carry/pub/a.txt", query={"versionId": vid})
            carried.request("GET", "/carry/pub/a.txt")
            carried.request("HEAD", "/carry/pub/a.txt")
            carried.request("GET", "/carry/pub/a.txt", headers={"Range": "bytes=4090-4200"})
            carried.request("GET", "/carry/pub/a.txt", headers={"Origin": "https://x.example"})
            carried.raw("GET", "/carry/pub/a.txt")  # anonymous, through the policy
            carried.request("GET", "/carry/deep/x/y.bin")
            carried.request("GET", "/carry/deep/x/y.bin", query={"acl": ""})
            carried.request("GET", "/carry/deep/x/y.bin", query={"tagging": ""})
            carried.request("GET", "/carry/gone.txt")
            carried.request("GET", "/plain", query={"list-type": "2"})
            carried.request("GET", "/plain/k")
            carried.request("GET", "/plain/k", query={"acl": ""})
            # and on from there: the same new writes through each gateway
            carried.request("PUT", "/carry/pub/a.txt", body=b"version three")
            carried.request("GET", "/carry", query={"versions": ""})
            carried.request("PUT", "/plain/new.txt", body=b"new")
            carried.request("GET", "/plain", query={"list-type": "2"})
        finally:
            port_s3.stop()
            port_filer.stop()
