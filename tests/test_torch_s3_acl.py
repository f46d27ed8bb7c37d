"""The port's Signature V2 verification (header, presigned, POST-policy V2)
and ACL grant model held against the JAX gateway's, case for case with
`tests/test_s3_v2_acl.py`, through `s3_twin()` of `tests/test_torch_s3.py`
(the same requests to both gateways; answers and stored entries equal
after `S3Norm`). Unit parity on seeded inputs: ACL parse (canned, grant
headers, AccessControlPolicy XML) and render. Tolerance: byte equality.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
from email.utils import formatdate

import numpy as np
import pytest

from seaweedfs_tpu.s3api import acl as ref_acl
from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu_torch.s3api import acl as port_acl
from seaweedfs_tpu_torch.s3api import auth as port_auth

from .test_torch_s3 import s3_twin

AKID, SECRET = "adminKey", "adminSecret"
IDENTITIES = {"identities": [{"name": "admin",
                              "credentials": [{"accessKey": AKID, "secretKey": SECRET}],
                              "actions": ["Admin"]}]}
_SUBRESOURCES = {"acl", "uploads", "uploadId", "tagging", "versioning",
                 "versions", "policy", "lifecycle", "location", "delete"}


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    with s3_twin(str(tmp_path_factory.mktemp("s3v2")), IDENTITIES) as pair:
        yield pair


def _v2_sign(secret: str, sts: str) -> str:
    return base64.b64encode(hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()).decode()


def _v2_resource(path: str, query: str) -> str:
    sub = []
    for part in (query or "").split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        if k in _SUBRESOURCES:
            sub.append(f"{k}={v}" if v else k)
    return path + ("?" + "&".join(sorted(sub)) if sub else "")


def v2_request(s3, method: str, path: str, query: str = "", body: bytes = b"",
               ctype: str = "", amz: dict | None = None, secret: str = SECRET):
    """A stock V2-signing client (what boto2 and old SDKs send), on both sides."""

    def send(side):
        date = formatdate(usegmt=True)
        content_type = ctype or ("application/octet-stream" if body else "")
        headers = {"Date": date}
        if content_type:
            headers["Content-Type"] = content_type
        headers.update(amz or {})
        canon_amz = "".join(f"{k}:{v}\n" for k, v in sorted(
            (k.lower(), v) for k, v in (amz or {}).items()))
        sts = f"{method}\n\n{content_type}\n{date}\n{canon_amz}{_v2_resource(path, query)}"
        headers["Authorization"] = f"AWS {AKID}:{_v2_sign(secret, sts)}"
        url = side.s3.url + path + (f"?{query}" if query else "")
        return side.http_request(method, url, body or None, headers)

    return s3.call(send)


def acl_xml(s3, bucket: str, key: str | None = None) -> str:
    path = f"/{bucket}/{key}" if key else f"/{bucket}"
    status, _, body = s3.request("GET", path, query={"acl": ""})
    assert status == 200
    return body


# --- unit parity ----------------------------------------------------------------------
GRANTEES = ['id="alice"', 'id="bob"', 'uri="http://acs.amazonaws.com/groups/global/AllUsers"',
            'uri="http://acs.amazonaws.com/groups/global/AuthenticatedUsers"',
            'uri="http://acs.amazonaws.com/groups/s3/LogDelivery"',
            'emailAddress="ops@example.com"', 'emailAddress="not-an-email"',
            'uri="http://evil.example/all"', "justaname", 'id=""', " "]


def _answer(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # each package's S3ApiError, compared by field
        return ("err", getattr(e, "code", type(e).__name__), getattr(e, "status", 0), str(e))


@pytest.mark.parametrize("seed", range(8))
def test_acl_parse_and_render_equal_reference(seed):
    """extract_acl over seeded canned and grant headers, acp_to_xml_inner of
    the result, acp_from_xml of that render and of seeded bad documents,
    and dumps/loads: the same grants, XML and errors."""
    rng = np.random.default_rng([seed, 9])
    canned = sorted(ref_acl.CANNED_ACLS) + ["world-writable", ""]
    for _ in range(24):
        headers = {}
        if rng.random() < 0.5:
            headers["x-amz-acl"] = str(rng.choice(canned))
        for h in ref_acl.GRANT_HEADERS:
            if rng.random() < 0.3:
                n = int(rng.integers(1, 3))
                headers[h] = ",".join(str(g) for g in rng.choice(GRANTEES, size=n))
        owner = str(rng.choice(["admin", "alice"]))
        bucket_owner = str(rng.choice(["", "bob"]))
        got = [_answer(lambda m=m: m.extract_acl(dict(headers), owner, bucket_owner))
               for m in (ref_acl, port_acl)]
        assert got[1] == got[0]
        grants = got[1][1] if got[1][0] == "ok" else None
        if grants:
            inner = port_acl.acp_to_xml_inner(owner, grants)
            assert inner == ref_acl.acp_to_xml_inner(owner, grants)
            doc = (f'<AccessControlPolicy xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                   f"{inner}</AccessControlPolicy>").encode()
            assert port_acl.acp_from_xml(doc) == ref_acl.acp_from_xml(doc) == (owner, grants)
            raw = port_acl.dumps(owner, grants)
            assert raw == ref_acl.dumps(owner, grants)
            assert port_acl.loads(raw) == ref_acl.loads(raw) == (owner, grants)
    bad = [b"<AccessControlPolicy>", b"<AccessControlPolicy><AccessControlList><Grant>"
           b"<Permission>READ</Permission></Grant></AccessControlList></AccessControlPolicy>",
           b"<AccessControlPolicy><AccessControlList><Grant><Grantee><URI>http://x/y</URI>"
           b"</Grantee><Permission>READ</Permission></Grant></AccessControlList>"
           b"</AccessControlPolicy>",
           b"<AccessControlPolicy><AccessControlList><Grant><Grantee><ID>a</ID></Grantee>"
           b"<Permission>ALL</Permission></Grant></AccessControlList></AccessControlPolicy>"]
    for doc in bad:
        got = [_answer(lambda m=m: m.acp_from_xml(doc)) for m in (ref_acl, port_acl)]
        assert got[1] == got[0] and got[1][0] == "err"


# --- Signature V2 ---------------------------------------------------------------------
class TestSigV2:
    def test_header_roundtrip(self, s3):
        s3.api("create_bucket", "v2b")
        status, _, _ = v2_request(s3, "PUT", "/v2b/hello.txt", body=b"v2 payload",
                                  ctype="text/plain")
        assert status == 200
        status, _, body = v2_request(s3, "GET", "/v2b/hello.txt")
        assert status == 200 and body == b"v2 payload"
        status, _, body = v2_request(s3, "GET", "/v2b", query="acl")
        assert status == 200 and "AccessControlPolicy" in body
        s3.store("/buckets/v2b")

    def test_amz_headers_signed(self, s3):
        s3.api("create_bucket", "v2amz")
        status, _, _ = v2_request(s3, "PUT", "/v2amz/m.bin", body=b"x",
                                  amz={"x-amz-meta-color": "blue"})
        assert status == 200
        s3.store("/buckets/v2amz")

    def test_wrong_secret_rejected(self, s3):
        s3.api("create_bucket", "v2bad")
        status, _, body = v2_request(s3, "GET", "/v2bad/any", secret="not-the-secret")
        assert status == 403 and "SignatureDoesNotMatch" in body

    def test_presigned_get(self, s3):
        s3.api("create_bucket", "v2pre")
        s3.api("put_object", "v2pre", "p.txt", b"presigned v2")
        expires = str(int(time.time()) + 120)
        sig = _v2_sign(SECRET, f"GET\n\n\n{expires}\n/v2pre/p.txt")
        query = (f"?AWSAccessKeyId={AKID}&Expires={expires}"
                 f"&Signature={urllib.parse.quote(sig, safe='')}")
        status, _, body = s3.raw("GET", "/v2pre/p.txt" + query)
        assert status == 200 and body == b"presigned v2"

    def test_presigned_expired(self, s3):
        s3.api("create_bucket", "v2exp")
        s3.api("put_object", "v2exp", "p.txt", b"x")
        expires = str(int(time.time()) - 5)
        sig = _v2_sign(SECRET, f"GET\n\n\n{expires}\n/v2exp/p.txt")
        status, _, _ = s3.raw("GET", f"/v2exp/p.txt?AWSAccessKeyId={AKID}&Expires={expires}"
                                     f"&Signature={urllib.parse.quote(sig, safe='')}")
        assert status == 403

    def test_post_policy_v2_upload(self, s3):
        s3.api("create_bucket", "v2post")
        policy = base64.b64encode(json.dumps({
            "expiration": "2099-01-01T00:00:00Z",
            "conditions": [{"bucket": "v2post"}, ["starts-with", "$key", "up/"]],
        }).encode()).decode()
        sig = base64.b64encode(hmac.new(SECRET.encode(), policy.encode(),
                                        hashlib.sha1).digest()).decode()
        boundary = "xyzFORM"
        fields = [("key", "up/f.bin"), ("AWSAccessKeyId", AKID), ("policy", policy),
                  ("signature", sig)]
        parts = [f"--{boundary}\r\nContent-Disposition: form-data;"
                 f' name="{name}"\r\n\r\n{value}\r\n'.encode() for name, value in fields]
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data;"
                     f' name="file"; filename="f.bin"\r\n'
                     f"Content-Type: application/octet-stream\r\n\r\n".encode()
                     + b"V2POSTDATA\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        ctype = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
        status, _, resp = s3.raw("POST", "/v2post", body, ctype)
        assert status == 204, resp
        assert s3.api("get_object", "v2post", "up/f.bin") == b"V2POSTDATA"
        bad = body.replace(sig.encode(), b"AAAA" + sig.encode()[4:])
        status, _, _ = s3.raw("POST", "/v2post", bad, ctype)
        assert status == 403
        s3.store("/buckets/v2post")


# --- the ACL grant model --------------------------------------------------------------
class TestAclGrantModel:
    def test_canned_public_read(self, s3):
        s3.api("create_bucket", "aclb")
        status, _, _ = s3.request("PUT", "/aclb", query={"acl": ""},
                                  headers={"x-amz-acl": "public-read"})
        assert status == 200
        xml = acl_xml(s3, "aclb")
        assert "AllUsers" in xml and "READ" in xml and "FULL_CONTROL" in xml
        s3.entry("/buckets/aclb")

    def test_grant_headers_matrix(self, s3):
        s3.api("create_bucket", "aclg")
        status, _, _ = s3.request("PUT", "/aclg", query={"acl": ""}, headers={
            "x-amz-grant-read": 'id="alice", uri="http://acs.amazonaws.com/groups/'
                                'global/AuthenticatedUsers"',
            "x-amz-grant-full-control": 'id="bob"',
            "x-amz-grant-write-acp": 'emailAddress="ops@example.com"'})
        assert status == 200
        xml = acl_xml(s3, "aclg")
        assert "alice" in xml and "AuthenticatedUsers" in xml
        assert "bob" in xml and "FULL_CONTROL" in xml
        assert "ops@example.com" in xml and "WRITE_ACP" in xml
        s3.entry("/buckets/aclg")

    def test_invalid_grants_rejected(self, s3):
        s3.api("create_bucket", "aclx")
        for headers, code in (
                ({"x-amz-grant-read": 'uri="http://evil.example/all"'}, "InvalidArgument"),
                ({"x-amz-grant-read": "justaname"}, "InvalidArgument"),
                ({"x-amz-grant-read": 'emailAddress="not-an-email"'}, "InvalidArgument"),
                ({"x-amz-acl": "private", "x-amz-grant-read": 'id="alice"'}, "InvalidRequest"),
                ({"x-amz-acl": "world-writable"}, "InvalidArgument")):
            status, _, body = s3.request("PUT", "/aclx", query={"acl": ""}, headers=headers)
            assert status == 400 and code in body

    def test_object_acl_roundtrip_xml(self, s3):
        s3.api("create_bucket", "aclo")
        s3.api("put_object", "aclo", "o.txt", b"acl me")
        acp = ('<AccessControlPolicy><Owner><ID>admin</ID></Owner><AccessControlList>'
               '<Grant><Grantee xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
               'xsi:type="CanonicalUser"><ID>admin</ID></Grantee>'
               "<Permission>FULL_CONTROL</Permission></Grant>"
               '<Grant><Grantee xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
               'xsi:type="Group"><URI>http://acs.amazonaws.com/groups/global/AllUsers</URI>'
               "</Grantee><Permission>READ</Permission></Grant>"
               "</AccessControlList></AccessControlPolicy>").encode()
        status, _, _ = s3.request("PUT", "/aclo/o.txt", query={"acl": ""}, body=acp)
        assert status == 200
        xml = acl_xml(s3, "aclo", "o.txt")
        assert "AllUsers" in xml and "READ" in xml
        status, _, _ = s3.request("GET", "/aclo/missing", query={"acl": ""})
        assert status == 404
        s3.store("/buckets/aclo")

    def test_put_object_with_canned_acl_header(self, s3):
        s3.api("create_bucket", "aclput")
        status, _, _ = s3.request("PUT", "/aclput/obj.bin", body=b"data",
                                  headers={"x-amz-acl": "public-read"})
        assert status == 200
        assert "AllUsers" in acl_xml(s3, "aclput", "obj.bin")
        s3.store("/buckets/aclput")

    def test_default_acl_owner_full_control(self, s3):
        s3.api("create_bucket", "acldef")
        assert "FULL_CONTROL" in acl_xml(s3, "acldef")


class TestReviewHardening:
    def test_malformed_aws_header_rejected(self, s3):
        status, _, body = s3.raw("GET", "/", headers={"Authorization": "AWS adminKey"})
        assert status == 400 and "AuthorizationHeaderMalformed" in body

    def test_acp_owner_spoof_rejected(self, s3):
        s3.api("create_bucket", "aclown")
        s3.api("put_object", "aclown", "o.txt", b"x")
        acp = (b"<AccessControlPolicy><Owner><ID>intruder</ID></Owner>"
               b"<AccessControlList/></AccessControlPolicy>")
        status, _, body = s3.request("PUT", "/aclown/o.txt", query={"acl": ""}, body=acp)
        assert status == 403 and "AccessDenied" in body

    def test_owner_stable_across_callers(self, s3):
        s3.api("create_bucket", "aclstable")
        assert "<ID>admin</ID>" in acl_xml(s3, "aclstable")
        s3.api("put_object", "aclstable", "k.txt", b"x")
        assert "<ID>admin</ID>" in acl_xml(s3, "aclstable", "k.txt")

    def test_copy_object_acl_headers(self, s3):
        s3.api("create_bucket", "aclcopy")
        s3.api("put_object", "aclcopy", "src.txt", b"copy me")
        status, _, _ = s3.request("PUT", "/aclcopy/dst.txt", headers={
            "x-amz-copy-source": "/aclcopy/src.txt", "x-amz-acl": "public-read"})
        assert status == 200
        assert "AllUsers" in acl_xml(s3, "aclcopy", "dst.txt")
        status, _, _ = s3.request("PUT", "/aclcopy/dst2.txt", headers={
            "x-amz-copy-source": "/aclcopy/src.txt", "x-amz-grant-read": "bogus"})
        assert status == 400
        assert s3.api("head_object", "aclcopy", "dst2.txt") is None
        s3.store("/buckets/aclcopy")


def test_v2_string_to_sign_helpers_equal_reference():
    """The V2 canonical resource and amz-header helpers on seeded inputs."""
    rng = np.random.default_rng(10)
    subs = sorted(ref_auth.IdentityAccessManagement._V2_SUBRESOURCES) + ["x", "prefix"]
    for _ in range(64):
        pairs = [(str(rng.choice(subs)), str(rng.choice(["", "1", "a b"])))
                 for _ in range(int(rng.integers(0, 4)))]
        path = str(rng.choice(["", "/", "/b", "/b/k"]))
        assert port_auth.IdentityAccessManagement._v2_canonical_resource(path, pairs) == \
            ref_auth.IdentityAccessManagement._v2_canonical_resource(path, pairs)
        headers = {str(rng.choice(["X-Amz-Meta-A", "x-amz-date", "Content-Type", "x-amz-b"])):
                   "  v   " + str(rng.integers(9)) for _ in range(3)}
        assert port_auth.IdentityAccessManagement._v2_canonical_amz_headers(headers) == \
            ref_auth.IdentityAccessManagement._v2_canonical_amz_headers(headers)
