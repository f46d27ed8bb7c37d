"""The port's bucket policy engine, CORS, lifecycle, POST-policy uploads,
versioning and aws-chunked uploads held against the JAX gateway's, case for
case with `tests/test_s3_policy_cors_lifecycle.py`, through `s3_twin()` of
`tests/test_torch_s3.py` (the same requests to both gateways, answers and
stored entries equal after `S3Norm`). Lifecycle expiry runs through
`run_lifecycle_sweep(now=)` on both sides, never a wait.

Unit parity on seeded inputs: bucket-policy evaluation and validation,
POST-policy checks under one frozen clock, and `Request.multipart_form`
on seeded multipart bodies (fields, a file part, a part with no filename,
a malformed boundary). Tolerance: byte equality.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time

import numpy as np
import pytest

from seaweedfs_tpu.s3api import policy as ref_policy
from seaweedfs_tpu.server.httpd import Request as RefRequest
from seaweedfs_tpu_torch.s3api import policy as port_policy
from seaweedfs_tpu_torch.s3api.auth import STREAMING_PAYLOAD, canonical_request, signing_key
from seaweedfs_tpu_torch.s3api.auth import string_to_sign
from seaweedfs_tpu_torch.s3api.sigv4_client import S3Error
from seaweedfs_tpu_torch.server.httpd import Request

from .test_torch_filer_meta import seeded
from .test_torch_s3 import bucket_name, drop_bucket, make_bucket, s3_twin

IDENTITIES = {
    "identities": [
        {
            "name": "admin",
            "credentials": [{"accessKey": "adminKey", "secretKey": "adminSecret"}],
            "actions": ["Admin"],
        },
        {
            "name": "alice",
            "credentials": [{"accessKey": "aliceKey", "secretKey": "aliceSecret"}],
            "actions": [],  # everything must come from bucket policy
        },
        {
            "name": "bob",
            "credentials": [{"accessKey": "bobKey", "secretKey": "bobSecret"}],
            "actions": ["Read", "List", "Write"],  # broad IAM; policy can Deny
        },
    ]
}
ALICE = ("aliceKey", "aliceSecret")
BOB = ("bobKey", "bobSecret")


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    with s3_twin(str(tmp_path_factory.mktemp("s3pol")), IDENTITIES) as pair:
        yield pair


@pytest.fixture()
def bucket(s3, request):
    name = make_bucket(s3, bucket_name(request))
    yield name
    drop_bucket(s3, name)


def put_policy(s3, bucket, doc) -> None:
    status, _, body = s3.request("PUT", f"/{bucket}", query=[("policy", "")],
                                 body=json.dumps(doc).encode())
    assert status == 204, body


# --- unit parity ----------------------------------------------------------------------
def _seeded_policy(rng, bucket: str) -> dict:
    actions = ["s3:GetObject", "s3:PutObject", "s3:*", "s3:Get*", "s3:ListBucket",
               "S3:getobject", "s3:Delete?bject", "s3:PutBucketPolicy"]
    principals = ["*", {"AWS": "alice"}, {"AWS": ["bob", "al*"]}, {"AWS": "c?rol"}]
    resources = [f"arn:aws:s3:::{bucket}", f"arn:aws:s3:::{bucket}/*",
                 f"arn:aws:s3:::{bucket}/pub/*", f"arn:aws:s3:::{bucket}/a?c/*"]
    stmts = []
    for _ in range(int(rng.integers(1, 5))):
        stmts.append({
            "Effect": str(rng.choice(["Allow", "Deny"])),
            "Principal": principals[int(rng.integers(len(principals)))],
            "Action": [actions[int(i)] for i in rng.integers(len(actions), size=2)],
            "Resource": [resources[int(i)] for i in rng.integers(len(resources), size=2)],
        })
    return {"Version": "2012-10-17", "Statement": stmts}


@pytest.mark.parametrize("seed", range(8))
def test_policy_evaluation_equal_reference(seed):
    """evaluate(), validate() and _wild_match() on seeded documents,
    principals, actions and resources."""
    rng = np.random.default_rng([seed, 6])
    for _ in range(8):
        doc = _seeded_policy(rng, "bkt")
        raw = json.dumps(doc).encode()
        assert port_policy.validate(raw, "bkt") == ref_policy.validate(raw, "bkt")
        for _ in range(16):
            who = str(rng.choice(["alice", "bob", "carol", "anonymous", "al"]))
            act = str(rng.choice(["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
                                  "s3:ListBucket", "s3:getobjecttagging"]))
            key = str(rng.choice(["", "pub/x.txt", "abc/d", "priv/y"]))
            res = ref_policy.arn("bkt", key)
            assert port_policy.arn("bkt", key) == res
            assert port_policy.evaluate(doc, who, act, res) == \
                ref_policy.evaluate(doc, who, act, res)
            pattern = str(rng.choice(["*", "a?c*", "pub/*", "x", "*.txt"]))
            assert port_policy._wild_match(pattern, key, ci=bool(seed % 2)) == \
                ref_policy._wild_match(pattern, key, ci=bool(seed % 2))
    bad = [{"Version": "x", "Statement": []}, {"Version": "2012-10-17"}, [],
           {"Version": "2012-10-17", "Statement": [{"Effect": "Allow", "Principal": "*",
            "Action": "s3:GetObject", "Resource": "arn:aws:s3:::other/*"}]}]
    for doc in bad:
        errors = []
        for mod in (ref_policy, port_policy):
            with pytest.raises(ValueError) as ei:
                mod.validate(json.dumps(doc).encode(), "bkt")
            errors.append(str(ei.value))
        assert errors[1] == errors[0]


@pytest.mark.parametrize("seed", range(6))
def test_post_policy_checks_equal_reference(seed, monkeypatch):
    """check_post_policy on seeded forms under one frozen clock."""
    now = 1_800_000_000.0
    monkeypatch.setattr(time, "time", lambda: now)
    rng = np.random.default_rng([seed, 7])
    for _ in range(24):
        exp = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                            time.gmtime(now + int(rng.integers(-30, 30))))
        conds = [{"bucket": "b"}, ["starts-with", "$key", str(rng.choice(["up/", "x", ""]))],
                 ["content-length-range", 0, int(rng.integers(0, 64))]]
        if rng.random() < 0.3:
            conds.append(["eq", "$x-amz-meta-tag", "v"])
        if rng.random() < 0.1:
            conds.append(["regex", "$key", "."])
        doc = {"expiration": exp, "conditions": conds}
        fields = {"bucket": "b", "key": str(rng.choice(["up/f", "xf", "other"])),
                  "policy": "p", "x-amz-signature": "s"}
        if rng.random() < 0.3:
            fields["x-amz-meta-tag"] = str(rng.choice(["v", "w"]))
        if rng.random() < 0.2:
            fields["sneaky"] = "1"
        size = int(rng.integers(0, 80))
        answers = []
        for mod in (ref_policy, port_policy):
            try:
                mod.check_post_policy(doc, dict(fields), size)
                answers.append("ok")
            except ValueError as e:
                answers.append(str(e))
        assert answers[1] == answers[0]


def _form_request(cls, ctype: str, body: bytes):
    req = cls.__new__(cls)
    req.headers = {"Content-Type": ctype}
    req._body = body
    return req


def _seeded_form(rng) -> tuple[bytes, str]:
    boundary = f"b{int(rng.integers(1 << 30)):x}"
    parts = []
    for i in range(int(rng.integers(0, 5))):
        value = rng.bytes(int(rng.integers(0, 40))).hex()
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="f{i}"\r\n\r\n'
                     f"{value}\r\n".encode())
    kind = int(rng.integers(0, 3))
    if kind == 0:  # a file part
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                     f'filename="n{int(rng.integers(99))}.bin"\r\nContent-Type: '
                     f"application/octet-stream\r\n\r\n".encode()
                     + rng.bytes(int(rng.integers(0, 2000))) + b"\r\n")
    elif kind == 1:  # a part with no filename, and one with no name
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"\r\n\r\n'
                     f"plain\r\n".encode())
        parts.append(f"--{boundary}\r\nX-Other: 1\r\n\r\nnameless\r\n".encode())
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("seed", range(8))
def test_multipart_form_equal_reference(seed):
    """The port's `Request.multipart_form` against the JAX parser on seeded
    bodies, a quoted boundary, a malformed boundary and a non-form body."""
    rng = np.random.default_rng([seed, 8])
    cases = []
    for _ in range(6):
        body, ctype = _seeded_form(rng)
        cases.append((ctype, body))
        cases.append((ctype.replace("boundary=", 'boundary="') + '"', body))
    body, ctype = _seeded_form(rng)
    cases += [(ctype.replace("boundary=b", "boundary=zz"), body),  # malformed boundary
              ("multipart/form-data", body),  # no boundary at all
              ("application/octet-stream", body)]
    for ctype, body in cases:
        want = _form_request(RefRequest, ctype, body).multipart_form()
        got = _form_request(Request, ctype, body).multipart_form()
        assert got == want
    assert any(_form_request(Request, c, b).multipart_form()[1] for c, b in cases)


# --- bucket policy --------------------------------------------------------------------
class TestBucketPolicy:
    def test_policy_crud(self, s3, bucket):
        status, _, _ = s3.request("GET", f"/{bucket}", query=[("policy", "")])
        assert status == 404  # NoSuchBucketPolicy
        doc = {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
            "Resource": f"arn:aws:s3:::{bucket}/*"}]}
        put_policy(s3, bucket, doc)
        status, _, body = s3.request("GET", f"/{bucket}", query=[("policy", "")])
        assert status == 200 and json.loads(body)["Version"] == "2012-10-17"
        s3.entry(f"/buckets/{bucket}")
        status, _, _ = s3.request("DELETE", f"/{bucket}", query=[("policy", "")])
        assert status == 204
        status, _, _ = s3.request("GET", f"/{bucket}", query=[("policy", "")])
        assert status == 404

    @pytest.mark.parametrize("doc,msg", [
        ({"Version": "bad", "Statement": []}, "Version"),
        ({"Version": "2012-10-17", "Statement": []}, "Statement"),
        ({"Version": "2012-10-17", "Statement": [{"Effect": "Allow",
          "Principal": "*", "Action": "s3:Get", "Resource": "arn:aws:s3:::other/*"}]},
         "bucket"),
        ({"Version": "2012-10-17", "Statement": [{"Effect": "Allow",
          "Principal": "*", "Action": "s3:GetObject",
          "Resource": "arn:aws:s3:::BUCKET/*", "Condition": {}}]}, "Condition"),
    ])
    def test_policy_validation_rejects(self, s3, bucket, doc, msg):
        payload = json.dumps(doc).replace("BUCKET", bucket).encode()
        status, _, body = s3.request("PUT", f"/{bucket}", query=[("policy", "")], body=payload)
        assert status == 400 and msg in body, body

    def test_allow_grants_beyond_iam(self, s3, bucket):
        s3.api("put_object", bucket, "pub/x.txt", b"hello")
        s3.api("put_object", bucket, "priv/y.txt", b"secret")
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "pub/x.txt", creds=ALICE)  # no IAM, no policy
        put_policy(s3, bucket, {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": {"AWS": ["alice"]}, "Action": ["s3:GetObject"],
            "Resource": f"arn:aws:s3:::{bucket}/pub/*"}]})
        assert s3.api("get_object", bucket, "pub/x.txt", creds=ALICE) == b"hello"
        with pytest.raises(S3Error):  # resource scope enforced
            s3.api("get_object", bucket, "priv/y.txt", creds=ALICE)
        with pytest.raises(S3Error):  # action scope enforced
            s3.api("put_object", bucket, "pub/new.txt", b"nope", creds=ALICE)

    def test_explicit_deny_beats_iam(self, s3, bucket):
        s3.api("put_object", bucket, "blocked/z.txt", b"data")
        assert s3.api("get_object", bucket, "blocked/z.txt", creds=BOB) == b"data"
        put_policy(s3, bucket, {"Version": "2012-10-17", "Statement": [{
            "Effect": "Deny", "Principal": {"AWS": "bob"}, "Action": "s3:*",
            "Resource": [f"arn:aws:s3:::{bucket}", f"arn:aws:s3:::{bucket}/*"]}]})
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "blocked/z.txt", creds=BOB)
        assert s3.api("get_object", bucket, "blocked/z.txt") == b"data"  # others fine

    def test_anonymous_allowed_by_star_principal(self, s3, bucket):
        s3.api("put_object", bucket, "www/index.html", b"<h1>hi</h1>")
        status, _, _ = s3.raw("GET", f"/{bucket}/www/index.html")
        assert status == 403
        put_policy(s3, bucket, {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
            "Resource": f"arn:aws:s3:::{bucket}/www/*"}]})
        status, _, body = s3.raw("GET", f"/{bucket}/www/index.html")
        assert status == 200 and body == "<h1>hi</h1>"  # an XML-like body, normalized
        status, _, _ = s3.raw("PUT", f"/{bucket}/www/index.html", b"x")  # write still denied
        assert status == 403


CORS_XML = b"""<CORSConfiguration>
 <CORSRule>
   <AllowedOrigin>https://app.example.com</AllowedOrigin>
   <AllowedMethod>GET</AllowedMethod>
   <AllowedMethod>PUT</AllowedMethod>
   <AllowedHeader>Content-Type</AllowedHeader>
   <AllowedHeader>x-amz-*</AllowedHeader>
   <ExposeHeader>ETag</ExposeHeader>
   <MaxAgeSeconds>1800</MaxAgeSeconds>
 </CORSRule>
</CORSConfiguration>"""


class TestCors:
    def test_cors_crud_and_preflight(self, s3, bucket):
        status, _, _ = s3.request("GET", f"/{bucket}", query=[("cors", "")])
        assert status == 404
        status, _, _ = s3.request("PUT", f"/{bucket}", query=[("cors", "")], body=CORS_XML)
        assert status == 200
        status, _, body = s3.request("GET", f"/{bucket}", query=[("cors", "")])
        assert status == 200 and "CORSRule" in body
        # preflight: matching origin and method
        status, headers, _ = s3.raw("OPTIONS", f"/{bucket}/any/key", headers={
            "Origin": "https://app.example.com", "Access-Control-Request-Method": "PUT",
            "Access-Control-Request-Headers": "content-type, x-amz-date"})
        assert status == 200
        assert headers["Access-Control-Allow-Origin"] == "https://app.example.com"
        assert "PUT" in headers["Access-Control-Allow-Methods"]
        assert headers["Access-Control-Max-Age"] == "1800"
        # mismatched origin, disallowed method: 403; the bucket level too
        status, _, _ = s3.raw("OPTIONS", f"/{bucket}/any/key", headers={
            "Origin": "https://evil.example.com", "Access-Control-Request-Method": "GET"})
        assert status == 403
        status, _, _ = s3.raw("OPTIONS", f"/{bucket}/any/key", headers={
            "Origin": "https://app.example.com", "Access-Control-Request-Method": "DELETE"})
        assert status == 403
        status, _, _ = s3.raw("OPTIONS", f"/{bucket}", headers={
            "Origin": "https://app.example.com", "Access-Control-Request-Method": "GET"})
        assert status == 200

    def test_response_headers_on_actual_request(self, s3, bucket):
        s3.request("PUT", f"/{bucket}", query=[("cors", "")], body=CORS_XML)
        s3.api("put_object", bucket, "c.txt", b"data")
        status, headers, _ = s3.request("GET", f"/{bucket}/c.txt",
                                        headers={"Origin": "https://app.example.com"})
        assert status == 200
        assert headers.get("Access-Control-Allow-Origin") == "https://app.example.com"
        assert headers.get("Access-Control-Expose-Headers") == "ETag"
        s3.request("DELETE", f"/{bucket}", query=[("cors", "")])
        status, headers, _ = s3.request("GET", f"/{bucket}/c.txt",
                                        headers={"Origin": "https://app.example.com"})
        assert status == 200
        assert "Access-Control-Allow-Origin" not in headers


LIFECYCLE_XML = b"""<LifecycleConfiguration>
  <Rule>
    <ID>expire-tmp</ID>
    <Prefix>tmp/</Prefix>
    <Status>Enabled</Status>
    <Expiration><Days>7</Days></Expiration>
  </Rule>
</LifecycleConfiguration>"""


def sweep(s3, days: float = 0) -> dict:
    """run_lifecycle_sweep on both gateways; equal answers."""
    out = s3.each(lambda s: s.s3.run_lifecycle_sweep(
        now=time.time() + days * 86400 if days else None))
    assert out[1] == out[0]
    return out[1]


class TestLifecycle:
    def test_lifecycle_crud(self, s3, bucket):
        status, _, _ = s3.request("GET", f"/{bucket}", query=[("lifecycle", "")])
        assert status == 404
        status, _, _ = s3.request("PUT", f"/{bucket}", query=[("lifecycle", "")],
                                  body=LIFECYCLE_XML)
        assert status == 200
        status, _, body = s3.request("GET", f"/{bucket}", query=[("lifecycle", "")])
        assert status == 200 and "expire-tmp" in body
        status, _, _ = s3.request("DELETE", f"/{bucket}", query=[("lifecycle", "")])
        assert status == 204

    def test_expiry_sweep(self, s3, bucket):
        s3.request("PUT", f"/{bucket}", query=[("lifecycle", "")], body=LIFECYCLE_XML)
        s3.api("put_object", bucket, "tmp/old.txt", b"old")
        s3.api("put_object", bucket, "tmp/sub/old2.txt", b"old2")
        s3.api("put_object", bucket, "keep/old.txt", b"kept")  # prefix-excluded
        s3.api("put_object", bucket, "tmp/fresh.txt", b"fresh")
        assert sweep(s3) == {}  # nothing old enough yet
        assert sweep(s3, days=8) == {bucket: 3}  # all three aged now
        assert s3.api("get_object", bucket, "keep/old.txt") == b"kept"
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "tmp/old.txt")
        s3.store(f"/buckets/{bucket}")


class TestPostPolicyUpload:
    """Browser POST form upload with a SigV4-signed policy document."""

    @staticmethod
    def _form(fields: dict, file_data: bytes, filename="f.bin") -> tuple[bytes, str]:
        boundary = "testboundary123"
        out = b""
        for k, v in fields.items():
            out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="{k}"\r\n\r\n{v}\r\n').encode()
        out += (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                f'filename="{filename}"\r\nContent-Type: text/plain\r\n\r\n').encode() \
            + file_data + f"\r\n--{boundary}--\r\n".encode()
        return out, f"multipart/form-data; boundary={boundary}"

    @staticmethod
    def _signed_fields(key_tpl, bucket, extra_conditions=(), expires_in=600,
                       access="adminKey", secret="adminSecret"):
        date = time.strftime("%Y%m%d", time.gmtime())
        cred = f"{access}/{date}/us-east-1/s3/aws4_request"
        policy = {
            "expiration": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime(time.time() + expires_in)),
            "conditions": [{"bucket": bucket},
                           ["starts-with", "$key", key_tpl.split("${filename}")[0]],
                           ["content-length-range", 0, 1048576],
                           {"x-amz-credential": cred},
                           {"x-amz-algorithm": "AWS4-HMAC-SHA256"}, *extra_conditions],
        }
        policy_b64 = base64.b64encode(json.dumps(policy).encode()).decode()
        sig = hmac.new(signing_key(secret, date, "us-east-1", "s3"), policy_b64.encode(),
                       hashlib.sha256).hexdigest()
        return {"key": key_tpl, "policy": policy_b64, "x-amz-algorithm": "AWS4-HMAC-SHA256",
                "x-amz-credential": cred, "x-amz-signature": sig}

    @staticmethod
    def _post(s3, bucket, body, ctype):
        return s3.raw("POST", f"/{bucket}", body, {"Content-Type": ctype})

    def test_post_upload_roundtrip(self, s3, bucket):
        fields = self._signed_fields("up/${filename}", bucket)
        fields["success_action_status"] = "201"
        body, ctype = self._form(fields, b"posted bytes", filename="hello.txt")
        status, headers, resp = self._post(s3, bucket, body, ctype)
        assert status == 201, resp
        assert "<Key>up/hello.txt</Key>" in resp
        assert headers["ETag"] == f'"{hashlib.md5(b"posted bytes").hexdigest()}"'
        assert s3.api("get_object", bucket, "up/hello.txt") == b"posted bytes"
        fields = self._signed_fields("up/plain", bucket)  # the default 204
        body, ctype = self._form(fields, seeded(3000, 13))
        assert self._post(s3, bucket, body, ctype)[0] == 204
        s3.store(f"/buckets/{bucket}")

    def test_post_upload_bad_signature(self, s3, bucket):
        fields = self._signed_fields("up/x", bucket)
        fields["x-amz-signature"] = "0" * 64
        body, ctype = self._form(fields, b"nope")
        status, _, resp = self._post(s3, bucket, body, ctype)
        assert status == 403, resp

    def test_post_upload_policy_violations(self, s3, bucket):
        fields = self._signed_fields("up/only", bucket)  # key outside starts-with
        fields["key"] = "elsewhere/file"
        body, ctype = self._form(fields, b"x")
        assert self._post(s3, bucket, body, ctype)[0] == 403
        fields = self._signed_fields("up/x", bucket, expires_in=-5)  # expired
        body, ctype = self._form(fields, b"x")
        assert self._post(s3, bucket, body, ctype)[0] == 403
        fields = self._signed_fields("up/x", bucket)  # uncovered extra field
        fields["sneaky-field"] = "1"
        body, ctype = self._form(fields, b"x")
        assert self._post(s3, bucket, body, ctype)[0] == 403
        fields = self._signed_fields("up/x", bucket,
                                     extra_conditions=(["content-length-range", 0, 3],))
        body, ctype = self._form(fields, b"four+")  # too large for its range
        assert self._post(s3, bucket, body, ctype)[0] == 403


def enable_versioning(s3, bucket, status=b"Enabled"):
    code, _, body = s3.request(
        "PUT", f"/{bucket}", query=[("versioning", "")],
        body=b"<VersioningConfiguration><Status>" + status + b"</Status></VersioningConfiguration>")
    assert code == 200, body


class TestVersioning:
    """Version ids on PUT, old versions readable by id, delete markers,
    permanent version deletion with promotion, ListObjectVersions."""

    def test_versioning_config(self, s3, bucket):
        status, _, body = s3.request("GET", f"/{bucket}", query=[("versioning", "")])
        assert status == 200 and "<Status>" not in body
        enable_versioning(s3, bucket)
        status, _, body = s3.request("GET", f"/{bucket}", query=[("versioning", "")])
        assert "<Status>Enabled</Status>" in body

    def test_put_get_delete_versions(self, s3, bucket):
        enable_versioning(s3, bucket)
        _, h1, _ = s3.request("PUT", f"/{bucket}/v.txt", body=b"one")
        v1 = h1["x-amz-version-id"]
        _, h2, _ = s3.request("PUT", f"/{bucket}/v.txt", body=b"two")
        v2 = h2["x-amz-version-id"]
        assert v1 != v2 and v1.startswith("vid")
        assert s3.api("get_object", bucket, "v.txt") == b"two"
        status, _, body = s3.request("GET", f"/{bucket}/v.txt", query=[("versionId", v1)])
        assert status == 200 and body == b"one"
        status, h, _ = s3.request("DELETE", f"/{bucket}/v.txt")
        assert h.get("x-amz-delete-marker") == "true"
        marker_vid = h["x-amz-version-id"]
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "v.txt")
        status, _, body = s3.request("GET", f"/{bucket}/v.txt", query=[("versionId", v2)])
        assert status == 200 and body == b"two"
        status, h, _ = s3.request("GET", f"/{bucket}/v.txt", query=[("versionId", marker_vid)])
        assert status == 405 and h.get("x-amz-delete-marker") == "true"
        s3.store(f"/buckets/{bucket}")
        s3.request("DELETE", f"/{bucket}/v.txt", query=[("versionId", marker_vid)])
        assert s3.api("get_object", bucket, "v.txt") == b"two"
        s3.request("DELETE", f"/{bucket}/v.txt", query=[("versionId", v2)])
        assert s3.api("get_object", bucket, "v.txt") == b"one"
        s3.store(f"/buckets/{bucket}")

    def test_list_versions(self, s3, bucket):
        enable_versioning(s3, bucket)
        s3.request("PUT", f"/{bucket}/a.txt", body=b"1")
        s3.request("PUT", f"/{bucket}/a.txt", body=b"22")
        s3.request("DELETE", f"/{bucket}/b.txt")  # marker for an absent key
        s3.request("PUT", f"/{bucket}/sub/c.txt", body=b"3")
        status, _, text = s3.request("GET", f"/{bucket}", query=[("versions", "")])
        assert status == 200
        assert text.count("<Key>a.txt</Key>") == 2
        assert "<DeleteMarker><Key>b.txt</Key>" in text
        assert "<Key>sub/c.txt</Key>" in text
        assert text.count("<IsLatest>true</IsLatest>") >= 3
        s3.request("GET", f"/{bucket}", query=[("versions", ""), ("max-keys", "1")])

    def test_suspended_uses_null_vid(self, s3, bucket):
        enable_versioning(s3, bucket)
        s3.request("PUT", f"/{bucket}/s.txt", body=b"real")
        enable_versioning(s3, bucket, b"Suspended")
        _, h, _ = s3.request("PUT", f"/{bucket}/s.txt", body=b"null-v")
        assert h["x-amz-version-id"] == "null"
        assert s3.api("get_object", bucket, "s.txt") == b"null-v"


class TestStreamingChunkedUpload:
    """aws-chunked (STREAMING-AWS4-HMAC-SHA256-PAYLOAD) PUT end to end."""

    def test_streaming_put_roundtrip(self, s3, bucket):
        data = seeded(150_000, 14)
        chunks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
        body = b""
        for c in chunks + [b""]:
            body += f"{len(c):x};chunk-signature={'0' * 64}\r\n".encode() + c + b"\r\n"
        path = f"/{bucket}/streamed.bin"

        def put(side):
            now = time.gmtime()
            amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
            date = time.strftime("%Y%m%d", now)
            headers = {"content-encoding": "aws-chunked",
                       "host": side.s3.url.split("//")[-1],
                       "x-amz-content-sha256": STREAMING_PAYLOAD, "x-amz-date": amz_date,
                       "x-amz-decoded-content-length": str(len(data))}
            signed = sorted(headers)
            canon = canonical_request("PUT", path, [], headers, signed, STREAMING_PAYLOAD)
            scope = f"{date}/us-east-1/s3/aws4_request"
            sig = hmac.new(signing_key("adminSecret", date, "us-east-1", "s3"),
                           string_to_sign(amz_date, scope, canon).encode(),
                           hashlib.sha256).hexdigest()
            headers["Authorization"] = (f"AWS4-HMAC-SHA256 Credential=adminKey/{scope}, "
                                        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
            return side.http_request("PUT", side.s3.url + path, body, headers)

        status, headers, resp = s3.call(put)
        assert status == 200, resp
        assert headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
        assert s3.api("get_object", bucket, "streamed.bin") == data
        s3.store(f"/buckets/{bucket}")


class TestVersioningEdges:
    """Suspension preserves retained versions; batch delete and lifecycle
    expiry leave markers on versioned buckets instead of destroying data."""

    def test_suspension_preserves_real_versions(self, s3, bucket):
        enable_versioning(s3, bucket)
        _, h1, _ = s3.request("PUT", f"/{bucket}/k.txt", body=b"enabled-era")
        v1 = h1["x-amz-version-id"]
        enable_versioning(s3, bucket, b"Suspended")
        s3.request("PUT", f"/{bucket}/k.txt", body=b"null-era")
        status, _, body = s3.request("GET", f"/{bucket}/k.txt", query=[("versionId", v1)])
        assert status == 200 and body == b"enabled-era"
        assert s3.api("get_object", bucket, "k.txt") == b"null-era"
        s3.store(f"/buckets/{bucket}")

    def test_batch_delete_leaves_markers(self, s3, bucket):
        enable_versioning(s3, bucket)
        _, h, _ = s3.request("PUT", f"/{bucket}/bd.txt", body=b"keepme")
        vid = h["x-amz-version-id"]
        s3.api("delete_objects", bucket, ["bd.txt"])
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "bd.txt")
        status, _, body = s3.request("GET", f"/{bucket}/bd.txt", query=[("versionId", vid)])
        assert status == 200 and body == b"keepme"

    def test_lifecycle_expiry_leaves_markers(self, s3, bucket):
        enable_versioning(s3, bucket)
        s3.request("PUT", f"/{bucket}", query=[("lifecycle", "")], body=LIFECYCLE_XML)
        _, h, _ = s3.request("PUT", f"/{bucket}/tmp/x.txt", body=b"versioned")
        vid = h["x-amz-version-id"]
        assert sweep(s3, days=8) == {bucket: 1}
        with pytest.raises(S3Error):
            s3.api("get_object", bucket, "tmp/x.txt")
        status, _, body = s3.request("GET", f"/{bucket}/tmp/x.txt", query=[("versionId", vid)])
        assert status == 200 and body == b"versioned"
        s3.store(f"/buckets/{bucket}")
