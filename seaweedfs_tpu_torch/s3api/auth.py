"""AWS Signature V4 verification + identity/action authorization.

Reference: `weed/s3api/auth_credentials.go` (identities and actions),
`auth_signature_v4.go` (canonical request / string-to-sign / signing key),
`s3_constants/` (action names). Identities come from a JSON config
(`s3.json` style) or the filer's `/etc/iam/identity.json`, hot-reloaded via
the metadata subscription (`auth_credentials_subscribe.go`).

The port's copy of `seaweedfs_tpu/s3api/auth.py`.
"""

from __future__ import annotations

import calendar
import hashlib
import hmac
import json
import time
import urllib.parse

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


class S3ApiError(Exception):
    """Maps to an S3 XML error response."""

    def __init__(self, code: str, message: str, status: int) -> None:
        super().__init__(message)
        self.code = code
        self.message = message
        self.status = status


ERRORS = {
    "AccessDenied": 403,
    "InvalidAccessKeyId": 403,
    "SignatureDoesNotMatch": 403,
    "AuthorizationHeaderMalformed": 400,
    "RequestTimeTooSkewed": 403,
    "NoSuchBucket": 404,
    "NoSuchKey": 404,
    "NoSuchUpload": 404,
    "NoSuchTagSet": 404,
    "NoSuchBucketPolicy": 404,
    "NoSuchCORSConfiguration": 404,
    "NoSuchLifecycleConfiguration": 404,
    "MalformedPolicy": 400,
    "MalformedPOSTRequest": 400,
    "BucketAlreadyExists": 409,
    "BucketNotEmpty": 409,
    "InvalidBucketName": 400,
    "MalformedXML": 400,
    "InvalidPart": 400,
    "InvalidPartOrder": 400,
    "EntityTooSmall": 400,
    "InvalidArgument": 400,
    "InvalidRange": 416,
    "SlowDown": 503,
    "NotImplemented": 501,
    "InternalError": 500,
}


def err(code: str, message: str = "") -> S3ApiError:
    return S3ApiError(code, message or code, ERRORS.get(code, 400))


class Identity:
    def __init__(
        self,
        name: str,
        credentials: list[tuple[str, str]],
        actions: list[str],
        account_id: str = "",
    ) -> None:
        self.name = name
        self.credentials = credentials  # [(access_key, secret_key)]
        self.actions = actions  # e.g. ["Admin"] or ["Read:bucket", "Write:bucket"]
        self.account_id = account_id or name

    def is_anonymous(self) -> bool:
        return self.name == "anonymous"

    def can_do(self, action: str, bucket: str = "", object_key: str = "") -> bool:
        """Action match per the reference's Identity.canDo
        (`auth_credentials.go:350`): "Admin" grants all; "<Action>" grants
        the action on every bucket; "<Action>:bucket" and
        "<Action>:bucket/prefix*" scope it."""
        if ACTION_ADMIN in self.actions:
            return True
        if action in self.actions:
            return True
        if not bucket:
            return False
        target = f"{action}:{bucket}"
        limited = f"{target}/{object_key.lstrip('/')}"
        for granted in self.actions:
            if granted == target:
                return True
            if granted.endswith("*") and limited.startswith(granted[:-1]):
                return True
        return False

    @staticmethod
    def from_dict(d: dict) -> "Identity":
        return Identity(
            name=d.get("name", ""),
            credentials=[
                (c["accessKey"], c["secretKey"])
                for c in d.get("credentials", [])
            ],
            actions=list(d.get("actions", [])),
            account_id=d.get("account_id", ""),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "credentials": [
                {"accessKey": a, "secretKey": s} for a, s in self.credentials
            ],
            "actions": self.actions,
            "account_id": self.account_id,
        }


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query_pairs: list[tuple[str, str]]) -> str:
    pairs = sorted(
        (uri_encode(k), uri_encode(v)) for k, v in query_pairs
        if k != "X-Amz-Signature"
    )
    return "&".join(f"{k}={v}" for k, v in pairs)


def canonical_request(
    method: str,
    path: str,
    query_pairs: list[tuple[str, str]],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method,
            uri_encode(path, encode_slash=False),
            canonical_query(query_pairs),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canon_req.encode()).hexdigest(),
        ]
    )


class IdentityAccessManagement:
    """Identity registry + request authentication."""

    def __init__(self, identities: list[Identity] | None = None,
                 domain: str = "", allow_anonymous_when_empty: bool = True) -> None:
        self.identities: list[Identity] = identities or []
        self.domain = domain
        self.allow_anonymous_when_empty = allow_anonymous_when_empty
        self._by_access_key: dict[str, tuple[Identity, str]] = {}
        self._reindex()

    def _reindex(self) -> None:
        self._by_access_key = {
            ak: (ident, sk)
            for ident in self.identities
            for ak, sk in ident.credentials
        }

    def load_config(self, config: dict) -> None:
        self.identities = [
            Identity.from_dict(d) for d in config.get("identities", [])
        ]
        self._reindex()

    def load_json(self, payload: bytes) -> None:
        self.load_config(json.loads(payload))

    def is_enabled(self) -> bool:
        return bool(self.identities)

    def lookup(self, access_key: str) -> tuple[Identity, str]:
        found = self._by_access_key.get(access_key)
        if found is None:
            raise err("InvalidAccessKeyId", f"unknown access key {access_key}")
        return found

    def anonymous_identity(self) -> Identity:
        for ident in self.identities:
            if ident.name == "anonymous":
                return ident
        if not self.identities and self.allow_anonymous_when_empty:
            return Identity("anonymous", [], [ACTION_ADMIN])
        raise err("AccessDenied", "anonymous access disabled")

    # --- request authentication -------------------------------------------------
    def authenticate(
        self,
        method: str,
        path: str,
        query_pairs: list[tuple[str, str]],
        headers: dict[str, str],
        body: bytes,
    ) -> Identity:
        """Verify SigV4 (header or presigned) and return the caller identity."""
        headers = {k.lower(): v for k, v in headers.items()}
        auth = headers.get("authorization", "")
        q = dict(query_pairs)
        if auth.startswith("AWS4-HMAC-SHA256"):
            return self._auth_header(method, path, query_pairs, headers, auth, body)
        if q.get("X-Amz-Algorithm") == "AWS4-HMAC-SHA256":
            return self._auth_presigned(method, path, query_pairs, headers)
        if auth.startswith("AWS "):
            if ":" not in auth:  # truncated V2 header must not fall through
                raise err("AuthorizationHeaderMalformed", auth)
            return self._auth_v2_header(method, path, query_pairs, headers,
                                        auth)
        if "Signature" in q and "AWSAccessKeyId" in q and "Expires" in q:
            return self._auth_v2_presigned(method, path, query_pairs, headers)
        return self.anonymous_identity()

    # --- Signature V2 (`weed/s3api/auth_signature_v2.go:64`) ------------------
    # StringToSign = Method \n Content-MD5 \n Content-Type \n Date \n
    #                CanonicalizedAmzHeaders CanonicalizedResource
    # signature = base64(HMAC-SHA1(secret, StringToSign)); header form
    # "AWS <akid>:<sig>", presigned form ?AWSAccessKeyId&Expires&Signature
    # (Expires replaces Date in the string to sign).

    # subresources included in the canonicalized resource, per the V2 spec
    _V2_SUBRESOURCES = (
        "acl", "delete", "lifecycle", "location", "logging", "notification",
        "partNumber", "policy", "requestPayment", "response-cache-control",
        "response-content-disposition", "response-content-encoding",
        "response-content-language", "response-content-type",
        "response-expires", "tagging", "torrent", "uploadId", "uploads",
        "versionId", "versioning", "versions", "website", "cors",
    )

    @classmethod
    def _v2_canonical_resource(cls, path: str,
                               query_pairs: list[tuple[str, str]]) -> str:
        sub = []
        for k, v in query_pairs:
            if k in cls._V2_SUBRESOURCES:
                sub.append(f"{k}={v}" if v else k)
        out = path or "/"
        if sub:
            out += "?" + "&".join(sorted(sub))
        return out

    @staticmethod
    def _v2_canonical_amz_headers(headers: dict) -> str:
        amz = {}
        for k, v in headers.items():
            lk = k.lower()
            if lk.startswith("x-amz-"):
                amz[lk] = " ".join(v.split())
        return "".join(f"{k}:{amz[k]}\n" for k in sorted(amz))

    def _v2_string_to_sign(self, method: str, path: str,
                           query_pairs: list[tuple[str, str]],
                           headers: dict, date_slot: str) -> str:
        return (
            f"{method}\n{headers.get('content-md5', '')}\n"
            f"{headers.get('content-type', '')}\n{date_slot}\n"
            f"{self._v2_canonical_amz_headers(headers)}"
            f"{self._v2_canonical_resource(path, query_pairs)}"
        )

    @staticmethod
    def _v2_sign(secret: str, string_to_sign: str) -> str:
        import base64

        return base64.b64encode(
            hmac.new(secret.encode(), string_to_sign.encode(),
                     hashlib.sha1).digest()
        ).decode()

    def _auth_v2_header(self, method, path, query_pairs, headers,
                        auth) -> Identity:
        akid, _, given = auth[4:].partition(":")
        if not akid or not given:
            raise err("AuthorizationHeaderMalformed", auth)
        ident, secret = self.lookup(akid)
        # with x-amz-date present the Date slot is EMPTY (the header is
        # already covered by the canonicalized amz headers)
        date_slot = "" if "x-amz-date" in headers else headers.get("date", "")
        sts = self._v2_string_to_sign(method, path, query_pairs, headers,
                                      date_slot)
        if not hmac.compare_digest(self._v2_sign(secret, sts), given):
            raise err("SignatureDoesNotMatch", "v2 signature mismatch")
        return ident

    def _auth_v2_presigned(self, method, path, query_pairs,
                           headers) -> Identity:
        q = dict(query_pairs)
        akid = q["AWSAccessKeyId"]
        expires = q["Expires"]
        try:
            if time.time() > int(expires):
                raise err("AccessDenied", "Request has expired")
        except ValueError:
            raise err("AccessDenied", f"invalid Expires {expires!r}")
        ident, secret = self.lookup(akid)
        sts = self._v2_string_to_sign(method, path, query_pairs, headers,
                                      expires)
        if not hmac.compare_digest(self._v2_sign(secret, sts),
                                   q["Signature"]):
            raise err("SignatureDoesNotMatch", "v2 presigned mismatch")
        return ident

    def _parse_credential(self, cred: str) -> tuple[str, str, str, str]:
        # <access-key>/<yyyymmdd>/<region>/<service>/aws4_request
        parts = cred.split("/")
        if len(parts) != 5 or parts[4] != "aws4_request":
            raise err("AuthorizationHeaderMalformed", f"bad credential {cred}")
        return parts[0], parts[1], parts[2], parts[3]

    def _auth_header(
        self, method, path, query_pairs, headers, auth, body
    ) -> Identity:
        fields = {}
        for item in auth[len("AWS4-HMAC-SHA256"):].split(","):
            k, _, v = item.strip().partition("=")
            fields[k] = v
        try:
            access_key, date, region, service = self._parse_credential(
                fields["Credential"]
            )
            signed = fields["SignedHeaders"].split(";")
            given_sig = fields["Signature"]
        except KeyError as e:
            raise err("AuthorizationHeaderMalformed", f"missing {e}")
        ident, secret = self.lookup(access_key)
        payload_hash = headers.get("x-amz-content-sha256", "")
        if not payload_hash:
            payload_hash = hashlib.sha256(body or b"").hexdigest()
        elif payload_hash not in (UNSIGNED_PAYLOAD,) and not payload_hash.startswith(
            "STREAMING-"
        ):
            want = hashlib.sha256(body or b"").hexdigest()
            if body is not None and payload_hash != want:
                raise err("SignatureDoesNotMatch", "content sha256 mismatch")
        amz_date = headers.get("x-amz-date", "")
        canon = canonical_request(
            method, path, query_pairs, headers, signed, payload_hash
        )
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, canon)
        key = signing_key(secret, date, region, service)
        want_sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want_sig, given_sig):
            raise err("SignatureDoesNotMatch", "signature mismatch")
        return ident

    def _auth_presigned(self, method, path, query_pairs, headers) -> Identity:
        q = dict(query_pairs)
        try:
            access_key, date, region, service = self._parse_credential(
                q["X-Amz-Credential"]
            )
            signed = q["X-Amz-SignedHeaders"].split(";")
            given_sig = q["X-Amz-Signature"]
            amz_date = q["X-Amz-Date"]
        except KeyError as e:
            raise err("AuthorizationHeaderMalformed", f"missing {e}")
        expires = int(q.get("X-Amz-Expires", "604800"))
        t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        if time.time() > t0 + expires:
            raise err("AccessDenied", "request expired")
        ident, secret = self.lookup(access_key)
        canon = canonical_request(
            method, path, query_pairs, headers, signed, UNSIGNED_PAYLOAD
        )
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, canon)
        key = signing_key(secret, date, region, service)
        want_sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want_sig, given_sig):
            raise err("SignatureDoesNotMatch", "signature mismatch")
        return ident


def deframe_streaming_body(body: bytes) -> bytes:
    """Strip aws-chunked framing (STREAMING-AWS4-HMAC-SHA256-PAYLOAD):
    `<hex-size>;chunk-signature=<sig>\\r\\n<data>\\r\\n...0;...` — per-chunk
    signatures are accepted without re-verification (the outer seed signature
    authenticated the request). Reference: `weed/s3api/chunked_reader_v4.go`."""
    out = bytearray()
    i = 0
    while i < len(body):
        j = body.find(b"\r\n", i)
        if j < 0:
            break
        header = body[i:j].decode("latin-1")
        size_hex = header.split(";")[0]
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise err("MalformedXML", f"bad chunk header {header!r}")
        if size == 0:
            break
        start = j + 2
        out += body[start : start + size]
        i = start + size + 2  # skip trailing \r\n
    return bytes(out)
