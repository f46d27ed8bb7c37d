"""Cloud replication sinks speaking the providers' REST protocols natively.

The reference wraps vendor SDKs (`weed/replication/sink/azuresink/azure_sink.go`,
`gcssink/gcs_sink.go`, `b2sink/b2_sink.go`); none of those SDKs exist in this
image, and none are needed — each service is an HTTP API:

  - `AzureSink`  — Azure Blob Storage REST with SharedKey request signing
    (HMAC-SHA256 over the canonicalized request, per the Storage Services
    auth spec). Files are AppendBlobs created then appended in ≤4MB blocks,
    matching `azure_sink.go:100-140`.
  - `GcsSink`    — Google Cloud Storage JSON API (`upload/storage/v1` media
    uploads, `storage/v1` deletes) with Bearer-token auth; the token comes
    from a pluggable provider, and `service_account_token_provider()`
    implements the RS256 JWT OAuth2 grant the SDK performs internally.
  - `B2Sink`     — Backblaze B2 native API: b2_authorize_account →
    b2_get_upload_url → upload with X-Bz-Content-Sha1, delete via
    file-version enumeration, with 401 re-auth, per `b2_sink.go`.

Every endpoint is overridable so contract tests drive the full client
against in-process fakes (`tests/test_torch_cloud_sinks.py`).

The port's copy of `seaweedfs_tpu/replication/cloud_sinks.py`, over the
port's `http_request`. `cryptography` is imported only when a GCS token
provider is built.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse

from ..server.httpd import http_request

from . import ReplicationSink

_APPEND_BLOCK = 4 * 1024 * 1024  # Azure AppendBlock limit per call


def _clean_key(path: str, is_directory: bool = False) -> str:
    key = path.lstrip("/")
    return key + "/" if is_directory else key


class CloudSinkError(IOError):
    def __init__(self, status: int, body: bytes) -> None:
        super().__init__(f"{status}: {body[:200]!r}")
        self.status = status


# ---------------------------------------------------------------------------
# Azure Blob Storage
# ---------------------------------------------------------------------------


def azure_sharedkey_signature(
    account: str,
    key_b64: str,
    method: str,
    headers: dict[str, str],
    path: str,
    query: dict[str, str],
) -> str:
    """SharedKey signature per the Azure Storage authentication spec:
    string-to-sign = VERB + standard headers + canonicalized x-ms-*
    headers + canonicalized resource, HMAC-SHA256 with the base64 account
    key, emitted as `SharedKey <account>:<base64 digest>`."""
    h = {k.lower(): v.strip() for k, v in headers.items()}
    # API versions >= 2015-02-21 sign a zero Content-Length as empty string
    # even though the wire carries "0"
    content_length = h.get("content-length", "")
    if content_length == "0":
        content_length = ""
    std = [
        h.get("content-encoding", ""),
        h.get("content-language", ""),
        content_length,
        h.get("content-md5", ""),
        h.get("content-type", ""),
        "",  # Date is always empty: x-ms-date is authoritative
        h.get("if-modified-since", ""),
        h.get("if-match", ""),
        h.get("if-none-match", ""),
        h.get("if-unmodified-since", ""),
        h.get("range", ""),
    ]
    canon_headers = "".join(
        f"{k}:{h[k]}\n" for k in sorted(h) if k.startswith("x-ms-")
    )
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    to_sign = (
        method + "\n" + "\n".join(std) + "\n" + canon_headers + canon_resource
    )
    digest = hmac.new(
        base64.b64decode(key_b64), to_sign.encode(), hashlib.sha256
    ).digest()
    return f"SharedKey {account}:{base64.b64encode(digest).decode()}"


class AzureSink(ReplicationSink):
    """Replicate into an Azure Blob container (`azure_sink.go`). Blobs are
    AppendBlobs — created once, then appended in ≤4MB blocks — so large
    chunked files stream without buffering the whole object."""

    def __init__(
        self,
        account: str,
        account_key_b64: str,
        container: str,
        endpoint: str | None = None,
    ) -> None:
        self.account = account
        self.key = account_key_b64
        self.container = container
        self.endpoint = (
            endpoint or f"https://{account}.blob.core.windows.net"
        ).rstrip("/")

    def _request(
        self,
        method: str,
        blob: str,
        query: dict[str, str] | None = None,
        body: bytes = b"",
        extra_headers: dict[str, str] | None = None,
    ) -> tuple[int, dict, bytes]:
        from email.utils import formatdate  # RFC1123, locale-independent

        query = dict(query or {})
        path = f"/{self.container}/{urllib.parse.quote(blob)}"
        headers = {
            "x-ms-date": formatdate(usegmt=True),
            "x-ms-version": "2021-08-06",
        }
        if body or method == "PUT":
            headers["content-length"] = str(len(body))
            # explicit: urllib would otherwise inject an unsigned default
            headers["content-type"] = "application/octet-stream"
        headers.update(extra_headers or {})
        headers["Authorization"] = azure_sharedkey_signature(
            self.account, self.key, method, headers, path, query
        )
        url = self.endpoint + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        # PUT always ships a body (possibly empty) so the wire carries the
        # same content-length the signature covered
        wire_body = body if (body or method == "PUT") else None
        # data-bearing sink pushes may carry whole chunks: a longer,
        # still-finite budget (the audit rule: explicit or default,
        # never unbounded)
        return http_request(method, url, wire_body, headers, timeout=120)

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry.get("is_directory"):
            return  # containers are flat; directories are implicit
        blob = _clean_key(path)
        status, _, body = self._request(
            "PUT", blob, extra_headers={"x-ms-blob-type": "AppendBlob"}
        )
        if status >= 400:
            raise CloudSinkError(status, body)
        data = data or b""
        for off in range(0, len(data), _APPEND_BLOCK):
            block = data[off : off + _APPEND_BLOCK]
            status, _, body = self._request(
                "PUT", blob, query={"comp": "appendblock"}, body=block
            )
            if status >= 400:
                raise CloudSinkError(status, body)

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        blob = _clean_key(path, is_directory)
        status, _, body = self._request(
            "DELETE", blob, extra_headers={"x-ms-delete-snapshots": "include"}
        )
        if status >= 400 and status != 404:
            raise CloudSinkError(status, body)


# ---------------------------------------------------------------------------
# Google Cloud Storage
# ---------------------------------------------------------------------------


def service_account_token_provider(
    credentials: dict, token_url: str | None = None, scope: str | None = None
):
    """Return a `() -> bearer token` callable implementing the OAuth2
    service-account JWT grant (what `option.WithCredentialsFile` does inside
    the SDK): sign an RS256 JWT with the account's private key, exchange it
    at the token endpoint, cache until expiry."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    priv = serialization.load_pem_private_key(
        credentials["private_key"].encode(), password=None
    )
    token_url = token_url or credentials.get(
        "token_uri", "https://oauth2.googleapis.com/token"
    )
    scope = scope or "https://www.googleapis.com/auth/devstorage.read_write"
    cache: dict = {}

    def b64u(raw: bytes) -> str:
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    def provider() -> str:
        now = int(time.time())
        if cache.get("exp", 0) - 60 > now:
            return cache["token"]
        header = b64u(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
        claims = b64u(
            json.dumps(
                {
                    "iss": credentials["client_email"],
                    "scope": scope,
                    "aud": token_url,
                    "iat": now,
                    "exp": now + 3600,
                }
            ).encode()
        )
        signing_input = f"{header}.{claims}".encode()
        sig = priv.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
        jwt = f"{header}.{claims}.{b64u(sig)}"
        body = urllib.parse.urlencode(
            {
                "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
                "assertion": jwt,
            }
        ).encode()
        status, _, resp = http_request(
            "POST",
            token_url,
            body,
            {"Content-Type": "application/x-www-form-urlencoded"},
        )
        if status >= 400:
            raise CloudSinkError(status, resp)
        out = json.loads(resp)
        cache["token"] = out["access_token"]
        cache["exp"] = now + int(out.get("expires_in", 3600))
        return cache["token"]

    return provider


class GcsSink(ReplicationSink):
    """Replicate into a GCS bucket via the JSON API (`gcs_sink.go`).
    Directories become trailing-slash marker deletes only, matching the
    reference (it never creates directory objects but deletes `key/`)."""

    def __init__(
        self,
        bucket: str,
        token_provider,
        endpoint: str = "https://storage.googleapis.com",
    ) -> None:
        self.bucket = bucket
        self.token = token_provider
        self.endpoint = endpoint.rstrip("/")

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.token()}"}

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry.get("is_directory"):
            return
        key = _clean_key(path)
        mime = (entry.get("attributes") or {}).get(
            "mime", "application/octet-stream"
        )
        url = (
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )
        headers = self._headers()
        headers["Content-Type"] = mime or "application/octet-stream"
        status, _, body = http_request("POST", url, data or b"", headers,
                                       timeout=120)
        if status >= 400:
            raise CloudSinkError(status, body)

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        key = _clean_key(path, is_directory)
        url = (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
            f"{urllib.parse.quote(key, safe='')}"
        )
        status, _, body = http_request("DELETE", url, None, self._headers())
        if status >= 400 and status != 404:
            raise CloudSinkError(status, body)


# ---------------------------------------------------------------------------
# Backblaze B2
# ---------------------------------------------------------------------------


class B2Sink(ReplicationSink):
    """Replicate into a B2 bucket over the native API (`b2_sink.go`, which
    wraps kurin/blazer). Auth tokens and upload URLs are cached and
    refreshed on 401, the way the SDK's transport does."""

    def __init__(
        self,
        account_id: str,
        application_key: str,
        bucket: str,
        endpoint: str = "https://api.backblazeb2.com",
    ) -> None:
        self.account_id = account_id
        self.app_key = application_key
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self._auth: dict | None = None
        self._upload: dict | None = None
        self._bucket_id: str | None = None

    # --- session -----------------------------------------------------------
    def _authorize(self) -> dict:
        if self._auth is not None:
            return self._auth
        basic = base64.b64encode(
            f"{self.account_id}:{self.app_key}".encode()
        ).decode()
        status, _, body = http_request(
            "GET",
            f"{self.endpoint}/b2api/v2/b2_authorize_account",
            None,
            {"Authorization": f"Basic {basic}"},
        )
        if status >= 400:
            raise CloudSinkError(status, body)
        self._auth = json.loads(body)
        return self._auth

    def _api(self, call: str, payload: dict, _retry: bool = True) -> dict:
        auth = self._authorize()
        status, _, body = http_request(
            "POST",
            f"{auth['apiUrl']}/b2api/v2/{call}",
            json.dumps(payload).encode(),
            {"Authorization": auth["authorizationToken"]},
        )
        if status == 401 and _retry:  # expired token: one re-auth retry
            self._auth = None
            return self._api(call, payload, _retry=False)
        if status >= 400:
            raise CloudSinkError(status, body)
        return json.loads(body)

    def _get_bucket_id(self) -> str:
        if self._bucket_id is None:
            out = self._api(
                "b2_list_buckets",
                {
                    "accountId": self._authorize()["accountId"],
                    "bucketName": self.bucket,
                },
            )
            for b in out["buckets"]:
                if b["bucketName"] == self.bucket:
                    self._bucket_id = b["bucketId"]
            if self._bucket_id is None:
                raise CloudSinkError(404, f"bucket {self.bucket}".encode())
        return self._bucket_id

    # --- sink SPI ----------------------------------------------------------
    def create_entry(self, path: str, entry: dict, data: bytes | None,
                     _retry: bool = True) -> None:
        if entry.get("is_directory"):
            return
        data = data or b""
        if self._upload is None:
            self._upload = self._api(
                "b2_get_upload_url", {"bucketId": self._get_bucket_id()}
            )
        mime = (entry.get("attributes") or {}).get("mime") or "b2/x-auto"
        headers = {
            "Authorization": self._upload["authorizationToken"],
            "X-Bz-File-Name": urllib.parse.quote(_clean_key(path)),
            "Content-Type": mime,
            "X-Bz-Content-Sha1": hashlib.sha1(data).hexdigest(),
        }
        status, _, body = http_request(
            "POST", self._upload["uploadUrl"], data, headers, timeout=120,
        )
        if status == 401 and _retry:  # upload URLs expire on their own clock
            self._upload = None
            return self.create_entry(path, entry, data, _retry=False)
        if status >= 400:
            raise CloudSinkError(status, body)

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        key = _clean_key(path, is_directory)
        start_name, start_id = key, None
        while True:  # page through ALL versions of this file name
            req = {
                "bucketId": self._get_bucket_id(),
                "startFileName": start_name,
                "maxFileCount": 100,
            }
            if start_id:
                req["startFileId"] = start_id
            out = self._api("b2_list_file_versions", req)
            done = False
            for f in out.get("files", []):
                if f["fileName"] != key:
                    done = True
                    break
                self._api(
                    "b2_delete_file_version",
                    {"fileName": f["fileName"], "fileId": f["fileId"]},
                )
            start_name = out.get("nextFileName")
            start_id = out.get("nextFileId")
            if done or not start_name:
                break
