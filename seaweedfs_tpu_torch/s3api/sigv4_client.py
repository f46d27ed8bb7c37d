"""Minimal SigV4-signing S3 client.

Used by the test suite (no aws-sdk in this environment), the remote-storage
tiering backend, and the replication S3 sink — the same roles the reference
fills with aws-sdk-go (`weed/remote_storage/s3/`, `weed/replication/sink/s3sink`).

The port's copy of `seaweedfs_tpu/s3api/sigv4_client.py`, over the
port's `server/httpd.py`.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
import xml.etree.ElementTree as ET

from ..server.httpd import http_request

from .auth import canonical_request, signing_key, string_to_sign


class S3Error(IOError):
    def __init__(self, status: int, code: str, message: str) -> None:
        super().__init__(f"{status} {code}: {message}")
        self.status = status
        self.code = code
        self.message = message


def _parse_error(status: int, body: bytes) -> S3Error:
    code, message = "UnknownError", ""
    try:
        root = ET.fromstring(body)
        code = root.findtext("Code") or code
        message = root.findtext("Message") or ""
    except ET.ParseError:
        pass
    return S3Error(status, code, message)


class S3Client:
    def __init__(
        self,
        endpoint: str,
        access_key: str = "",
        secret_key: str = "",
        region: str = "us-east-1",
        service: str = "s3",
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service

    # --- signing ----------------------------------------------------------------
    def _signed_headers(
        self, method: str, path: str, query_pairs: list[tuple[str, str]],
        body: bytes,
    ) -> dict[str, str]:
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = time.gmtime()
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
        date = time.strftime("%Y%m%d", now)
        payload_hash = hashlib.sha256(body or b"").hexdigest()
        headers = {
            "host": host,
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }
        if not self.access_key:
            return headers
        signed = sorted(headers)
        canon = canonical_request(
            method, path, query_pairs, headers, signed, payload_hash
        )
        scope = f"{date}/{self.region}/{self.service}/aws4_request"
        sts = string_to_sign(amz_date, scope, canon)
        key = signing_key(self.secret_key, date, self.region, self.service)
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"
        )
        return headers

    def presign_url(
        self, method: str, bucket: str, key: str, expires: int = 3600
    ) -> str:
        """Presigned URL (query-string auth, UNSIGNED-PAYLOAD)."""
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = time.gmtime()
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
        date = time.strftime("%Y%m%d", now)
        scope = f"{date}/{self.region}/{self.service}/aws4_request"
        path = urllib.parse.quote(f"/{bucket}/{key}", safe="/-_.~")
        pairs = [
            ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
            ("X-Amz-Credential", f"{self.access_key}/{scope}"),
            ("X-Amz-Date", amz_date),
            ("X-Amz-Expires", str(expires)),
            ("X-Amz-SignedHeaders", "host"),
        ]
        canon = canonical_request(
            method, path, pairs, {"host": host}, ["host"], "UNSIGNED-PAYLOAD"
        )
        sts = string_to_sign(amz_date, scope, canon)
        key_bytes = signing_key(self.secret_key, date, self.region, self.service)
        sig = hmac.new(key_bytes, sts.encode(), hashlib.sha256).hexdigest()
        pairs.append(("X-Amz-Signature", sig))
        return f"{self.endpoint}{path}?{urllib.parse.urlencode(pairs)}"

    def request(
        self,
        method: str,
        path: str,
        query: dict[str, str] | list[tuple[str, str]] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> tuple[int, dict, bytes]:
        pairs = list(query.items()) if isinstance(query, dict) else list(query or [])
        path = urllib.parse.quote(path, safe="/-_.~")
        signed = self._signed_headers(method, path, pairs, body)
        signed.update(headers or {})
        qs = urllib.parse.urlencode(pairs)
        url = f"{self.endpoint}{path}" + (f"?{qs}" if qs else "")
        return http_request(method, url, body or None, signed)

    def _ok(self, resp: tuple[int, dict, bytes]) -> tuple[int, dict, bytes]:
        status, headers, body = resp
        if status >= 400:
            raise _parse_error(status, body)
        return resp

    # --- buckets ----------------------------------------------------------------
    def create_bucket(self, bucket: str) -> None:
        self._ok(self.request("PUT", f"/{bucket}"))

    def delete_bucket(self, bucket: str) -> None:
        self._ok(self.request("DELETE", f"/{bucket}"))

    def head_bucket(self, bucket: str) -> bool:
        status, _, _ = self.request("HEAD", f"/{bucket}")
        return status < 400

    def list_buckets(self) -> list[str]:
        _, _, body = self._ok(self.request("GET", "/"))
        root = ET.fromstring(body)
        ns = _ns(root)
        return [
            el.findtext(f"{ns}Name") or ""
            for el in root.iter(f"{ns}Bucket")
        ]

    # --- objects ----------------------------------------------------------------
    def put_object(
        self, bucket: str, key: str, data: bytes,
        content_type: str = "", metadata: dict[str, str] | None = None,
    ) -> str:
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        for k, v in (metadata or {}).items():
            headers[f"x-amz-meta-{k}"] = v
        _, rh, _ = self._ok(
            self.request("PUT", f"/{bucket}/{key}", body=data, headers=headers)
        )
        return rh.get("ETag", "").strip('"')

    def get_object(
        self, bucket: str, key: str, range_header: str | None = None
    ) -> bytes:
        headers = {"Range": range_header} if range_header else {}
        _, _, body = self._ok(
            self.request("GET", f"/{bucket}/{key}", headers=headers)
        )
        return body

    def head_object(self, bucket: str, key: str) -> dict | None:
        status, headers, _ = self.request("HEAD", f"/{bucket}/{key}")
        return dict(headers) if status < 400 else None

    def delete_object(self, bucket: str, key: str) -> None:
        self._ok(self.request("DELETE", f"/{bucket}/{key}"))

    def copy_object(
        self, src_bucket: str, src_key: str, dst_bucket: str, dst_key: str
    ) -> None:
        self._ok(
            self.request(
                "PUT",
                f"/{dst_bucket}/{dst_key}",
                headers={"x-amz-copy-source": f"/{src_bucket}/{src_key}"},
            )
        )

    def delete_objects(self, bucket: str, keys: list[str]) -> list[str]:
        objs = "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
        body = f"<Delete>{objs}</Delete>".encode()
        _, _, out = self._ok(
            self.request("POST", f"/{bucket}", query={"delete": ""}, body=body)
        )
        root = ET.fromstring(out)
        ns = _ns(root)
        return [
            el.findtext(f"{ns}Key") or "" for el in root.iter(f"{ns}Deleted")
        ]

    def list_objects(
        self,
        bucket: str,
        prefix: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
        continuation_token: str = "",
        v2: bool = True,
    ) -> dict:
        q: list[tuple[str, str]] = []
        if v2:
            q.append(("list-type", "2"))
            if continuation_token:
                q.append(("continuation-token", continuation_token))
        elif continuation_token:
            q.append(("marker", continuation_token))
        if prefix:
            q.append(("prefix", prefix))
        if delimiter:
            q.append(("delimiter", delimiter))
        q.append(("max-keys", str(max_keys)))
        _, _, body = self._ok(self.request("GET", f"/{bucket}", query=q))
        root = ET.fromstring(body)
        ns = _ns(root)
        return {
            "contents": [
                {
                    "key": el.findtext(f"{ns}Key") or "",
                    "size": int(el.findtext(f"{ns}Size") or 0),
                    "etag": (el.findtext(f"{ns}ETag") or "").strip('"'),
                }
                for el in root.iter(f"{ns}Contents")
            ],
            "common_prefixes": [
                el.findtext(f"{ns}Prefix") or ""
                for el in root.iter(f"{ns}CommonPrefixes")
            ],
            "is_truncated": (root.findtext(f"{ns}IsTruncated") == "true"),
            "next_token": root.findtext(f"{ns}NextContinuationToken")
            or root.findtext(f"{ns}NextMarker")
            or "",
        }

    # --- multipart --------------------------------------------------------------
    def create_multipart(self, bucket: str, key: str) -> str:
        _, _, body = self._ok(
            self.request("POST", f"/{bucket}/{key}", query={"uploads": ""})
        )
        root = ET.fromstring(body)
        return root.findtext(f"{_ns(root)}UploadId") or ""

    def upload_part(
        self, bucket: str, key: str, upload_id: str, part_number: int, data: bytes
    ) -> str:
        _, rh, _ = self._ok(
            self.request(
                "PUT",
                f"/{bucket}/{key}",
                query={"partNumber": str(part_number), "uploadId": upload_id},
                body=data,
            )
        )
        return rh.get("ETag", "").strip('"')

    def complete_multipart(
        self, bucket: str, key: str, upload_id: str,
        parts: list[tuple[int, str]],
    ) -> str:
        inner = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
            for n, e in parts
        )
        body = f"<CompleteMultipartUpload>{inner}</CompleteMultipartUpload>".encode()
        _, _, out = self._ok(
            self.request(
                "POST", f"/{bucket}/{key}", query={"uploadId": upload_id}, body=body
            )
        )
        root = ET.fromstring(out)
        return (root.findtext(f"{_ns(root)}ETag") or "").strip('"')

    def abort_multipart(self, bucket: str, key: str, upload_id: str) -> None:
        self._ok(
            self.request(
                "DELETE", f"/{bucket}/{key}", query={"uploadId": upload_id}
            )
        )

    def list_parts(self, bucket: str, key: str, upload_id: str) -> list[int]:
        _, _, body = self._ok(
            self.request("GET", f"/{bucket}/{key}", query={"uploadId": upload_id})
        )
        root = ET.fromstring(body)
        ns = _ns(root)
        return [
            int(el.findtext(f"{ns}PartNumber") or 0)
            for el in root.iter(f"{ns}Part")
        ]

    # --- tagging ----------------------------------------------------------------
    def put_object_tagging(self, bucket: str, key: str, tags: dict[str, str]) -> None:
        inner = "".join(
            f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>" for k, v in tags.items()
        )
        body = f"<Tagging><TagSet>{inner}</TagSet></Tagging>".encode()
        self._ok(
            self.request(
                "PUT", f"/{bucket}/{key}", query={"tagging": ""}, body=body
            )
        )

    def get_object_tagging(self, bucket: str, key: str) -> dict[str, str]:
        _, _, body = self._ok(
            self.request("GET", f"/{bucket}/{key}", query={"tagging": ""})
        )
        root = ET.fromstring(body)
        ns = _ns(root)
        return {
            (el.findtext(f"{ns}Key") or ""): (el.findtext(f"{ns}Value") or "")
            for el in root.iter(f"{ns}Tag")
        }

    def delete_object_tagging(self, bucket: str, key: str) -> None:
        self._ok(
            self.request("DELETE", f"/{bucket}/{key}", query={"tagging": ""})
        )


def _ns(root: ET.Element) -> str:
    """Namespace prefix of an element tree ('{uri}' or '')."""
    if root.tag.startswith("{"):
        return root.tag[: root.tag.index("}") + 1]
    return ""
