"""HTTP client to a filer server — the surface gateways (S3, WebDAV, IAM,
mount, replication sinks) build on, mirroring how every reference gateway is
a filer client (`weed/pb/filer_pb_helper.go`, `weed/filer/filer_client_util`).

The port's copy of `seaweedfs_tpu/filer/filer_client.py`, over the port's
`server/httpd.py`. Calls go over `PooledHTTP` (a keep-alive connection a
calling thread) where the JAX client opens one a call: the S3 gateway makes
up to five filer calls a request, and a connection each churned the host's
ports and listen queues under warp's 20 clients. A GET is re-sent once
when its reused connection was closed by the filer while idle, before any
answer; a write, and a GET that timed out, never are.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import HTTPStatusError, PooledHTTP


class FilerClient:
    def __init__(self, filer_url: str) -> None:
        self.filer_url = filer_url.rstrip("/")
        self._pool = PooledHTTP()

    def _send(self, method: str, url: str, data: bytes | None = None,
              headers: dict | None = None) -> tuple[int, dict, bytes]:
        headers = dict(headers or {})
        if data is not None and not any(k.lower() == "content-type" for k in headers):
            # urllib's default for a body, which the filer stores as the
            # entry's mime: entries stay equal to the JAX client's
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        return self._pool.request(method, url, data, headers)

    def _u(self, path: str, query: dict | None = None) -> str:
        enc = urllib.parse.quote(path)
        qs = urllib.parse.urlencode(query or {})
        return f"{self.filer_url}{enc}" + (f"?{qs}" if qs else "")

    # --- content ----------------------------------------------------------------
    def put(
        self,
        path: str,
        data: bytes,
        content_type: str = "",
        query: dict | None = None,
    ) -> dict:
        headers = {"Content-Type": content_type} if content_type else {}
        status, _, body = self._send("PUT", self._u(path, query), data, headers)
        out = json.loads(body) if body else {}
        if status >= 300:
            raise IOError(f"PUT {path} -> {status}: {out}")
        return out

    def get(
        self, path: str, range_header: str | None = None
    ) -> tuple[int, dict, bytes]:
        headers = {"Range": range_header} if range_header else {}
        return self._send("GET", self._u(path), headers=headers)

    def read(self, path: str) -> bytes:
        status, _, body = self.get(path)
        if status >= 300:
            raise IOError(f"GET {path} -> {status}")
        return body

    def delete(self, path: str, recursive: bool = False) -> bool:
        q = {"recursive": "true"} if recursive else {}
        status, _, _ = self._send("DELETE", self._u(path, q))
        return status < 300

    def mkdir(self, path: str) -> None:
        status, _, body = self._send(
            "POST", self._u(path, {"mkdir": "true"}), b""
        )
        if status >= 300:
            raise IOError(f"mkdir {path} -> {status}: {body[:200]!r}")

    def rename(self, old: str, new: str) -> None:
        status, _, body = self._send(
            "POST", self._u(new, {"mv.from": old}), b""
        )
        if status >= 300:
            raise IOError(f"rename {old} -> {new}: {status} {body[:200]!r}")

    def link(self, old: str, new: str) -> None:
        """Hard link: new path shares the old path's content and metadata
        (filer `link.from` API; reference FUSE Link semantics)."""
        status, _, body = self._send(
            "POST", self._u(new, {"link.from": old}), b""
        )
        if status >= 300:
            raise IOError(f"link {old} -> {new}: {status} {body[:200]!r}")

    # --- metadata ---------------------------------------------------------------
    def get_entry(self, path: str) -> dict | None:
        status, _, body = self._send(
            "GET", self._u(path, {"metadata": "true"})
        )
        if status >= 300:
            return None
        return json.loads(body)

    def put_entry(self, path: str, entry: dict) -> None:
        status, _, body = self._send(
            "POST",
            self._u(path, {"meta.entry": "true"}),
            json.dumps(entry).encode(),
            {"Content-Type": "application/json"},
        )
        if status >= 300:
            raise IOError(f"put_entry {path} -> {status}: {body[:200]!r}")

    def list(
        self, dir_path: str, last_file_name: str = "", limit: int = 1024
    ) -> dict:
        q = {"limit": str(limit)}
        if last_file_name:
            q["lastFileName"] = last_file_name
        url = self._u(dir_path if dir_path != "/" else "/", q)
        status, _, body = self._send("GET", url)
        data = json.loads(body) if body else {}
        if status >= 400:
            raise HTTPStatusError(f"GET {url} -> {status}: {data}", status, data)
        return data

    def exists(self, path: str) -> bool:
        return self.get_entry(path) is not None

    def close(self) -> None:
        """Close every connection this client opened."""
        self._pool.close()
