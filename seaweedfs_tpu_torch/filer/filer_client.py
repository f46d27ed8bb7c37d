"""HTTP client to a filer server — the surface gateways (S3, WebDAV, IAM,
mount, replication sinks) build on, mirroring how every reference gateway is
a filer client (`weed/pb/filer_pb_helper.go`, `weed/filer/filer_client_util`).

The port's copy of `seaweedfs_tpu/filer/filer_client.py`, over the port's
`server/httpd.py`.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import get_json, http_request


class FilerClient:
    def __init__(self, filer_url: str) -> None:
        self.filer_url = filer_url.rstrip("/")

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
        status, _, body = http_request("PUT", self._u(path, query), data, headers)
        out = json.loads(body) if body else {}
        if status >= 300:
            raise IOError(f"PUT {path} -> {status}: {out}")
        return out

    def get(
        self, path: str, range_header: str | None = None
    ) -> tuple[int, dict, bytes]:
        headers = {"Range": range_header} if range_header else {}
        return http_request("GET", self._u(path), headers=headers)

    def read(self, path: str) -> bytes:
        status, _, body = self.get(path)
        if status >= 300:
            raise IOError(f"GET {path} -> {status}")
        return body

    def delete(self, path: str, recursive: bool = False) -> bool:
        q = {"recursive": "true"} if recursive else {}
        status, _, _ = http_request("DELETE", self._u(path, q))
        return status < 300

    def mkdir(self, path: str) -> None:
        status, _, body = http_request(
            "POST", self._u(path, {"mkdir": "true"}), b""
        )
        if status >= 300:
            raise IOError(f"mkdir {path} -> {status}: {body[:200]!r}")

    def rename(self, old: str, new: str) -> None:
        status, _, body = http_request(
            "POST", self._u(new, {"mv.from": old}), b""
        )
        if status >= 300:
            raise IOError(f"rename {old} -> {new}: {status} {body[:200]!r}")

    def link(self, old: str, new: str) -> None:
        """Hard link: new path shares the old path's content and metadata
        (filer `link.from` API; reference FUSE Link semantics)."""
        status, _, body = http_request(
            "POST", self._u(new, {"link.from": old}), b""
        )
        if status >= 300:
            raise IOError(f"link {old} -> {new}: {status} {body[:200]!r}")

    # --- metadata ---------------------------------------------------------------
    def get_entry(self, path: str) -> dict | None:
        status, _, body = http_request(
            "GET", self._u(path, {"metadata": "true"})
        )
        if status >= 300:
            return None
        return json.loads(body)

    def put_entry(self, path: str, entry: dict) -> None:
        status, _, body = http_request(
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
        return get_json(self._u(dir_path if dir_path != "/" else "/", q))

    def exists(self, path: str) -> bool:
        return self.get_entry(path) is not None
