"""Etcd filer store — the distributed-KV class of backends.

Reference: `weed/filer/etcd/etcd_store.go` (clientv3 over gRPC). This
build speaks etcd's v3 HTTP/JSON gRPC-gateway instead — the same API a
stock etcd serves on :2379 (`/v3/kv/put`, `/v3/kv/range`,
`/v3/kv/deleterange`, base64-encoded keys/values) — so no client library
is needed and the wire protocol is contract-tested against an in-process
fake (tests/fake_etcd.py), like the cloud sink clients.

Key layout: entries live under `e<dir>\\x00<name>` — the NUL separator
makes a directory's listing prefix (`e<dir>\\x00`) unable to match any
descendant directory's entries (whose keys continue with `/`), so one
prefix range lists exactly one directory, already name-sorted by etcd.
KV pairs live under `k<key>`.

The port's copy of `seaweedfs_tpu/filer/etcd.py`, over the port's
`server/httpd.py`.
"""

from __future__ import annotations

import base64
import json

from ..server.httpd import http_request
from .entry import Entry
from .filerstore import FilerStore


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _prefix_end(prefix: bytes) -> bytes:
    """etcd range_end for a prefix scan: the prefix with its last byte
    incremented (etcd clientv3 GetPrefixRangeEnd)."""
    p = bytearray(prefix)
    for i in range(len(p) - 1, -1, -1):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[: i + 1])
    return b"\0"  # all-0xFF prefix: scan to the end of the keyspace


class EtcdStore(FilerStore):
    def __init__(self, endpoint: str = "127.0.0.1:2379",
                 timeout: float = 10.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    # --- wire ----------------------------------------------------------------
    def _call(self, rpc: str, payload: dict) -> dict:
        status, _, body = http_request(
            "POST", f"{self.endpoint}/v3/kv/{rpc}",
            json.dumps(payload).encode(),
            {"Content-Type": "application/json"}, timeout=self.timeout,
        )
        if status >= 300:
            raise IOError(f"etcd {rpc} -> {status}: {body[:200]!r}")
        return json.loads(body) if body else {}

    def _put(self, key: bytes, value: bytes) -> None:
        self._call("put", {"key": _b64(key), "value": _b64(value)})

    def _get(self, key: bytes) -> bytes | None:
        out = self._call("range", {"key": _b64(key)})
        kvs = out.get("kvs") or []
        return _unb64(kvs[0]["value"]) if kvs else None

    def _delete(self, key: bytes) -> None:
        self._call("deleterange", {"key": _b64(key)})

    # --- FilerStore SPI -------------------------------------------------------
    @staticmethod
    def _entry_key(directory: str, name: str) -> bytes:
        return b"e" + directory.encode() + b"\x00" + name.encode()

    def insert_entry(self, entry: Entry) -> None:
        self._put(self._entry_key(entry.parent, entry.name),
                  json.dumps(entry.to_dict()).encode())

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    # one root convention for every store (see FilerStore.split_path)
    _split = staticmethod(FilerStore.split_path)

    def find_entry(self, path: str) -> Entry | None:
        d, name = self._split(path)
        blob = self._get(self._entry_key(d, name))
        return Entry.from_dict(json.loads(blob)) if blob else None

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        self._delete(self._entry_key(d, name))

    def list_entries(self, dir_path: str, start_from: str = "",
                     inclusive: bool = False, limit: int = 1 << 31):
        prefix = b"e" + dir_path.encode() + b"\x00"
        start = prefix + start_from.encode() if start_from else prefix
        out = self._call("range", {
            "key": _b64(start),
            "range_end": _b64(_prefix_end(prefix)),
            "sort_order": "ASCEND",
            "sort_target": "KEY",
            # +2: the excluded start_from entry and the root self-row may
            # each consume one server-side limit slot
            "limit": min(limit + 2, 1 << 31),
        })
        entries = []
        for kv in out.get("kvs") or []:
            e = Entry.from_dict(json.loads(_unb64(kv["value"])))
            if self.list_should_skip(dir_path, e):
                continue  # the root self-row is not its own child
            if start_from and not inclusive and e.name == start_from:
                continue
            entries.append(e)
            if len(entries) >= limit:
                break
        return entries

    # --- KV (`filer.proto` KvGet/KvPut) ---------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self._put(b"k" + key.encode(), value)

    def kv_get(self, key: str) -> bytes | None:
        return self._get(b"k" + key.encode())

    def kv_delete(self, key: str) -> None:
        self._delete(b"k" + key.encode())

    def close(self) -> None:
        pass  # plain HTTP, no persistent connection state
