"""Cross-cluster replication: event-driven sinks + bidirectional filer.sync.

Behavioral port of `weed/replication/replicator.go:24` (+ `sink/`,
`source/`) and `weed/command/filer_sync.go:119-385`:

  - `ReplicationSink` SPI — apply create/update/delete events somewhere
  - `FilerSink` — another cluster's filer (content is re-uploaded through
    the target cluster's own assign/upload path, not fid-copied)
  - `LocalSink` — materialize the namespace into a local directory
    (`replication/sink/localsink`)
  - `Replicator` — event dispatcher (create/update/delete/rename semantics)
  - `FilerSyncer` — one direction of `weed filer.sync`: tail the source
    filer's metadata stream and replay onto the sink with the source's
    signature attached; events that already carry the target's signature
    are skipped (loop prevention for active-active pairs)

The port's copy of `seaweedfs_tpu/replication/__init__.py`, over the port's
`FilerClient`, `server/httpd.py` and `S3Client`. Difference from the JAX
package: the port's `FilerClient` keeps its connections alive, so
`FilerSink.close()` and `FilerSyncer.close()` close the ones they opened
(the JAX clients open one a call and have nothing to close).
"""

from __future__ import annotations

import json
import os
import shutil
import time

from ..filer.filer_client import FilerClient
from ..filer.filer_notify import SYSTEM_LOG_DIR
from ..server.httpd import http_request


class ReplicationSink:
    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        raise NotImplementedError

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError

    @property
    def signature(self) -> int:
        """Signature attached to writes this sink performs (0 = none)."""
        return 0

    def close(self) -> None:
        """Close what the sink holds open (nothing, unless it says so)."""


class LocalSink(ReplicationSink):
    """Mirror the filer namespace into a directory (`localsink/local_sink.go`)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        p = self._path(path)
        if entry.get("is_directory"):
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p) or "/", exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        p = self._path(path)
        try:
            if is_directory:
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.remove(p)
        except FileNotFoundError:
            pass


class FilerSink(ReplicationSink):
    """Replicate into another cluster's filer over HTTP
    (`replication/sink/filersink/` — content flows through the target
    cluster's own volume assignment, never cross-cluster fids)."""

    def __init__(self, filer_url: str, extra_signature: int = 0) -> None:
        self.client = FilerClient(filer_url)
        self.extra_signature = extra_signature

    def _sig_query(self) -> dict:
        if not self.extra_signature:
            return {}
        return {"signatures": str(self.extra_signature)}

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry.get("is_directory"):
            q = dict(self._sig_query())
            q["mkdir"] = "true"
            self.client.put(path.rstrip("/"), b"", query=q)
            return
        mime = (entry.get("attributes") or {}).get("mime", "")
        self.client.put(path, data or b"", content_type=mime,
                        query=self._sig_query())

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        q = {"recursive": "true"} if is_directory else {}
        q.update(self._sig_query())
        url = self.client._u(path, q)
        http_request("DELETE", url, timeout=30)

    @property
    def signature(self) -> int:
        return self.extra_signature

    def close(self) -> None:
        self.client.close()


class Replicator:
    """Apply one metadata event to a sink (`replicator.go:24` Replicate):
    old+new same path → update; old+new different path → delete+create
    (rename); only new → create; only old → delete."""

    def __init__(self, sink: ReplicationSink,
                 read_content=None) -> None:
        self.sink = sink
        self._read = read_content or (lambda path, entry: None)

    def replicate(self, event: dict) -> None:
        old, new = event.get("old_entry"), event.get("new_entry")
        if new is not None:
            new_path = new["full_path"]
            if new_path.startswith(SYSTEM_LOG_DIR):
                return
            # read BEFORE mutating the sink: a transient source failure
            # must leave the sink untouched (drain loops like
            # filer.replicate advance past raised events, so partial
            # application would be permanent)
            data = None
            superseded = False
            if not new.get("is_directory"):
                try:
                    data = self._read(new_path, new)
                except IOError as e:
                    # status suffix, not substring: paths may contain "404"
                    if str(e).rstrip().endswith("404"):
                        # replaying history: this create was superseded
                        # (renamed/deleted later at the source); later
                        # events converge the sink
                        superseded = True
                    else:
                        raise  # transient failure: caller retries
            if old is not None and old["full_path"] != new_path:
                # rename: the old key must go even when the new content is
                # superseded, or a replayed rename leaves it stale forever
                self.sink.delete_entry(
                    old["full_path"], bool(old.get("is_directory"))
                )
            if superseded:
                return
            if old is not None and old["full_path"] == new_path:
                self.sink.update_entry(new_path, new, data)
            else:
                self.sink.create_entry(new_path, new, data)
        elif old is not None:
            old_path = old["full_path"]
            if old_path.startswith(SYSTEM_LOG_DIR):
                return
            self.sink.delete_entry(old_path, bool(old.get("is_directory")))


class FilerSyncer:
    """One direction of `weed filer.sync` (`filer_sync.go:119-385`):
    tail source metadata, replay onto target with the source signature,
    skip events the target has already seen (its signature is in the
    event's signature list)."""

    def __init__(self, source_url: str, target_url: str) -> None:
        self.source = FilerClient(source_url)
        self.source_url = source_url
        self.target_url = target_url

        def info(url):
            status, _, body = http_request("GET", url + "/__meta__/info",
                                           timeout=10)
            return json.loads(body)

        self.source_signature = info(source_url.rstrip("/"))["signature"]
        self.target_signature = info(target_url.rstrip("/"))["signature"]
        sink = FilerSink(target_url, extra_signature=self.source_signature)
        self.replicator = Replicator(sink, read_content=self._read_source)
        self.cursor_ns = time.time_ns()

    def _read_source(self, path: str, entry: dict) -> bytes:
        return self.source.read(path)

    def run_once(self, wait: float = 0.0) -> int:
        """Fetch + replay one batch; returns number of applied events."""
        url = (
            f"{self.source_url.rstrip('/')}/__meta__/events"
            f"?since_ns={self.cursor_ns}&wait={wait}"
        )
        status, _, body = http_request("GET", url, timeout=wait + 30)
        if status != 200:
            raise IOError(f"subscribe {self.source_url} -> {status}")
        out = json.loads(body)
        applied = 0
        for ev in out["events"]:
            # loop prevention: this event already passed through the target
            if self.target_signature in ev.get("signatures", []):
                continue
            self.replicator.replicate(ev)
            applied += 1
        self.cursor_ns = out["next_ts_ns"]
        return applied

    def run_forever(self, poll_interval: float = 1.0, stop_event=None) -> None:
        while stop_event is None or not stop_event.is_set():
            try:
                n = self.run_once(wait=poll_interval)
                if n == 0 and poll_interval > 0:
                    time.sleep(min(poll_interval, 0.2))
            except Exception:
                time.sleep(poll_interval)

    def close(self) -> None:
        """Close the connections to both filers."""
        self.source.close()
        self.replicator.sink.close()


class S3Sink(ReplicationSink):
    """Replicate the namespace into any S3 endpoint — AWS or this
    framework's own gateway (`weed/replication/sink/s3sink/s3_sink.go`).
    Filer path /a/b.txt lands at s3://bucket/<prefix>/a/b.txt. Directories
    become zero-byte "dir/" marker objects, the convention S3 browsers use."""

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        prefix: str = "",
        create_bucket: bool = True,
    ) -> None:
        from ..s3api.sigv4_client import S3Client, S3Error

        self._S3Error = S3Error
        self.client = S3Client(endpoint, access_key, secret_key)
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        if create_bucket:
            try:
                self.client.create_bucket(bucket)
            except S3Error:
                pass  # exists / owned

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry.get("is_directory"):
            self.client.put_object(self.bucket, self._key(path) + "/", b"")
            return
        mime = (entry.get("attributes") or {}).get("mime", "")
        self.client.put_object(
            self.bucket, self._key(path), data or b"", content_type=mime
        )

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            # drop the subtree: marker + every object under the prefix,
            # paging until the listing is exhausted
            token = ""
            while True:
                listing = self.client.list_objects(
                    self.bucket, prefix=self._key(path) + "/",
                    continuation_token=token,
                )
                keys = [c["key"] for c in listing["contents"]]
                if keys:
                    self.client.delete_objects(self.bucket, keys)
                token = listing.get("next_token") or ""
                if not listing.get("is_truncated") or (not token and not keys):
                    break
        try:
            self.client.delete_object(self.bucket, self._key(path))
        except self._S3Error:
            pass
