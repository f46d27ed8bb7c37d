"""Remote storage tiering: mount external object stores as read-through
cached filer directories.

Behavioral port of `weed/remote_storage/remote_storage.go` (+ s3/gcs/azure
client impls), `weed/filer/read_remote.go` (on-read caching of remote
objects into the local cluster) and the `remote.*` shell command family:

  - `RemoteStorageClient` SPI: traverse, read, write, delete against a
    remote store. `LocalRemoteStorage` is the directory-tree implementation
    used in tests/dev (same role the reference gives its local-disk tests);
    `S3RemoteStorage` is gated on boto3.
  - Mounts map a filer directory to (config name, remote path); mounted
    entries carry a `remote.*` record in their extended attributes and no
    chunks until first read caches them.
  - `filer.remote.sync` (in command/filer_sync-style loop) writes local
    changes back to the remote store.

Mount + config records live in the filer itself under
`/etc/remote/remote.conf` and `/etc/remote/remote.mount` (the reference
stores protobuf confs under /etc; ours are JSON entries, same lifecycle).

The port's copy of `seaweedfs_tpu/remote_storage/__init__.py`; the port's
filer serves the mounts (`server/filer.py`) and
`command/filer_sync.run_filer_remote_sync` writes back.
"""

from __future__ import annotations

import os

CONF_DIR = "/etc/remote"
CONF_FILE = "/etc/remote/remote.conf"
MOUNT_FILE = "/etc/remote/remote.mount"

REMOTE_KEY = "remote.key"
REMOTE_SIZE = "remote.size"
REMOTE_MTIME = "remote.mtime"
REMOTE_STORAGE = "remote.storage"


class RemoteStorageClient:
    kind = "none"

    def traverse(self, path: str):
        """Yield (rel_path, size, mtime) for every object under path."""
        raise NotImplementedError

    def read_file(self, path: str) -> bytes:
        raise NotImplementedError

    def write_file(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete_file(self, path: str) -> None:
        raise NotImplementedError

    def list_buckets(self) -> list[str]:
        """Top-level containers (`remote_storage.go` ListBuckets): the
        default derives them by traversing the remote, which costs a full
        listing — vendors with a native bucket-list call (LocalRemoteStorage
        does) should override. Root-level FILES are not buckets."""
        seen: set[str] = set()
        for rel, _, _ in self.traverse(""):
            top, sep, _ = rel.partition("/")
            if sep and top:  # only objects INSIDE a container count
                seen.add(top)
        return sorted(seen)


class LocalRemoteStorage(RemoteStorageClient):
    """Directory tree as the 'cloud' — the dev/test vendor."""

    kind = "local"

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path.strip("/"))

    def traverse(self, path: str = ""):
        base = self._abs(path)
        if not os.path.isdir(base):
            return
        for dirpath, _, files in os.walk(base):
            for name in sorted(files):
                p = os.path.join(dirpath, name)
                rel = os.path.relpath(p, base)
                st = os.stat(p)
                yield rel.replace(os.sep, "/"), st.st_size, st.st_mtime

    def list_buckets(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
            and not d.startswith(".")
        )

    def read_file(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def write_file(self, path: str, data: bytes) -> None:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def delete_file(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass


class S3RemoteStorage(RemoteStorageClient):  # pragma: no cover - boto3 absent
    kind = "s3"

    def __init__(self, bucket: str, prefix: str = "", region: str = "",
                 endpoint: str = "") -> None:
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError("S3 remote storage requires boto3") from e
        kwargs = {}
        if region:
            kwargs["region_name"] = region
        if endpoint:
            kwargs["endpoint_url"] = endpoint
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self._s3 = boto3.client("s3", **kwargs)

    def _key(self, path: str) -> str:
        path = path.strip("/")
        return f"{self.prefix}/{path}" if self.prefix else path

    def traverse(self, path: str = ""):
        paginator = self._s3.get_paginator("list_objects_v2")
        base = self._key(path)
        for page in paginator.paginate(Bucket=self.bucket, Prefix=base):
            for obj in page.get("Contents", []):
                rel = obj["Key"][len(base):].lstrip("/")
                yield rel, obj["Size"], obj["LastModified"].timestamp()

    def read_file(self, path: str) -> bytes:
        return self._s3.get_object(
            Bucket=self.bucket, Key=self._key(path)
        )["Body"].read()

    def write_file(self, path: str, data: bytes) -> None:
        self._s3.put_object(Bucket=self.bucket, Key=self._key(path), Body=data)

    def delete_file(self, path: str) -> None:
        self._s3.delete_object(Bucket=self.bucket, Key=self._key(path))


def make_remote_client(conf: dict) -> RemoteStorageClient:
    kind = conf.get("kind", "local")
    if kind == "local":
        return LocalRemoteStorage(conf["root"])
    if kind == "s3":  # pragma: no cover
        return S3RemoteStorage(
            conf["bucket"], conf.get("prefix", ""),
            conf.get("region", ""), conf.get("endpoint", ""),
        )
    raise ValueError(f"unknown remote storage kind {kind!r}")
