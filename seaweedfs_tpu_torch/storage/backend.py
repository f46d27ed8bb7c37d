"""Pluggable volume-file backends + whole-volume tiering.

The port's copy of `seaweedfs_tpu/storage/backend.py` (after
`weed/storage/backend/backend.go:15-45`, the `BackendStorageFile` /
`BackendStorage` SPI, and `weed/storage/volume_tier.go`): a volume's `.dat`
normally lives on local disk, but a readonly volume can be moved wholesale
to a remote object store; the `.vif` volume-info file records where, and
reads proxy range requests to the backend.

Backends:
  - `DiskFile` — local file (the default data plane; `disk_file.go`)
  - `MmapFile` — mmap-backed reads (`memory_map/`; a volume opens its .dat
    through it when SEAWEEDFS_TPU_MMAP_READS=1)
  - `MemoryFile` — RAM-backed, for tests and scratch volumes
  - `RemoteFile` — the readonly view of a tiered `.dat`
  - `LocalObjectBackend` — object store emulation over a directory tree;
    the testable stand-in for S3 (`s3_backend/` — same key->object semantics)
  - `S3Backend` — real S3, gated on boto3 being importable, and
    `RcloneBackend`, gated on the `rclone` binary: configuring either
    without it raises BackendError

The registry is process-global like the reference's `backend.Storages`
(configured over `/admin/backend/configure` or `configure_backend`).
"""

from __future__ import annotations

import os
import threading


class BackendError(Exception):
    pass


class BackendStorageFile:
    """ReaderAt/WriterAt/Truncate/Sync surface (`backend.go:15-23`)."""

    def read_at(self, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def write_at(self, data: bytes, offset: int) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    def file_size(self) -> int:
        raise NotImplementedError

    @property
    def writable(self) -> bool:
        return True


class DiskFile(BackendStorageFile):
    def __init__(self, path: str, create: bool = False) -> None:
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._fd, size, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        return os.pwrite(self._fd, data, offset)

    def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)

    def sync(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        os.close(self._fd)

    def file_size(self) -> int:
        return os.fstat(self._fd).st_size


class MemoryFile(BackendStorageFile):
    def __init__(self) -> None:
        self._buf = bytearray()
        self._lock = threading.Lock()

    def read_at(self, size: int, offset: int) -> bytes:
        with self._lock:
            return bytes(self._buf[offset : offset + size])

    def write_at(self, data: bytes, offset: int) -> int:
        with self._lock:
            end = offset + len(data)
            if end > len(self._buf):
                self._buf.extend(b"\0" * (end - len(self._buf)))
            self._buf[offset:end] = data
            return len(data)

    def truncate(self, size: int) -> None:
        with self._lock:
            del self._buf[size:]

    def file_size(self) -> int:
        return len(self._buf)


class RemoteFile(BackendStorageFile):
    """Readonly view of a tiered `.dat` living in an object backend
    (`s3_backend/s3_backend_storage_file.go`)."""

    def __init__(self, backend: "BackendStorage", key: str, size: int) -> None:
        self.backend = backend
        self.key = key
        self._size = size

    def read_at(self, size: int, offset: int) -> bytes:
        return self.backend.read_range(self.key, offset, size)

    def write_at(self, data: bytes, offset: int) -> int:
        raise BackendError("tiered volume is read-only")

    def truncate(self, size: int) -> None:
        raise BackendError("tiered volume is read-only")

    def file_size(self) -> int:
        return self._size

    @property
    def writable(self) -> bool:
        return False


class BackendStorage:
    """Object-store surface: upload/download whole volume files + ranged
    reads (`backend.go:33-45`)."""

    kind = "none"

    def __init__(self, backend_id: str) -> None:
        self.id = backend_id

    def upload_file(self, local_path: str, key: str) -> int:
        raise NotImplementedError

    def download_file(self, key: str, local_path: str) -> None:
        raise NotImplementedError

    def delete_file(self, key: str) -> None:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def object_size(self, key: str) -> int:
        raise NotImplementedError


class LocalObjectBackend(BackendStorage):
    """Directory-tree object store: the S3 stand-in used in tests/dev."""

    kind = "local"

    def __init__(self, backend_id: str, root: str) -> None:
        super().__init__(backend_id)
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def upload_file(self, local_path: str, key: str) -> int:
        dst = self._path(key)
        tmp = dst + ".tmp"
        with open(local_path, "rb") as src, open(tmp, "wb") as out:
            while True:
                piece = src.read(1 << 20)
                if not piece:
                    break
                out.write(piece)
        os.replace(tmp, dst)
        return os.path.getsize(dst)

    def download_file(self, key: str, local_path: str) -> None:
        src = self._path(key)
        if not os.path.exists(src):
            raise BackendError(f"{self.id}: no object {key}")
        tmp = local_path + ".tmp"
        with open(src, "rb") as f, open(tmp, "wb") as out:
            while True:
                piece = f.read(1 << 20)
                if not piece:
                    break
                out.write(piece)
        os.replace(tmp, local_path)

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def object_size(self, key: str) -> int:
        return os.path.getsize(self._path(key))


class S3Backend(BackendStorage):  # pragma: no cover - boto3 not in image
    kind = "s3"

    def __init__(self, backend_id: str, bucket: str, region: str = "",
                 endpoint: str = "") -> None:
        super().__init__(backend_id)
        try:
            import boto3
        except ImportError as e:
            raise BackendError(
                "S3 tier backend requires boto3; use a 'local' backend or "
                "install boto3"
            ) from e
        kwargs = {}
        if region:
            kwargs["region_name"] = region
        if endpoint:
            kwargs["endpoint_url"] = endpoint
        self.bucket = bucket
        self._s3 = boto3.client("s3", **kwargs)

    def upload_file(self, local_path: str, key: str) -> int:
        self._s3.upload_file(local_path, self.bucket, key)
        return self.object_size(key)

    def download_file(self, key: str, local_path: str) -> None:
        self._s3.download_file(self.bucket, key, local_path)

    def delete_file(self, key: str) -> None:
        self._s3.delete_object(Bucket=self.bucket, Key=key)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        r = self._s3.get_object(
            Bucket=self.bucket, Key=key,
            Range=f"bytes={offset}-{offset + size - 1}",
        )
        return r["Body"].read()

    def object_size(self, key: str) -> int:
        return self._s3.head_object(Bucket=self.bucket, Key=key)[
            "ContentLength"
        ]


class RcloneBackend(BackendStorage):
    """Tier volumes through the `rclone` CLI to any of its ~70 remotes
    (`weed/storage/backend/rclone_backend/rclone_backend.go` — which links
    the rclone library; shelling the binary is the same data path rclone
    users script). `key_template` substitutes `{key}` like the reference's
    Go text/template key_template option."""

    kind = "rclone"

    def __init__(self, backend_id: str, remote_name: str,
                 key_template: str = "{key}",
                 rclone_binary: str = "rclone") -> None:
        super().__init__(backend_id)
        import shutil as _shutil

        self.remote = remote_name
        self.key_template = key_template
        self.binary = rclone_binary
        if _shutil.which(self.binary) is None:
            raise BackendError(
                f"rclone backend needs the '{self.binary}' binary on PATH"
            )

    def _target(self, key: str) -> str:
        return f"{self.remote}:{self.key_template.format(key=key)}"

    def _run(self, args: list, data: bytes | None = None) -> bytes:
        import subprocess

        try:
            proc = subprocess.run(
                [self.binary, *args], input=data, capture_output=True,
                timeout=3600,
            )
        except subprocess.TimeoutExpired as e:
            raise BackendError(
                f"{self.id}: rclone {args[0]} timed out"
            ) from e
        if proc.returncode != 0:
            err = BackendError(
                f"{self.id}: rclone {args[0]} failed: "
                f"{proc.stderr.decode(errors='replace')[:300]}"
            )
            err.returncode = proc.returncode
            err.stderr = proc.stderr.decode(errors="replace")
            raise err
        return proc.stdout

    def upload_file(self, local_path: str, key: str) -> int:
        self._run(["copyto", local_path, self._target(key)])
        return os.path.getsize(local_path)

    def download_file(self, key: str, local_path: str) -> None:
        self._run(["copyto", self._target(key), local_path])

    def delete_file(self, key: str) -> None:
        try:
            self._run(["deletefile", self._target(key)])
        except BackendError as e:
            # only not-found is benign (rclone exit 3/4 = dir/file not
            # found); anything else would silently orphan a remote object
            rc = getattr(e, "returncode", None)
            msg = getattr(e, "stderr", "").lower()
            if rc in (3, 4) or "not found" in msg or "doesn't exist" in msg:
                return
            raise

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        return self._run([
            "cat", "--offset", str(offset), "--count", str(size),
            self._target(key),
        ])

    def object_size(self, key: str) -> int:
        import json as _json

        out = self._run(["size", "--json", self._target(key)])
        return int(_json.loads(out)["bytes"])


class MmapFile(BackendStorageFile):
    """mmap-backed volume file (`memory_map/memory_map_backend.go`): reads
    are zero-syscall page-cache loads — the win for read-heavy volumes with
    many small needles; writes go through pwrite and the mapping is
    re-extended when the file grows past it."""

    def __init__(self, path: str, create: bool = False) -> None:
        import mmap as _mmap

        self._mmap_mod = _mmap
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        self._map: "_mmap.mmap | None" = None
        self._map_size = 0
        self._lock = threading.Lock()
        self._remap()

    def _remap(self) -> None:
        size = os.fstat(self._fd).st_size
        if self._map is not None:
            self._map.close()
            self._map = None
        if size > 0:
            self._map = self._mmap_mod.mmap(
                self._fd, size, prot=self._mmap_mod.PROT_READ
            )
        self._map_size = size

    def read_at(self, size: int, offset: int) -> bytes:
        with self._lock:
            end = offset + size
            if end > self._map_size:
                if end <= os.fstat(self._fd).st_size:
                    self._remap()
                else:
                    return os.pread(self._fd, size, offset)  # racing append
            if self._map is None:
                return b""
            return bytes(self._map[offset:min(end, self._map_size)])

    def write_at(self, data: bytes, offset: int) -> int:
        n = os.pwrite(self._fd, data, offset)
        # lazily remapped on the next out-of-range read
        return n

    def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)
        with self._lock:
            self._remap()

    def sync(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        with self._lock:
            if self._map is not None:
                self._map.close()
                self._map = None
        os.close(self._fd)

    def file_size(self) -> int:
        return os.fstat(self._fd).st_size


_registry: dict[str, BackendStorage] = {}
_registry_lock = threading.Lock()


def configure_backend(backend_id: str, kind: str, **kwargs) -> BackendStorage:
    """Register a tier backend (reference: master.toml `[storage.backend]`
    pushed to volume servers via heartbeat ack)."""
    with _registry_lock:
        if kind == "local":
            b: BackendStorage = LocalObjectBackend(backend_id, kwargs["root"])
        elif kind == "s3":
            b = S3Backend(backend_id, **kwargs)
        elif kind == "rclone":
            b = RcloneBackend(backend_id, **kwargs)
        else:
            raise BackendError(f"unknown backend kind {kind!r}")
        _registry[backend_id] = b
        return b


def get_backend(backend_id: str) -> BackendStorage:
    with _registry_lock:
        b = _registry.get(backend_id)
    if b is None:
        raise BackendError(f"backend {backend_id!r} not configured")
    return b


def list_backends() -> dict[str, BackendStorage]:
    with _registry_lock:
        return dict(_registry)
