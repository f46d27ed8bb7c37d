"""Volume-file backends: the port's partial copy of
`seaweedfs_tpu/storage/backend.py` (after `weed/storage/backend/backend.go:15-45`).

A volume's `.dat` lives on local disk (`DiskFile`, `disk_file.go`). Not
ported: the storage-file interface and its memory, mmap and remote
files, the object backends (local object store, S3, rclone) and
whole-volume tiering, so no backend can be configured and `get_backend`
raises for every id.
"""

from __future__ import annotations

import os


class BackendError(Exception):
    pass


class DiskFile:
    """The ReaderAt/WriterAt surface (`backend.go:15-23`) over a local file."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fd = os.open(path, os.O_RDWR)

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._fd, size, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        return os.pwrite(self._fd, data, offset)

    def close(self) -> None:
        os.close(self._fd)

    def file_size(self) -> int:
        return os.fstat(self._fd).st_size


def get_backend(backend_id: str):
    """The tier backend registered under `backend_id`. The port registers
    none (remote tiering is not ported), so this always raises."""
    raise BackendError(f"backend {backend_id!r} not configured")
