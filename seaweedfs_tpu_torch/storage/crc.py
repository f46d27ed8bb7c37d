"""CRC32-Castagnoli needle checksums (`weed/storage/needle/crc.go:12-55`).

The port's counterpart of `seaweedfs_tpu/storage/crc.py`. Checksums run in
the host library `csrc/crc32c_host.cpp`, built with g++ at first use (see
ops/_build.py); if it cannot be built, the call raises. `update_numpy` is
the plain table reference the tests hold the library against: it is
byte-serial Python, far too slow for a volume.

Streaming semantics match Go's hash/crc32: `update(crc, data)` continues a
previous CRC, `crc32c(data) == update(0, data)`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from seaweedfs_tpu_torch.ops import _build

_CASTAGNOLI_POLY_REFLECTED = 0x82F63B78


def _make_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CASTAGNOLI_POLY_REFLECTED if c & 1 else 0)
        t[i] = c
    return t


_TABLE = _make_table()


def update_numpy(crc: int, data) -> int:
    """Plain reference: one table step per byte."""
    c = crc ^ 0xFFFFFFFF
    for b in np.frombuffer(bytes(data), dtype=np.uint8).tolist():
        c = int(_TABLE[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _lib_update():
    fn = _build.load(_build.CRC32C_HOST).crc32c_update
    if fn.argtypes is None:
        fn.argtypes = (ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t)
        fn.restype = ctypes.c_uint32
    return fn


def update(crc: int, data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """Continue a CRC32C over more data (Go crc32.Update semantics)."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return _lib_update()(crc & 0xFFFFFFFF, buf.ctypes.data, buf.nbytes)


def crc32c(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    return update(0, data)


def legacy_value(crc: int) -> int:
    """Deprecated on-disk CRC transform kept for backward compatibility
    (`weed/storage/needle/crc.go:26-29`): rotate + magic constant. Readers must
    accept both this and the raw value."""
    rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF
