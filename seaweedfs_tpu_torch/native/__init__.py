"""Host hashing of the dedup write path: the port's counterpart of the span
functions of `seaweedfs_tpu/native/__init__.py`, under the same names and
return shapes.

  fast128              SW128 of one buffer (16 bytes): the dedup identity hash
  fast128_spans        SW128 per CDC span of one buffer, (n, 16) uint8
  md5_spans            MD5 per (offset, length) span, (n, 16) uint8
  md5_crc_batch_spans  MD5 and CRC32C per CDC span, ((n, 16) uint8, (n,) uint32)

They run in the port's host libraries (`csrc/fast128.cpp`, `csrc/md5_host.cpp`,
`csrc/crc32c_host.cpp`), built with g++ at first use by `ops/_build.py`. If a
library cannot be built, the call raises: there is no scalar route. Cuts
are exclusive chunk ends, as `ops/cdc.find_boundaries` returns them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_SIGNATURES = {
    # name: (source, restype, argtypes)
    "sw_fast128": (_build.FAST128, None, (
        ctypes.c_void_p, ctypes.c_size_t,  # data, len
        ctypes.c_char_p,  # 16-byte seed or None
        ctypes.c_void_p,  # out (16,)
    )),
    "sw_fast128_spans": (_build.FAST128, None, (
        ctypes.c_void_p,  # base buffer
        ctypes.c_void_p,  # cuts size_t[n] (exclusive ends)
        ctypes.c_size_t,
        ctypes.c_char_p,  # 16-byte seed or None
        ctypes.c_void_p,  # out (n, 16)
    )),
    "sw_md5_batch_spans": (_build.MD5_HOST, None, (
        ctypes.c_void_p,  # base buffer
        ctypes.c_void_p,  # offs size_t[n]
        ctypes.c_void_p,  # lens size_t[n]
        ctypes.c_size_t,
        ctypes.c_void_p,  # out (n, 16)
    )),
    "sw_crc32c_batch_spans": (_build.CRC32C_HOST, None, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p,  # out uint32[n]
    )),
}


def _fn(name: str):
    src, restype, argtypes = _SIGNATURES[name]
    fn = getattr(_build.load(src), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _u8(buf) -> np.ndarray:
    """A C-contiguous uint8 view of buf (bytes, memoryview or numpy)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


def _seed(seed: bytes) -> bytes | None:
    if not seed:
        return None
    if len(seed) != 16:
        raise ValueError(f"seed must be 16 bytes, got {len(seed)}")
    return bytes(seed)


def _ends(arr: np.ndarray, cuts) -> np.ndarray:
    ends = np.asarray(cuts, dtype=np.uintp).reshape(-1)
    if len(ends) and (ends[-1] > arr.nbytes or np.any(ends[1:] < ends[:-1])):
        raise ValueError("cuts must be ascending ends within the buffer")
    return ends


def _spans(arr: np.ndarray, offs, lens) -> tuple[np.ndarray, np.ndarray]:
    o = np.asarray(offs, dtype=np.uintp).reshape(-1)
    n = np.asarray(lens, dtype=np.uintp).reshape(-1)
    if len(o) != len(n) or (len(o) and np.any(o + n > arr.nbytes)):
        raise ValueError("spans must lie within the buffer")
    return o, n


def fast128(data, seed: bytes = b"") -> bytes:
    """SW128 of one buffer (16 bytes). seed: the per-store 16-byte secret;
    empty gives the unseeded golden form."""
    arr = _u8(data)
    out = np.empty(16, dtype=np.uint8)
    _fn("sw_fast128")(arr.ctypes.data, arr.nbytes, _seed(seed), out.ctypes.data)
    return out.tobytes()


def fast128_spans(buf, cuts, seed: bytes = b"") -> np.ndarray:
    """SW128 per CDC span of one contiguous buffer; (n, 16) uint8."""
    arr = _u8(buf)
    ends = _ends(arr, cuts)
    out = np.empty((len(ends), 16), dtype=np.uint8)
    _fn("sw_fast128_spans")(arr.ctypes.data, ends.ctypes.data, len(ends), _seed(seed),
                            out.ctypes.data)
    return out


def md5_spans(buf, offs, lens) -> np.ndarray:
    """MD5 of arbitrary (offset, length) spans of one buffer; (n, 16) uint8."""
    arr = _u8(buf)
    o, n = _spans(arr, offs, lens)
    digests = np.empty((len(o), 16), dtype=np.uint8)
    _fn("sw_md5_batch_spans")(arr.ctypes.data, o.ctypes.data, n.ctypes.data, len(o),
                              digests.ctypes.data)
    return digests


def md5_crc_batch_spans(buf, cuts) -> tuple[np.ndarray, np.ndarray]:
    """MD5 and CRC32C per CDC span of one buffer:
    ((n, 16) uint8 digests, (n,) uint32 crcs)."""
    arr = _u8(buf)
    ends = _ends(arr, cuts)
    offs = np.zeros_like(ends)
    offs[1:] = ends[:-1]
    lens = ends - offs
    n = len(ends)
    digests = np.empty((n, 16), dtype=np.uint8)
    crcs = np.empty(n, dtype=np.uint32)
    _fn("sw_md5_batch_spans")(arr.ctypes.data, offs.ctypes.data, lens.ctypes.data, n,
                              digests.ctypes.data)
    _fn("sw_crc32c_batch_spans")(arr.ctypes.data, offs.ctypes.data, lens.ctypes.data, n,
                                 crcs.ctypes.data)
    return digests, crcs
