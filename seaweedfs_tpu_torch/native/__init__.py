"""Host code of the dedup write path and the native load drivers: the port's
counterpart of those functions of the JAX package's `native/__init__.py`,
under the same names and return shapes.

  fast128               SW128 of one buffer (16 bytes): the dedup identity hash
  fast128_spans         SW128 per CDC span of one buffer, (n, 16) uint8
  md5_spans             MD5 per (offset, length) span, (n, 16) uint8
  md5_crc_batch_spans   MD5 and CRC32C per CDC span, ((n, 16) uint8, (n,) uint32)
  hmac_sha256           HMAC-SHA256 as the fastlane engine computes it for
                        its native JWT checks (32 bytes)
  loadgen               keep-alive HTTP requests from one epoll thread:
                        {ok, errors, seconds, req_per_sec}
  loadgen_assign_write  per-file /dir/assign then POST (`weed benchmark`'s
                        write shape), the same dict

They run in the port's host libraries (`csrc/fast128.cpp`, `csrc/md5_host.cpp`,
`csrc/crc32c_host.cpp`, the engine's `csrc/fastlane.cpp` with
`csrc/sha256.cpp`, and `csrc/loadgen.cpp`), built with g++ at first use by
`ops/_build.py`. If a library cannot be built, the call raises: there is no
scalar route. Cuts are exclusive chunk ends, as `ops/cdc.find_boundaries`
returns them.
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
    "sw_hmac_sha256": (_build.FASTLANE, None, (
        ctypes.c_char_p, ctypes.c_size_t,  # key, len
        ctypes.c_char_p, ctypes.c_size_t,  # message, len
        ctypes.c_char_p,  # out (32,)
    )),
    "sw_loadgen": (_build.LOADGEN, ctypes.c_int, (
        ctypes.c_char_p,  # host
        ctypes.c_int,  # port
        ctypes.c_int,  # concurrent keep-alive conns
        ctypes.c_char_p,  # method
        ctypes.c_char_p,  # \0-joined paths
        ctypes.c_size_t,  # path count
        ctypes.c_char_p,  # body (POST)
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_ulonglong),  # out: ok, err, ns
    )),
    "sw_loadgen_assign_write": (_build.LOADGEN, ctypes.c_int, (
        ctypes.c_char_p,  # master host
        ctypes.c_int,  # master port
        ctypes.c_int,  # concurrent slots
        ctypes.c_size_t,  # files
        ctypes.c_char_p,  # assign path
        ctypes.c_char_p,  # body
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_ulonglong),  # out: ok, err, ns
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


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    """HMAC-SHA256 of msg under key, computed by the engine's own code."""
    out = ctypes.create_string_buffer(32)
    _fn("sw_hmac_sha256")(key, len(key), msg, len(msg), out)
    return out.raw


def _load_result(rc: int, out) -> dict:
    secs = out[2] / 1e9 if out[2] else 1.0
    result = {
        "ok": int(out[0]),
        "errors": int(out[1]),  # the C side counts every unfinished path
        "seconds": round(secs, 3),
        "req_per_sec": round(out[0] / secs, 1),
    }
    if rc != 0:
        result["error"] = f"rc={rc} (connect failure)"
    return result


def loadgen(host: str, port: int, conns: int, method: str, paths: list,
            body: bytes | None = None) -> dict:
    """Drive an HTTP server with `conns` keep-alive connections from native
    code (one epoll thread, no GIL in the request loop), each path once.
    Returns ok/err counts and req/s."""
    blob = b"".join(
        (p if isinstance(p, bytes) else p.encode()) + b"\0" for p in paths
    )
    out = (ctypes.c_ulonglong * 3)()
    rc = _fn("sw_loadgen")(host.encode(), port, conns, method.encode(), blob,
                           len(paths), body, len(body) if body else 0, out)
    return _load_result(rc, out)


def loadgen_assign_write(host: str, master_port: int, conns: int, files: int,
                         body: bytes, assign_path: str = "/dir/assign") -> dict:
    """Per-file assign -> write load (`weed benchmark` write semantics: every
    file pays a master round-trip for its fid, then a volume POST)."""
    out = (ctypes.c_ulonglong * 3)()
    rc = _fn("sw_loadgen_assign_write")(host.encode(), master_port, conns, files,
                                        assign_path.encode(), body, len(body), out)
    return _load_result(rc, out)
