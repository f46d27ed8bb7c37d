"""Fastlane: the native epoll front door for the volume data plane, the
master's `/dir/assign` and the filer's namespace.

The C++ engine (`csrc/fastlane.cpp`) owns the hot HTTP path — GET/POST/PUT/
DELETE of `/<vid>,<fid>` on a volume server, `/dir/assign` on a master,
inline and single-chunk files on a filer (its filer mode: a journal of
entry frames, a pool of leased fids and a path cache, driven from
`server/filer.py`) — and proxies everything else to the Python
HTTPService, mirroring how the
reference serves its data plane from compiled code across all cores
(`weed/server/volume_server_handlers_*.go`) while Python keeps volume
lifecycle, admin plane, and replication. The port's copy of
`seaweedfs_tpu/storage/fastlane.py`.

Responsibilities of this wrapper:
  * start/stop an engine in front of a backend port
  * register volumes (dup'd .dat fd + a fresh O_APPEND .idx fd + a bulk
    needle-map load) and keep C-side flags in sync
  * drain the engine's append/delete event queue into the Python-side
    needle maps (memory-only: the engine already wrote the .idx entries)
  * lend Python's own rare appends the engine's per-volume lock + tail
    (`Volume._append_lock` uses the hook installed here)
  * expose the filer front's accounting (`front_metrics`,
    `front_metric_lines`) and charge natively served requests to QoS
    (`qos_charge_usage`)

The engine is built from the repo's own sources (`ops/_build.FASTLANE`,
g++ at first use), so every symbol below is bound plainly: a missing one
raises, as does a failed build, load or `sw_fl_start`. Only the documented
gates leave Python serving: `available()` (4-byte offsets, and the opt-out
SEAWEEDFS_TPU_DISABLE_FASTLANE=1) and `front_service`'s bail-outs.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time

import numpy as np

from ..ops import _build
from ..stats import trace as _trace
from ..util import faults as _faults
from .backend import DiskFile, MmapFile
from .types import OFFSET_BYTES

_EVENT_SIZE = 48
# vid, op, key, offset, size, pad, ns, trace_id
_EVENT = struct.Struct("<IIQQiIQQ")

# drain-seam fault point: latency/error here widen the engine->Python
# visibility window (read-your-writes across cores), the exact race the
# delete-fence machinery must absorb. The engine has no injection ABI of
# its own, so this Python-side seam carries engine-side injection alone.
_FP_DRAIN = _faults.register("volume.fastlane.drain")

_c = ctypes
_SIGNATURES = {
    # name: (restype, argtypes)
    "sw_fl_start": (_c.c_int, (
        _c.c_char_p, _c.c_int, _c.c_char_p, _c.c_int,  # host, port, backend
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,  # workers, secure r/w, max_backend
        _c.c_char_p, _c.c_char_p,  # jwt write / read keys
        _c.c_char_p, _c.c_char_p, _c.c_char_p, _c.c_char_p,  # tls cert, key, ca, cns
    )),
    "sw_fl_volume_serving": (_c.c_int, (_c.c_int, _c.c_uint32)),
    "sw_fl_port": (_c.c_int, (_c.c_int,)),
    "sw_fl_stop": (None, (_c.c_int,)),
    "sw_fl_register_volume": (_c.c_int, (
        _c.c_int, _c.c_uint32, _c.c_int, _c.c_int, _c.c_int,
        _c.c_ulonglong, _c.c_ulonglong, _c.c_int, _c.c_int,
    )),
    "sw_fl_load_entries": (_c.c_int, (
        _c.c_int, _c.c_uint32, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_size_t,
    )),
    "sw_fl_unregister_volume": (_c.c_int, (_c.c_int, _c.c_uint32)),
    "sw_fl_set_flags": (_c.c_int, (_c.c_int, _c.c_uint32, _c.c_int, _c.c_int)),
    "sw_fl_volume_lock": (_c.c_int, (_c.c_int, _c.c_uint32)),
    "sw_fl_volume_unlock": (_c.c_int, (_c.c_int, _c.c_uint32)),
    "sw_fl_tail_get": (_c.c_ulonglong, (_c.c_int, _c.c_uint32)),
    "sw_fl_tail_set": (_c.c_int, (
        _c.c_int, _c.c_uint32, _c.c_ulonglong, _c.c_ulonglong,
    )),
    "sw_fl_map_put": (_c.c_int, (
        _c.c_int, _c.c_uint32, _c.c_uint64, _c.c_ulonglong, _c.c_int32,
    )),
    "sw_fl_drain_events": (_c.c_long, (_c.c_int, _c.c_void_p, _c.c_size_t)),
    "sw_fl_get_stats": (None, (_c.c_int, _c.c_void_p)),
    "sw_fl_assign_set": (_c.c_int, (
        _c.c_int, _c.c_char_p, _c.c_void_p, _c.c_char_p, _c.c_size_t,
        _c.c_ulonglong, _c.c_ulonglong,
    )),
    "sw_fl_assign_clear": (_c.c_int, (_c.c_int,)),
    "sw_fl_error_str": (_c.c_char_p, (_c.c_int,)),
    "sw_fl_tls_client_ok": (_c.c_int, (_c.c_int,)),
    # filer mode
    "sw_fl_filer_enable": (_c.c_int, (
        _c.c_int, _c.c_char_p, _c.c_ulonglong, _c.c_int,  # journal, chunk size, compress
    )),
    "sw_fl_filer_lease_set": (_c.c_int, (
        _c.c_int, _c.c_char_p, _c.c_int, _c.c_uint32,  # volume host, port, vid
        _c.c_uint32, _c.c_ulonglong, _c.c_ulonglong,  # cookie, key range
        _c.c_char_p, _c.c_char_p,  # upload / read auth
    )),
    "sw_fl_filer_lease_remaining": (_c.c_ulonglong, (_c.c_int,)),
    "sw_fl_filer_lease_count": (_c.c_long, (_c.c_int,)),
    "sw_fl_filer_cache_put": (_c.c_int, (
        _c.c_int, _c.c_char_p, _c.c_char_p, _c.c_int,  # path, volume host, port
        _c.c_char_p, _c.c_char_p, _c.c_char_p,  # fid, mime, md5
        _c.c_ulonglong, _c.c_ulonglong, _c.c_char_p, _c.c_size_t,  # size, mtime, inline
    )),
    "sw_fl_filer_cache_del": (_c.c_int, (_c.c_int, _c.c_char_p)),
    "sw_fl_filer_drain": (_c.c_long, (_c.c_int, _c.c_void_p, _c.c_size_t)),
    "sw_fl_filer_journal_reset": (_c.c_long, (_c.c_int,)),
    "sw_fl_filer_rules_set": (_c.c_int, (_c.c_int, _c.c_char_p, _c.c_size_t)),
    "sw_fl_front_metrics": (_c.c_long, (_c.c_int, _c.c_void_p, _c.c_size_t)),
    # per-op metrics
    "sw_fl_get_metrics": (_c.c_long, (_c.c_int, _c.c_void_p, _c.c_size_t)),
    "sw_fl_get_volume_metrics": (_c.c_int, (_c.c_int, _c.c_uint32, _c.c_void_p)),
    # per-collection usage
    "sw_fl_volume_collection_set": (_c.c_int, (_c.c_int, _c.c_uint32, _c.c_char_p)),
    "sw_fl_get_usage": (_c.c_long, (_c.c_int, _c.c_void_p, _c.c_size_t)),
    # online-EC stripe accumulator
    "sw_fl_ec_online_arm": (_c.c_int, (
        _c.c_int, _c.c_uint32, _c.c_ulonglong, _c.c_ulonglong,
    )),
    "sw_fl_ec_online_pending": (_c.c_longlong, (_c.c_int, _c.c_uint32, _c.c_void_p)),
    "sw_fl_ec_online_advance": (_c.c_int, (_c.c_int, _c.c_uint32, _c.c_ulonglong)),
}


def _bind(lib) -> None:
    """Declare the engine's ABI on the loaded library. A missing symbol
    raises AttributeError: the library is built from this checkout."""
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


_bound = None
_bind_lock = threading.Lock()


def _get_lib():
    """The engine library, built at first use and bound once."""
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = _build.load(_build.FASTLANE)
            _bind(lib)
            _bound = lib
        return _bound


def available() -> bool:
    """The engine fronts a server unless the offsets are 5 bytes (its
    records and .idx entries are 4-byte-offset only) or the process opted
    out with SEAWEEDFS_TPU_DISABLE_FASTLANE=1."""
    return OFFSET_BYTES == 4 and os.environ.get("SEAWEEDFS_TPU_DISABLE_FASTLANE") != "1"


class VolumeHook:
    """Installed on a registered Volume: Python-side appends borrow the
    engine's per-volume lock and authoritative tail."""

    def __init__(self, engine: "Fastlane", vid: int) -> None:
        self.engine = engine
        self.vid = vid

    def lock(self) -> None:
        self.engine._lib.sw_fl_volume_lock(self.engine.handle, self.vid)

    def unlock(self) -> None:
        self.engine._lib.sw_fl_volume_unlock(self.engine.handle, self.vid)

    def tail_get(self) -> int:
        return int(self.engine._lib.sw_fl_tail_get(self.engine.handle, self.vid))

    def tail_set(self, tail: int, last_ns: int) -> None:
        self.engine._lib.sw_fl_tail_set(self.engine.handle, self.vid, tail, last_ns)

    def map_put(self, key: int, offset: int, size: int) -> None:
        self.engine._lib.sw_fl_map_put(self.engine.handle, self.vid, key, offset, size)

    def map_del(self, key: int) -> None:
        self.engine._lib.sw_fl_map_put(self.engine.handle, self.vid, key, 0, -1)


METRIC_OPS = ("read", "write", "delete", "assign", "proxied")

# front-door accounting name tables — mirror kFr*/kFb* in fastlane.cpp
FRONT_OPS = ("read", "write", "delete")
FALLBACK_REASONS = (
    "cache_miss", "no_lease", "lease_spent", "too_large", "body_shape",
    "system_path", "query", "backpressure", "upstream", "auth",
    "bucket_state", "other",
)
# reasons that indicate a BROKEN native path (vs expected gate traffic);
# the fastlane_fallback alert rate-filters on these
PATHOLOGICAL_REASONS = (
    "no_lease", "lease_spent", "backpressure", "upstream",
)


def error_str(lib, rc: int) -> str:
    """Typed engine error for a negative rc (sw_fl_error_str)."""
    return (lib.sw_fl_error_str(int(rc)) or b"").decode() or f"rc={rc}"


def front_metric_lines(engine: "Fastlane", prefix: str, server: str) -> list[str]:
    """Exposition lines for the front-door counters:
    `<prefix>_native_total{op}` and `<prefix>_fallback_total{op,reason}` —
    a silent fall-back regime (a rejected lease, say) becomes a visible
    rate instead of a log line."""
    from ..stats.metrics import _fmt_labels

    fm = engine.front_metrics()
    lines = [
        f"# HELP {prefix}_native_total front-door requests served natively",
        f"# TYPE {prefix}_native_total counter",
    ]
    if fm is None:
        return lines
    for op, st in fm.items():
        lines.append(f"{prefix}_native_total"
                     f"{_fmt_labels(('server', 'op'), (server, op))} {st['native']}")
    lines.append(f"# TYPE {prefix}_fallback_total counter")
    for op, st in fm.items():
        for reason, n in st["fallback"].items():
            lines.append(
                f"{prefix}_fallback_total"
                f"{_fmt_labels(('server', 'op', 'reason'), (server, op, reason))} {n}")
    return lines


def qos_charge_usage(engine: "Fastlane | None", state: dict) -> dict:
    """Debit natively served requests to QoS after the fact: the engine
    front door never blocks on Python, so the per-collection request
    deltas of `usage_metrics` (against `state`, the caller's previous
    snapshot) are charged to the admission controller's token buckets
    (`qos/admission.py`), and the limit holds across both paths — once a
    bucket runs dry the Python path sheds typed. Returns the snapshot to
    hold for the next call. Charges nothing while the controller is
    unarmed."""
    from ..qos import admission as qos_mod

    if engine is None or engine.stopped:
        return state
    snap = engine.usage_metrics()
    if not snap:
        return state
    ctl = qos_mod.controller()
    if ctl.armed:
        for coll, row in snap.items():
            prev = state.get(coll, {})
            d_req = sum(max(0, row[f] - prev.get(f, 0))
                        for f in ("reads", "writes", "deletes"))
            if d_req > 0:
                ctl.charge(coll or "default", float(d_req))
    return snap


class Fastlane:
    def __init__(self, lib, handle: int, tls: bool = False) -> None:
        self._lib = lib
        self.handle = handle
        self.stopped = False
        self.tls = tls  # engine terminates mTLS itself: URLs are https
        # can the engine reach upstream (volume) engines natively? Under
        # mTLS this needs the C++ TLS *client* context too
        self.tls_client_ok = bool(lib.sw_fl_tls_client_ok(handle))
        self.port = int(lib.sw_fl_port(handle))
        self._volumes: dict[int, object] = {}  # vid -> Volume (drain target)
        # RLock: unregister_volume holds it around the volume write lock
        # (lock order _drain_mu -> _write_lock, same as the drain loop) and
        # then drains inline
        self._drain_mu = threading.RLock()
        self._buf = ctypes.create_string_buffer(_EVENT_SIZE * 4096)
        # span-synthesis budget (tokens/second): the engine can push tens of
        # thousands of events/s, and unthrottled synthesis would churn every
        # real request trace out of the bounded ring. Metrics count EVERY
        # event; spans are a bounded sample.
        self._span_sec = -1
        self._span_quota = 0

    @staticmethod
    def start(host: str, port: int, backend_port: int,
              secure_reads: bool = False, max_backend: int = 0,
              backend_host: str = "",
              jwt_write_key: str = "", jwt_read_key: str = "",
              tls_cert: str = "", tls_key: str = "", tls_ca: str = "",
              tls_allowed_cns: str = "") -> "Fastlane":
        """Start an engine on host:port in front of the backend, with one
        worker a core up to 8 and writes served natively (the engine checks
        a write JWT against jwt_write_key itself). `max_backend` caps the
        proxied requests in flight to the backend (0: the engine's
        default; long-poll meta subscriptions bypass the cap). Raises
        RuntimeError with the engine's typed error when it cannot start
        (the port is taken, the OpenSSL runtime or the certs are bad)."""
        lib = _get_lib()
        workers = min(8, (os.cpu_count() or 2))
        h = int(lib.sw_fl_start(host.encode(), port,
                                (backend_host or host).encode(), backend_port,
                                workers, 1 if secure_reads else 0, 0, max_backend,
                                jwt_write_key.encode(), jwt_read_key.encode(),
                                tls_cert.encode(), tls_key.encode(),
                                tls_ca.encode(), tls_allowed_cns.encode()))
        if h < 0:
            raise RuntimeError(
                f"fastlane engine failed to start on {host}:{port}: {error_str(lib, h)}")
        return Fastlane(lib, h, tls=bool(tls_cert))

    def stop(self) -> None:
        # flagged BEFORE the C stop: background loops check it so they
        # never operate on a dead handle
        self.stopped = True
        self._lib.sw_fl_stop(self.handle)
        self._volumes.clear()

    # --- volume lifecycle ---------------------------------------------------
    def register_volume(self, volume, forward_writes: bool = False) -> bool:
        """Hand a Volume's data plane to the engine. Returns False for
        shapes the engine does not serve (tiered/remote .dat, v1) and once
        the engine has stopped; any other refusal raises RuntimeError with
        the engine's message, so no served volume falls back quietly.

        Runs entirely under the volume's write lock: a Python-path append
        racing the handoff could otherwise land between the map snapshot
        and the hook installation — invisible to the engine's map (native
        reads 404 an acked write) and, worse, behind the engine's tail
        (the next native append overwrites it). With the lock held, every
        Python append either fully precedes the snapshot or sees the hook."""
        if not isinstance(volume._dat, (DiskFile, MmapFile)):
            return False  # remote-tiered: reads proxy to Python
        if volume.version() not in (2, 3):
            return False
        with volume._write_lock:
            dat_fd = os.dup(volume._dat._fd)
            idx_fd = os.open(volume.base_name + ".idx",
                             os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            rc = self._lib.sw_fl_register_volume(
                self.handle, volume.id, dat_fd, idx_fd, volume.version(),
                volume._size, volume.last_append_at_ns,
                1 if volume.readonly else 0, 1 if forward_writes else 0,
            )
            if rc != 0:
                os.close(dat_fd)
                os.close(idx_fd)
                if self.stopped:  # flagged before the C stop: a shutdown race
                    return False
                raise RuntimeError(
                    f"fastlane engine refused volume {volume.id}: {error_str(self._lib, rc)}")
            self._load_map(volume)
            volume._fl_hook = VolumeHook(self, volume.id)
            self._volumes[volume.id] = volume
            # until this call the engine proxies the volume's traffic:
            # arming it before the bulk load would 404 existing needles
            self._lib.sw_fl_volume_serving(self.handle, volume.id)
            self._lib.sw_fl_volume_collection_set(
                self.handle, volume.id, (volume.collection or "").encode()[:63])
        return True

    def _load_map(self, volume) -> None:
        entries = list(volume.nm.ascending_visit())
        n = len(entries)
        if n == 0:
            return
        keys = np.fromiter((e[0] for e in entries), dtype=np.uint64, count=n)
        offs = np.fromiter((e[1] for e in entries), dtype=np.uint64, count=n)
        sizes = np.fromiter((e[2] for e in entries), dtype=np.int32, count=n)
        self._lib.sw_fl_load_entries(
            self.handle, volume.id, keys.ctypes.data, offs.ctypes.data,
            sizes.ctypes.data, n,
        )

    def unregister_volume(self, vid: int) -> None:
        # order matters: the C call waits out any in-flight append (whose
        # event lands in the queue), the drain then applies every event
        # while the volume is still a drain target, and only then does the
        # vid stop being tracked — no acked write can slip through. The
        # whole sequence holds the volume's write lock: a Python append
        # racing it would find the engine's per-volume lock/tail already
        # gone (hook no-ops) and append at a stale _size, overwriting
        # engine-written records the drain had not yet applied.
        v = self._volumes.get(vid)
        if v is None:
            self._lib.sw_fl_unregister_volume(self.handle, vid)
            self.drain()
            return
        # lock order matches the drain loop (_drain_mu -> _write_lock);
        # _drain_mu is an RLock so the inline drain re-enters it
        with self._drain_mu:
            with v._write_lock:
                self._lib.sw_fl_unregister_volume(self.handle, vid)
                self.drain(locked_vid=vid)
                self._volumes.pop(vid, None)
                v._fl_hook = None

    def set_flags(self, vid: int, readonly: bool, forward_writes: bool) -> None:
        self._lib.sw_fl_set_flags(self.handle, vid, 1 if readonly else 0,
                                  1 if forward_writes else 0)

    # --- event drain --------------------------------------------------------
    def drain(self, locked_vid: int | None = None) -> int:
        """Apply engine-side appends/deletes to the Python needle maps
        (memory-only — the engine already wrote .dat and .idx), and
        synthesize events into finished spans in the shared trace ring:
        natively-served writes never touch a Python handler, so without
        this `cluster.trace` would be blind to the whole data plane. Span
        synthesis is budgeted per second so a native write storm cannot
        evict every real request trace from the bounded ring.

        locked_vid: a volume whose _write_lock the CALLER already holds
        (unregister_volume) — its events apply without re-taking it."""
        _FP_DRAIN.hit()  # latency widens the cross-core visibility
        # window; error skips a tick (the loop's except absorbs it) —
        # both are what the delete-fence/read-retry paths must survive
        total = 0
        with self._drain_mu:
            while True:
                n = int(self._lib.sw_fl_drain_events(
                    self.handle, ctypes.addressof(self._buf), 4096))
                if n <= 0:
                    break
                for i in range(n):
                    (vid, op, key, offset, size, _, ns,
                     tid) = _EVENT.unpack_from(self._buf, i * _EVENT_SIZE)
                    sec = int(time.monotonic())
                    if sec != self._span_sec:
                        self._span_sec = sec
                        self._span_quota = 128
                    # a traced event (a relayed chunk PUT carrying the
                    # originating X-Sw-Trace-Id) always synthesizes — its
                    # span completes an end-to-end chain in cluster.trace;
                    # only anonymous storm traffic is budget-sampled
                    if tid or self._span_quota > 0:
                        if not tid:
                            self._span_quota -= 1
                        _trace.record_span(
                            "fastlane.append" if op == 0 else "fastlane.delete",
                            role="volume", start=ns / 1e9,
                            trace_id=f"{tid:016x}" if tid else None,
                            attrs={"vid": vid, "key": f"{key:x}",
                                   "size": size, "native": True},
                        )
                    v = self._volumes.get(vid)
                    if v is None:
                        continue
                    if op == 0:
                        v.nm.apply_external(key, offset, size)
                    else:
                        v.nm.apply_external_delete(key, size)
                    # _size/last_append read-modify-write must not race a
                    # Python append's own store (Volume._append_lock holds
                    # the same lock)
                    end = offset + v._record_size(size if op == 0 else 0)
                    if vid == locked_vid:  # caller already holds it
                        v._size = max(v._size, end)
                        v.last_append_at_ns = max(v.last_append_at_ns, ns)
                    else:
                        with v._write_lock:
                            v._size = max(v._size, end)
                            v.last_append_at_ns = max(v.last_append_at_ns, ns)
                total += n
                if n < 4096:
                    break
        return total

    # --- master assign profiles --------------------------------------------
    def assign_set(self, query: str, entries: list, key_start: int,
                   key_end: int) -> None:
        """Install the native /dir/assign responder for one exact query
        string. entries: [(vid, tail_json)] — tail_json is the response
        after the fid field. [key_start, key_end) is a leased key range."""
        vids = np.fromiter((e[0] for e in entries), dtype=np.uint32,
                           count=len(entries))
        tails = b"".join(e[1].encode() + b"\0" for e in entries)
        self._lib.sw_fl_assign_set(
            self.handle, query.encode(), vids.ctypes.data, tails,
            len(entries), key_start, key_end,
        )

    def assign_clear(self) -> None:
        self._lib.sw_fl_assign_clear(self.handle)

    def stats(self) -> dict:
        out = (ctypes.c_ulonglong * 6)()
        self._lib.sw_fl_get_stats(self.handle, out)
        return {
            "requests": int(out[0]),
            "native_reads": int(out[1]),
            "native_writes": int(out[2]),
            "native_deletes": int(out[3]),
            "proxied": int(out[4]),
            "native_assigns": int(out[5]),
        }

    # --- per-op metrics -------------------------------------------------------
    def metrics(self) -> dict | None:
        """Per-op latency histograms + byte counters from the engine, or
        None once it has stopped. Shape: {"bounds_s": [...], "ops": {op:
        {"count", "bytes", "seconds_sum", "buckets": [... len(bounds_s)+1,
        last = +Inf overflow]}}}."""
        cap = 512
        buf = (ctypes.c_ulonglong * cap)()
        n = int(self._lib.sw_fl_get_metrics(self.handle, buf, cap))
        if n < 2:
            return None
        n_ops, n_buckets = int(buf[0]), int(buf[1])
        bounds_s = [buf[2 + i] / 1e9 for i in range(n_buckets)]
        ops: dict[str, dict] = {}
        o = 2 + n_buckets
        for i in range(n_ops):
            ops[METRIC_OPS[i]] = {
                "count": int(buf[o]),
                "bytes": int(buf[o + 1]),
                "seconds_sum": buf[o + 2] / 1e9,
                "buckets": [int(buf[o + 3 + j]) for j in range(n_buckets + 1)],
            }
            o += 3 + n_buckets + 1
        return {"bounds_s": bounds_s, "ops": ops}

    def front_metrics(self) -> dict | None:
        """Front-door accounting of filer mode: per-op native and
        typed-reason fallback counts, or None once the engine has stopped.
        Shape: {op: {"native": n, "fallback": {reason: n}}}."""
        cap = 2 + len(FRONT_OPS) + len(FRONT_OPS) * len(FALLBACK_REASONS) + 64
        buf = (ctypes.c_ulonglong * cap)()
        n = int(self._lib.sw_fl_front_metrics(self.handle, buf, cap))
        if n < 2:
            return None
        n_ops, n_reasons = int(buf[0]), int(buf[1])
        out: dict[str, dict] = {}
        for i in range(n_ops):
            fb_base = 2 + n_ops + i * n_reasons
            out[FRONT_OPS[i]] = {
                "native": int(buf[2 + i]),
                "fallback": {FALLBACK_REASONS[j]: int(buf[fb_base + j])
                             for j in range(n_reasons)},
            }
        return out

    def lease_count(self) -> int:
        """Live (unspent) filer leases in the pool; -1 = engine stopped."""
        return int(self._lib.sw_fl_filer_lease_count(self.handle))

    # --- online-EC stripe accumulator ----------------------------------------
    def ec_online_arm(self, vid: int, stripe_bytes: int, watermark: int) -> bool:
        """Arm (or re-sync) the engine's per-volume stripe accumulator so
        the drain loop can poll encode-readiness in O(1)."""
        return int(self._lib.sw_fl_ec_online_arm(
            self.handle, vid, stripe_bytes, watermark)) == 0

    def ec_online_pending(self, vid: int) -> tuple[int, int] | None:
        """(complete stripes pending, append tail) for an armed volume;
        None when the volume is not registered or not armed (the caller
        re-derives from the Python-side tail)."""
        out = (ctypes.c_ulonglong * 2)()
        n = int(self._lib.sw_fl_ec_online_pending(
            self.handle, vid, ctypes.addressof(out)))
        if n < 0:
            return None
        return n, int(out[1])

    def ec_online_advance(self, vid: int, watermark: int) -> bool:
        """Re-sync the engine's armed watermark after a Python-side pump
        (Python-path writes pump inline and would otherwise leave the
        accumulator permanently 'pending', defeating the O(1) skip)."""
        return int(self._lib.sw_fl_ec_online_advance(
            self.handle, vid, watermark)) == 0

    def volume_metrics(self, vid: int) -> dict | None:
        """Per-volume native-op counters, or None for an unknown vid."""
        out = (ctypes.c_ulonglong * 6)()
        rc = int(self._lib.sw_fl_get_volume_metrics(self.handle, vid, out))
        if rc != 0:
            return None
        return {
            "reads": int(out[0]),
            "writes": int(out[1]),
            "deletes": int(out[2]),
            "read_bytes": int(out[3]),
            "write_bytes": int(out[4]),
            "tail": int(out[5]),
        }

    def usage_metrics(self) -> dict | None:
        """Per-collection cumulative native-op counters keyed by collection
        name, or None once the engine has stopped."""
        cap = 65536
        buf = ctypes.create_string_buffer(cap)
        n = int(self._lib.sw_fl_get_usage(self.handle, buf, cap))
        if n < 0:
            return None
        out: dict[str, dict] = {}
        for line in buf.raw[:n].decode(errors="replace").splitlines():
            parts = line.split("\t")
            if len(parts) != 6:
                continue
            try:
                vals = [int(x) for x in parts[1:]]
            except ValueError:
                continue
            out[parts[0]] = {
                "reads": vals[0], "writes": vals[1], "deletes": vals[2],
                "read_bytes": vals[3], "write_bytes": vals[4],
            }
        return out


def front_service(service, guard_active: bool = False, max_backend: int = 0,
                  secure_reads: bool = False, jwt_write_key: str = "",
                  jwt_read_key: str = "") -> "Fastlane | None":
    """Start `service` (an HTTPService) behind an engine front when the
    gates allow, else plainly on its requested port (returning None). The
    master, the volume server and the filer share it: one copy of the gate
    checks and the ephemeral-backend dance. An engine that fails to start
    raises (after stopping the service): there is no quiet fallback.

    With process-wide mTLS configured (`weed/security/tls.go` semantics)
    the ENGINE terminates TLS: client certs are required against the CA,
    the CommonName allow-list is enforced per request in C++, and the
    Python backend listens in plaintext on loopback only (the engine is
    the sole front door — same trust model as the reference's
    -filer.localSocket plaintext listener for same-host peers)."""
    from ..security import tls as _tlsmod

    if not available() or guard_active:
        service.start()
        return None
    requested = service.port
    tls_cfg = _tlsmod.current_config()
    tls_kwargs = {}
    if tls_cfg is not None and tls_cfg.enabled:
        service.plain_backend = True  # engine owns the TLS handshake
        tls_kwargs = dict(
            backend_host="127.0.0.1",
            tls_cert=tls_cfg.cert, tls_key=tls_cfg.key, tls_ca=tls_cfg.ca,
            tls_allowed_cns=tls_cfg.allowed_common_names,
        )
    service.port = 0
    service.start()
    try:
        return Fastlane.start(
            service.host, requested, service.port,
            secure_reads=secure_reads, max_backend=max_backend,
            jwt_write_key=jwt_write_key,
            jwt_read_key=jwt_read_key, **tls_kwargs,
        )
    except BaseException:
        service.stop()
        raise
