"""End-to-end request tracing + data-plane kernel profiling.

A request entering any HTTPService gets (or inherits via the
`X-Sw-Trace-Id` / `X-Sw-Span` header pair) a trace id; every internal
client hop (`server.httpd.http_request` / `PooledHTTP`) re-injects the
pair, so one S3 PUT shows up as a span tree spanning the s3 gateway, the
filer, the volume servers, and the master. Spans land in a bounded
in-process ring buffer exposed at `GET /debug/traces` (recent finished
traces) and `GET /debug/requests` (in-flight), and server spans slower
than a configurable threshold are logged through `util.glog`.

On the data plane, `kernel_span`/`observe_kernel` time the Reed-Solomon
encode/decode and MD5/CRC32C hash kernels and feed Prometheus histograms
(`SeaweedFS_volume_ec_encode_seconds`, `..._decode_seconds`,
`SeaweedFS_filer_hash_seconds`) plus bytes-throughput counters, so a
BENCH run can compute GB/s per kernel from `/metrics` alone:
`rate = <family>_bytes_total / <family>_seconds_sum`.

The motivation follows arXiv:1709.05365 (per-stage EC cost attribution
across the I/O path) and arXiv:1202.3669 (measure the offload boundary
before optimizing it).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager

from seaweedfs_tpu_torch.stats.metrics import DEFAULT_BUCKETS, default_registry
from seaweedfs_tpu_torch.util import glog

TRACE_HEADER = "X-Sw-Trace-Id"
SPAN_HEADER = "X-Sw-Span"

# Kernel timings span microseconds (a 4KB hash) to minutes (a 30GB encode)
KERNEL_BUCKETS = DEFAULT_BUCKETS + (30.0, 60.0)

EC_ENCODE_SECONDS = "SeaweedFS_volume_ec_encode_seconds"
EC_DECODE_SECONDS = "SeaweedFS_volume_ec_decode_seconds"
FILER_HASH_SECONDS = "SeaweedFS_filer_hash_seconds"

_local = threading.local()

_slow_threshold_s = float(os.environ.get("SEAWEEDFS_TPU_SLOW_MS", "1000")) / 1000.0
# per-role overrides (a filer serving long directory scans can run a laxer
# threshold than the volume data plane in the same process) — set by each
# server's -slowMs flag via set_slow_threshold_ms(ms, role=...)
_slow_threshold_roles: dict[str, float] = {}


def set_slow_threshold_ms(ms: float, role: str | None = None) -> None:
    """Server spans slower than this are logged via glog (0 disables).
    With role=None sets the process default (the SEAWEEDFS_TPU_SLOW_MS
    env var's knob); with a role, overrides it for that role's spans only
    (each server entrypoint's -slowMs flag)."""
    global _slow_threshold_s
    if role is None:
        _slow_threshold_s = ms / 1000.0
    else:
        _slow_threshold_roles[role] = ms / 1000.0


def slow_threshold_s(role: str | None = None) -> float:
    return _slow_threshold_roles.get(role, _slow_threshold_s)


def _new_id() -> str:
    return os.urandom(8).hex()


def current() -> tuple[str, str] | None:
    """(trace_id, span_id) active on this thread, or None."""
    return getattr(_local, "ctx", None)


def with_trace_headers(headers: dict | None) -> dict | None:
    """Copy of `headers` carrying the active trace context; `headers`
    unchanged when no trace is active. Every internal HTTP client calls
    this, so propagation needs no per-call-site code."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return headers
    out = dict(headers or {})
    out.setdefault(TRACE_HEADER, ctx[0])
    out.setdefault(SPAN_HEADER, ctx[1])
    return out


class Span:
    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "role",
        "start", "duration", "status", "attrs", "_prev_ctx",
    )

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, role: str | None, attrs: dict | None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.role = role
        self.start = time.time()
        self.duration: float | None = None  # seconds; None = in flight
        self.status = ""
        self.attrs = dict(attrs) if attrs else {}
        self._prev_ctx = None

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "role": self.role,
            "start": self.start,
            "duration_ms": (
                round(self.duration * 1000.0, 3)
                if self.duration is not None
                else round((time.time() - self.start) * 1000.0, 3)
            ),
            "status": self.status or ("in_flight" if self.duration is None else "ok"),
            "attrs": dict(self.attrs),  # copy: serialization must not race
        }  # with the owning thread's annotate()/attr updates


class TraceCollector:
    """Bounded ring of finished spans + the in-flight set. One process-wide
    instance backs every server in the process, so a single-process test
    cluster naturally merges its hops into one trace; multi-process
    clusters are merged by `cluster.trace` fetching each node's ring."""

    def __init__(self, max_spans: int | None = None) -> None:
        if max_spans is None:
            max_spans = int(os.environ.get("SEAWEEDFS_TPU_TRACE_CAPACITY", "2048"))
        self.max_spans = max_spans
        self._ring: collections.deque[Span] = collections.deque(maxlen=max_spans)
        self._inflight: dict[str, Span] = {}
        # finished spans indexed by trace id (exemplar links and
        # /debug/traces?id= need point lookups, not a ring scan);
        # in-flight spans are found by scanning the small _inflight set
        self._by_trace: dict[str, list[Span]] = {}
        self._lock = threading.Lock()
        # self-observability (SeaweedFS_stats_trace_*): how many spans this
        # ring recorded and how many it LOST (eviction under churn, unkept
        # noise) — the losses cluster.trace can't see from the ring alone
        self.spans_total = 0
        self.dropped_total = 0

    def _append_locked(self, span: Span) -> None:
        if len(self._ring) == self.max_spans:
            # evict explicitly (not via deque maxlen) so the trace-id
            # index never holds a span the ring already lost
            old = self._ring.popleft()
            self.dropped_total += 1
            lst = self._by_trace.get(old.trace_id)
            if lst is not None:
                try:
                    lst.remove(old)
                except ValueError:
                    pass
                if not lst:
                    del self._by_trace[old.trace_id]
        self._ring.append(span)
        self._by_trace.setdefault(span.trace_id, []).append(span)
        self.spans_total += 1

    # --- span lifecycle -------------------------------------------------------
    def start_span(
        self,
        name: str,
        role: str | None = None,
        trace_id: str | None = None,
        parent_id: str | None = None,
        attrs: dict | None = None,
        activate: bool = True,
    ) -> Span:
        """Open a span. Unless trace_id/parent_id are given explicitly
        (e.g. from incoming headers), the thread's active span becomes the
        parent; a thread with no context starts a fresh trace. With
        activate=True the new span becomes the thread's context until
        finish_span restores the previous one."""
        ctx = getattr(_local, "ctx", None)
        if trace_id is None:
            if parent_id is None and ctx is not None:
                trace_id, parent_id = ctx
            else:
                trace_id = _new_id()
        sp = Span(trace_id, _new_id(), parent_id, name, role, attrs)
        with self._lock:
            self._inflight[sp.span_id] = sp
        if activate:
            sp._prev_ctx = ctx
            _local.ctx = (sp.trace_id, sp.span_id)
        return sp

    def finish_span(self, span: Span, status: str = "ok") -> None:
        span.duration = time.time() - span.start
        span.status = status
        # a span marked noise=True only enters the ring when it joined a
        # caller's trace — periodic chatter (unsampled heartbeats) must
        # not churn real request traces out of the bounded buffer
        keep = not (span.attrs.get("noise") and span.parent_id is None)
        with self._lock:
            self._inflight.pop(span.span_id, None)
            if keep:
                self._append_locked(span)
            else:
                self.dropped_total += 1
        if getattr(_local, "ctx", None) == (span.trace_id, span.span_id):
            _local.ctx = span._prev_ctx

    # --- views ----------------------------------------------------------------
    def traces(self, limit: int = 20, min_ms: float = 0.0) -> list[dict]:
        """Recent finished traces, most recent first, grouped by trace id.
        min_ms filters on the trace's total wall span (slowest-path view)."""
        with self._lock:
            spans = list(self._ring)
        by_trace: dict[str, list[Span]] = {}
        for sp in spans:
            by_trace.setdefault(sp.trace_id, []).append(sp)
        out = []
        for trace_id, group in by_trace.items():
            group.sort(key=lambda s: s.start)
            start = group[0].start
            end = max(s.start + (s.duration or 0.0) for s in group)
            duration_ms = (end - start) * 1000.0
            if duration_ms < min_ms:
                continue
            ids = {s.span_id for s in group}
            roots = [s for s in group if s.parent_id not in ids]
            out.append({
                "trace_id": trace_id,
                "start": start,
                "duration_ms": round(duration_ms, 3),
                "root": roots[0].name if roots else group[0].name,
                "roles": sorted({s.role for s in group if s.role}),
                "spans": [s.to_dict() for s in group],
            })
        out.sort(key=lambda t: t["start"], reverse=True)
        return out[:limit]

    def inflight(self) -> list[dict]:
        with self._lock:
            spans = list(self._inflight.values())
        spans.sort(key=lambda s: s.start)
        return [s.to_dict() for s in spans]

    def trace_spans(self, trace_id: str) -> list[dict]:
        """Point lookup by trace id: finished spans via the index plus
        any still-in-flight spans of the same trace — so an exemplar
        link or `cluster.why` resolves a trace while its request is
        still running."""
        with self._lock:
            spans = list(self._by_trace.get(trace_id, ()))
            spans += [
                s for s in self._inflight.values()
                if s.trace_id == trace_id
            ]
        spans.sort(key=lambda s: s.start)
        return [s.to_dict() for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._inflight.clear()
            self._by_trace.clear()


_collector = TraceCollector()


def collector() -> TraceCollector:
    return _collector


def record_span(name: str, role: str | None = None,
                start: float | None = None, duration: float = 0.0,
                trace_id: str | None = None,
                attrs: dict | None = None) -> Span:
    """Insert an already-finished span into the ring — for work measured
    OUTSIDE Python. The fastlane engine's drained append/delete events
    carry an engine-side ns timestamp; storage/fastlane.py synthesizes
    them into spans here so `cluster.trace` finally shows natively-served
    writes (they never touch a Python handler, so no server span exists)."""
    sp = Span(trace_id or _new_id(), _new_id(), None, name, role, attrs)
    if start is not None:
        sp.start = start
    sp.duration = max(0.0, duration)
    sp.status = "ok"
    with _collector._lock:
        _collector._append_locked(sp)
    return sp


def annotate(**attrs) -> None:
    """Attach attrs to the thread's active span (e.g. a long-poll handler
    calls annotate(long_poll=True) so its deliberate multi-second waits
    are not logged as slow requests)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return
    with _collector._lock:
        sp = _collector._inflight.get(ctx[1])
    if sp is not None:
        sp.attrs.update(attrs)


# --- span helpers -------------------------------------------------------------
@contextmanager
def span(name: str, role: str | None = None, **attrs):
    """Generic traced section; nested client calls become children."""
    sp = _collector.start_span(name, role=role, attrs=attrs)
    try:
        yield sp
    except BaseException:
        _collector.finish_span(sp, status="error")
        raise
    _collector.finish_span(sp)


def begin_server_span(role: str, method: str, path: str, headers) -> Span:
    """Open the per-request server span, inheriting the caller's context
    from the propagation headers when present."""
    trace_id = headers.get(TRACE_HEADER) if headers is not None else None
    parent_id = headers.get(SPAN_HEADER) if headers is not None else None
    sp = _collector.start_span(
        f"{method} {path}",
        role=role,
        trace_id=trace_id or None,
        parent_id=parent_id or None,
    )
    sp._prev_ctx = None  # handler threads never carry context across requests
    return sp


def end_server_span(span: Span, status_code: int) -> None:
    span.attrs["status"] = status_code
    status = "ok" if status_code < 500 else "error"
    _collector.finish_span(span, status)
    # slow-request logging is a SERVER-span concern only: kernel spans
    # (a 30s EC destripe) and internal-op spans are slow by design and
    # already visible under the enclosing request span
    threshold = slow_threshold_s(span.role)
    if (
        threshold > 0
        and span.duration >= threshold
        and not span.attrs.get("long_poll")  # slow by design
    ):
        glog.warning(
            "slow request: %s %s took %.1fms (trace %s, status %s)",
            span.role, span.name, span.duration * 1000.0,
            span.trace_id, status,
        )


# --- kernel profiling ---------------------------------------------------------
_kernel_metrics_cache: dict[str, tuple] = {}
_kernel_metrics_lock = threading.Lock()


def _kernel_metrics(family: str) -> tuple:
    """(seconds histogram, bytes counter) for one kernel metric family."""
    pair = _kernel_metrics_cache.get(family)  # lock-free hot path (GIL-
    if pair is not None:  # atomic dict read); lock only for registration
        return pair
    with _kernel_metrics_lock:
        pair = _kernel_metrics_cache.get(family)
        if pair is None:
            reg = default_registry()
            hist = reg.histogram(
                family, "kernel execution seconds", ("kernel",),
                buckets=KERNEL_BUCKETS,
            )
            ctr = reg.counter(
                family[: -len("_seconds")] + "_bytes_total"
                if family.endswith("_seconds") else family + "_bytes_total",
                "bytes processed by the kernel", ("kernel",),
            )
            pair = (hist, ctr)
            _kernel_metrics_cache[family] = pair
        return pair


def observe_kernel(family: str, kernel: str, seconds: float, nbytes: int = 0) -> None:
    """Metrics-only record for hot per-blob paths where a trace span per
    call would flood the ring buffer."""
    hist, ctr = _kernel_metrics(family)
    hist.labels(kernel).observe(seconds)
    if nbytes:
        ctr.labels(kernel).inc(nbytes)


@contextmanager
def kernel_span(name: str, family: str, kernel: str, nbytes: int = 0,
                role: str = "volume", **attrs):
    """Trace span + Prometheus histogram/bytes-counter for one kernel
    execution. The yielded span's attrs may be updated before exit when
    facts are only known mid-flight: attrs["bytes"] sets the counted
    bytes, attrs["kernel"] re-labels the metric sample (e.g. a fused-path
    probe that fell through must not pollute the real kernel's series)."""
    attrs = {"kernel": kernel, "bytes": nbytes, **attrs}
    sp = _collector.start_span(name, role=role, attrs=attrs)
    t0 = time.perf_counter()
    try:
        yield sp
    except BaseException:
        _collector.finish_span(sp, status="error")
        raise
    dt = time.perf_counter() - t0
    _collector.finish_span(sp)
    observe_kernel(
        family, str(sp.attrs.get("kernel") or kernel), dt,
        int(sp.attrs.get("bytes") or 0),
    )


# --- trace-ring self-metrics --------------------------------------------------
TRACE_SELF_FAMILIES = (
    "SeaweedFS_stats_trace_spans_total",
    "SeaweedFS_stats_trace_dropped_total",
    "SeaweedFS_stats_trace_inflight",
)


def _self_metrics_lines() -> list[str]:
    """The ring's own health on /metrics: recorded spans, LOST spans
    (eviction under churn + unkept noise), and the in-flight count — so
    the observability layer can see its own losses instead of silently
    presenting a churned-out ring as "no traces"."""
    with _collector._lock:
        spans = _collector.spans_total
        dropped = _collector.dropped_total
        inflight = len(_collector._inflight)
    return [
        "# HELP SeaweedFS_stats_trace_spans_total spans recorded into the"
        " trace ring",
        "# TYPE SeaweedFS_stats_trace_spans_total counter",
        f"SeaweedFS_stats_trace_spans_total {spans:g}",
        "# HELP SeaweedFS_stats_trace_dropped_total spans lost to ring"
        " eviction or dropped as unsampled noise",
        "# TYPE SeaweedFS_stats_trace_dropped_total counter",
        f"SeaweedFS_stats_trace_dropped_total {dropped:g}",
        "# HELP SeaweedFS_stats_trace_inflight spans currently open",
        "# TYPE SeaweedFS_stats_trace_inflight gauge",
        f"SeaweedFS_stats_trace_inflight {inflight:g}",
    ]


default_registry().register_collector(
    _self_metrics_lines, names=TRACE_SELF_FAMILIES
)

# Exemplar wiring: request-latency histograms stamp the active trace id
# onto their samples through this hook. metrics.py cannot import this
# module (it is imported BY it), so the hookup runs here at import time.
from seaweedfs_tpu_torch.stats.metrics import set_exemplar_source  # noqa: E402


def _exemplar_ctx() -> tuple[str, str] | None:
    """The active trace context, UNLESS the span will be dropped as
    unkept noise (finish_span's rule: noise with no parent never enters
    the ring) — an exemplar must not link to a trace that cannot
    resolve (heartbeat/registration chatter would otherwise dangle)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return None
    with _collector._lock:
        sp = _collector._inflight.get(ctx[1])
    if sp is not None and sp.attrs.get("noise") and sp.parent_id is None:
        return None
    return ctx


set_exemplar_source(_exemplar_ctx)
