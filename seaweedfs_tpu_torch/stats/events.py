"""Cluster flight recorder: a causal journal of typed structured events.

The four signal legs (traces, metrics, profiles, history/alerts) and
the machinery that absorbs faults (degraded reads, typed fallbacks,
pipelined repair chains) are each observable — but their
interplay was only visible as disconnected counters. Nothing answered
"why was this read degraded" or "what healed volume 7 and how long did
users feel it". This module is the correlation layer: every interesting
state transition lands in a bounded per-process ring as a typed event
carrying correlation keys (trace id, volume id, node, task key,
monotonic + wall timestamps), served at `GET /debug/events` on every
role, and assembled cross-node into one causally-ordered timeline by the
`cluster.why` shell verb. The availability accounting arXiv:1709.05365
shows dominating online-EC systems needs exactly this joint view:
request → degraded read → fault → alert edge → repair task → heal.

Design constraints mirror util/faults.py:

  1. **Disabled is free.** Seams call `events.emit(...)` on hot paths
     (the degraded-read ladder, the scheduler); while no server has
     enabled metrics the recorder is off and emit() is one attribute
     check — no allocation, no lock (tier-1 timing-asserts this).
  2. **Types are declared, not discovered.** `EVENT_TYPES` is the closed
     set; `emit()` rejects anything else, so a typo'd seam cannot
     silently journal nothing, and tools/check_metric_names.py lints
     that every declared type is emitted by a real seam and exercised
     by the tests.
  3. **Bounded.** A fixed ring (SEAWEEDFS_TPU_EVENTS_CAPACITY, default
     4096) with eviction counted into
     `SeaweedFS_events_dropped_total` — the journal can lose history,
     never memory.
"""

from __future__ import annotations

import collections
import os
import threading
import time

# The closed set of event types (snake_case, linted by
# tools/check_metric_names.py; each must be emitted by a seam and
# exercised by tests/test_events.py or tests/test_chaos.py).
EVENT_TYPES = {
    "degraded_read": "a needle read served through reconstruction or an"
                     " alternate source instead of failing",
    "fallback_ec_online": "an online-EC volume degraded to classic"
                          " replicate-then-seal (typed reason)",
    "fallback_fastlane": "the filer front door fell back to the Python"
                         " path for a pathological reason",
    "fallback_repair": "a pipelined rebuild fell back to classic"
                       " whole-shard pulls (typed reason)",
    "fault_injected": "a util/faults.py fault point fired",
    "task_queued": "a maintenance repair task was admitted to the"
                   " scheduler queue",
    "task_dispatched": "a queued repair task started executing",
    "task_done": "a repair task finished (state=completed|planned)",
    "task_failed": "a repair task raised; backoff armed",
    "task_backoff": "a failed task's retry delay was armed",
    "chain_restart": "a pipelined-rebuild chain restarted minus a hop",
    "remount_swap": "an EC volume's shard set was atomically remounted",
    "lease_churn": "the filer engine's fid lease pool changed"
                   " (leased|kept|rejected)",
    "alert_raised": "an alert rule transitioned to firing",
    "alert_cleared": "a firing alert rule stopped firing",
    "scrub_finding": "an integrity scrub pass proved silent damage"
                     " (corrupt needle/shard, parity mismatch, replica"
                     " divergence, tmp litter)",
    "heartbeat_stale": "a node's heartbeat crossed the 3x-pulse"
                       " staleness threshold",
    "heartbeat_rejoin": "a stale node's heartbeat recovered",
    "volume_state": "a volume lifecycle transition"
                    " (created|mounted|unmounted|deleted|readonly...)",
    "tenant_overflow": "the usage sketch evicted a tenant into the"
                       " _other bucket (top-K cardinality bound hit)",
    "heat_promoted": "a volume's heat score crossed the promote"
                     " threshold (hot set entry)",
    "heat_demoted": "a hot volume's heat score fell under the demote"
                    " threshold (hot set exit)",
    "qos_shed": "admission control shed a request with a typed 429/503"
                " (closed reason set; collection-correlated)",
}

EVENT_FAMILIES = (
    "SeaweedFS_events_recorded_total",
    "SeaweedFS_events_dropped_total",
)

DEFAULT_CAPACITY = int(os.environ.get("SEAWEEDFS_TPU_EVENTS_CAPACITY",
                                      "4096"))


class Event:
    __slots__ = ("type", "seq", "wall", "mono", "trace_id", "volume",
                 "node", "task", "attrs")

    def __init__(self, type_: str, seq: int, trace_id: str | None,
                 volume: int | None, node: str | None, task: str | None,
                 attrs: dict) -> None:
        self.type = type_
        self.seq = seq
        self.wall = time.time()
        self.mono = time.monotonic()
        self.trace_id = trace_id
        self.volume = volume
        self.node = node
        self.task = task
        self.attrs = attrs

    def to_dict(self) -> dict:
        out = {
            "type": self.type,
            "seq": self.seq,
            "ts": round(self.wall, 6),
            "mono": round(self.mono, 6),
        }
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.volume is not None:
            out["volume"] = self.volume
        if self.node is not None:
            out["node"] = self.node
        if self.task is not None:
            out["task"] = self.task
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        """Rebuild a journaled event (stats/store.py replay) with its
        original timestamps/seq — bypasses __init__'s time.time()."""
        ev = cls.__new__(cls)
        ev.type = d.get("type", "")
        ev.seq = int(d.get("seq", 0))
        ev.wall = float(d.get("ts", 0.0))
        ev.mono = float(d.get("mono", 0.0))
        ev.trace_id = d.get("trace_id")
        ev.volume = d.get("volume")
        ev.node = d.get("node")
        ev.task = d.get("task")
        ev.attrs = dict(d.get("attrs") or {})
        return ev


class EventRecorder:
    """Bounded per-process event ring. `enabled` is the one-attribute
    hot-path gate (a bare library import records nothing); the first
    metered server flips it via enable() — the same lifecycle as the
    metrics-history scrape loop."""

    def __init__(self, capacity: int | None = None) -> None:
        self.enabled = False
        # clamp: capacity <= 0 would make record()'s popleft raise on an
        # empty ring, turning every emit seam into a crash
        self.capacity = max(
            1, DEFAULT_CAPACITY if capacity is None else capacity)
        self._ring: collections.deque[Event] = collections.deque()
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded_total = 0
        self.dropped_total = 0
        self.recorded_by_type: dict[str, int] = {}
        # unrounded wall clock of the newest event: the /debug/events
        # incremental-cursor watermark (to_dict rounds ts for display, so
        # a rounded watermark could re-ship its own event next poll)
        self.last_wall = 0.0

    def enable(self) -> None:
        self.enabled = True

    def record(self, type_: str, volume=None, node=None, task=None,
               trace_id: str | None = None, **attrs) -> Event:
        """Journal one event. The type must be declared in EVENT_TYPES
        (closed registry — a typo'd seam must fail loudly, not journal
        nothing). trace_id defaults to the thread's active trace, so an
        event emitted inside a request handler auto-correlates with the
        request's span tree."""
        if type_ not in EVENT_TYPES:
            raise ValueError(
                f"undeclared event type {type_!r}"
                f" (add it to events.EVENT_TYPES)")
        if trace_id is None:
            from seaweedfs_tpu_torch.stats import trace as trace_mod

            ctx = trace_mod.current()
            if ctx is not None:
                trace_id = ctx[0]
        if volume is not None:
            volume = int(volume)
        with self._lock:
            self._seq += 1
            ev = Event(type_, self._seq, trace_id, volume,
                       node or None, task or None, attrs)
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped_total += 1
            self._ring.append(ev)
            self.recorded_total += 1
            self.last_wall = ev.wall
            self.recorded_by_type[type_] = \
                self.recorded_by_type.get(type_, 0) + 1
        return ev

    def events(self, type: str | None = None, volume: int | None = None,
               trace: str | None = None, since: float | None = None,
               collection: str | None = None,
               limit: int = 256) -> list[dict]:
        """Filtered view, causally ordered (oldest first). `since` is a
        strictly-after wall-clock cursor (pass the previous response's
        `last_wall` watermark back to stop re-shipping the ring — the
        same incremental-poll contract as MetricsHistory.snapshot);
        `limit` keeps the NEWEST matches (the tail is where the story
        usually is). `collection` matches the per-tenant correlation key
        events carry in attrs."""
        with self._lock:
            evs = list(self._ring)
        out = []
        for ev in evs:
            if type is not None and ev.type != type:
                continue
            if volume is not None and ev.volume != volume:
                continue
            if trace is not None and ev.trace_id != trace:
                continue
            if since is not None and ev.wall <= since:
                continue
            if collection is not None and \
                    ev.attrs.get("collection") != collection:
                continue
            out.append(ev)
        if limit > 0:
            out = out[-limit:]
        return [ev.to_dict() for ev in out]

    # --- durable-store seam (stats/store.py) ----------------------------------
    def tail(self, after_seq: int, limit: int = 4096) -> list[Event]:
        """Raw events with seq strictly past `after_seq`, oldest first —
        the telemetry store's flusher pulls the ring through this seq
        watermark (emit() never sees the store; the ring is the buffer,
        and a seq gap past the watermark is a counted loss)."""
        with self._lock:
            out = [ev for ev in self._ring if ev.seq > after_seq]
        return out[:limit] if limit > 0 else out

    def preload(self, dicts) -> int:
        """Inject replayed journal events (restart replay): original
        seqs/timestamps preserved, `_seq` advanced past them so live
        events never collide, oldest replayed events trimmed silently if
        the batch exceeds the ring (they are still on disk). Counters
        stay zero — they account THIS process's recording."""
        evs = [Event.from_dict(d) for d in dicts]
        with self._lock:
            merged = sorted(list(self._ring) + evs,
                            key=lambda e: (e.wall, e.seq))
            self._ring = collections.deque(merged[-self.capacity:])
            for ev in evs:
                self._seq = max(self._seq, ev.seq)
                self.last_wall = max(self.last_wall, ev.wall)
        return len(evs)

    def clear(self) -> None:
        """Drop the journal (tests: isolate scenarios). Counters
        survive, like the trace ring's."""
        with self._lock:
            self._ring.clear()

    # --- self-observability ---------------------------------------------------
    def _self_lines(self) -> list[str]:
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels

        with self._lock:
            by_type = dict(self.recorded_by_type)
            dropped = self.dropped_total
        lines = [
            "# HELP SeaweedFS_events_recorded_total events journaled into"
            " the flight-recorder ring, by type",
            "# TYPE SeaweedFS_events_recorded_total counter",
        ]
        for t, n in sorted(by_type.items()):
            lines.append("SeaweedFS_events_recorded_total"
                         + _fmt_labels(("type",), (t,)) + f" {n}")
        lines.extend([
            "# HELP SeaweedFS_events_dropped_total events lost to ring"
            " eviction (the journal is bounded)",
            "# TYPE SeaweedFS_events_dropped_total counter",
            f"SeaweedFS_events_dropped_total {dropped}",
        ])
        return lines


_recorder = EventRecorder()
_collector = None
_collector_lock = threading.Lock()


def recorder() -> EventRecorder:
    return _recorder


def emit(type_: str, **kw) -> Event | None:
    """The seam API: journal an event, or no-op while the recorder is
    off. The disabled path is ONE attribute check — seams sit on the
    degraded-read ladder and the scheduler's dispatch loop, and a
    process that never serves must pay nothing (tier-1 timing-asserts
    this, like the faults registry's disarmed guard)."""
    rec = _recorder
    if not rec.enabled:
        return None
    return rec.record(type_, **kw)


def enable() -> None:
    """Arm the process recorder + register its self-metrics collector
    (idempotent; called by HTTPService.enable_metrics alongside the
    history ring's start)."""
    global _collector
    with _collector_lock:
        if _collector is None:
            from seaweedfs_tpu_torch.stats.metrics import default_registry

            _collector = default_registry().register_collector(
                _recorder._self_lines, names=EVENT_FAMILIES
            )
    _recorder.enable()
