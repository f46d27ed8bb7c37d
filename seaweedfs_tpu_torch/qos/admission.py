"""QoS admission control: per-tenant token buckets + priority classes.

The stats layer gives per-tenant *observation* — Space-Saving usage sketches
per process, merged cluster-wide on the leader master — but nothing
ACTED on it: one abusive tenant could still collapse every gateway's
p99. This module is the first control plane over that telemetry stack.
Every filer / S3 gateway request passes an admission check keyed on the
SAME collection/bucket dimension stats/usage.py accounts, *before* any
bytes move:

  1. **Token buckets per collection** — limits set statically
     (`-qos.limits 'tenant-a=100,tenant-b=50:200,*=25'`, rps[:burst],
     `*` = default for unlisted tenants) or at runtime
     (`POST /qos/limits`, `cluster.qos` shell verb).
  2. **Priority classes** — interactive reads > writes > background
     scans/repair, inferred from the op and overridable via the
     `X-Sw-Priority` header. The burn-driven actuator (qos/actuator.py)
     sheds lower classes first; the highest class only sheds when a
     tenant personally exhausts its bucket.
  3. **Bounded per-class admission queue** — a dry bucket does not
     instantly 429: if the refill wait is short the request *reserves*
     tokens (virtual-scheduling leaky bucket: the debit happens up
     front, so the post-sleep admit cannot race) and sleeps it off,
     smoothing bursts. The queue is bounded per class so a flood can't
     pile up threads.
  4. **Typed shedding, never untyped failure** — a shed request gets a
     429 (tenant-caused: `over_limit`, `queue_full`) or 503
     (capacity-caused: `burn_shed`) with `Retry-After` and a
     machine-readable reason from the closed SHED_REASONS set, counted
     in `SeaweedFS_qos_{admitted,shed,queued}_total` and journaled as a
     `qos_shed` flight-recorder event with trace/collection correlation.

Design constraints mirror util/faults.py and stats/events.py: the
disarmed / no-limits path is ONE attribute check (`_controller.armed`),
label cardinality is bounded (unlisted tenants fold into the usage
module's `_other`), and the reason/class vocabularies are closed sets
linted by tools/check_metric_names.py.
"""

from __future__ import annotations

import math
import threading
import time

# Priority classes, highest first (linted: unique snake_case). The
# actuator sheds from the right; `cluster.check -fail` trips when the
# LEFTMOST class is shed sustainedly (that is an incident, not policy).
PRIORITY_CLASSES = ("interactive", "write", "background")

# Closed shed-reason vocabulary (linted). 429s are tenant-caused (the
# client should back off); 503 means the cluster itself is over
# capacity (an SLO budget is burning and the actuator gated the class).
SHED_REASONS = ("over_limit", "queue_full", "burn_shed")
_REASON_STATUS = {"over_limit": 429, "queue_full": 429, "burn_shed": 503}

QOS_FAMILIES = (
    "SeaweedFS_qos_admitted_total",
    "SeaweedFS_qos_shed_total",
    "SeaweedFS_qos_queued_total",
    "SeaweedFS_qos_limit_rps",
    "SeaweedFS_qos_gate",
)

DEFAULT_QUEUE_DEPTH = 32    # concurrent waiters per class
DEFAULT_QUEUE_WAIT = 0.25   # s: longest refill wait worth queueing for
DEFAULT_BURST_FACTOR = 2.0  # burst = rate * this, when not explicit


def classify(method: str, headers=None, background_hint: bool = False) -> str:
    """Infer the priority class from the op shape; an `X-Sw-Priority`
    header naming a declared class wins (repair/scrub clients tag
    themselves background; a batch reader may self-demote)."""
    pr = headers.get("X-Sw-Priority") if headers else None
    if pr:
        pr = pr.strip().lower()
        if pr in PRIORITY_CLASSES:
            return pr
    if background_hint:
        return "background"  # scans (e.g. S3 ListObjects)
    if method in ("GET", "HEAD"):
        return "interactive"
    return "write"


def parse_limits_spec(spec: str) -> tuple[dict, tuple | None]:
    """`-qos.limits 'a=100,b=50:200,*=25'` -> ({coll: (rate, burst)},
    default_or_None). rate in requests/s; optional `:burst` caps the
    bucket (default rate * DEFAULT_BURST_FACTOR)."""
    limits: dict[str, tuple] = {}
    default = None
    for piece in (spec or "").split(","):
        piece = piece.strip()
        if not piece:
            continue
        name, _, val = piece.partition("=")
        name = name.strip()
        if not name or not val:
            raise ValueError(f"bad -qos.limits piece {piece!r}"
                             " (want tenant=rps[:burst])")
        rate_s, _, burst_s = val.partition(":")
        rate = float(rate_s)
        burst = float(burst_s) if burst_s else max(1.0,
                                                   rate * DEFAULT_BURST_FACTOR)
        if rate < 0 or burst <= 0:
            raise ValueError(f"bad -qos.limits piece {piece!r}"
                             " (rate must be >= 0, burst > 0)")
        if name == "*":
            default = (rate, burst)
        else:
            limits[name] = (rate, burst)
    return limits, default


class TokenBucket:
    """Classic token bucket with an injectable clock (tests drive time
    by hand). `take` only debits when tokens cover the cost; `reserve`
    debits unconditionally and returns how long until the balance is
    whole again — the admission queue's virtual-scheduling primitive
    (reserve-then-sleep cannot lose a race to a later arrival)."""

    __slots__ = ("rate", "burst", "tokens", "_stamp")

    def __init__(self, rate: float, burst: float | None = None,
                 now: float = 0.0) -> None:
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(1.0, rate * DEFAULT_BURST_FACTOR))
        self.tokens = self.burst  # start full: a cold tenant may burst
        self._stamp = now

    def _refill(self, now: float) -> None:
        dt = now - self._stamp
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self._stamp = now

    def wait_for(self, n: float) -> float:
        """Seconds (at the current level) until n tokens are available."""
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (n - self.tokens) / self.rate

    def take(self, n: float, now: float) -> float:
        """0.0 = admitted (debited); > 0 = NOT debited, retry that many
        seconds later."""
        self._refill(now)
        w = self.wait_for(n)
        if w <= 0.0:
            self.tokens -= n
        return w

    def reserve(self, n: float, now: float) -> float:
        """Debit unconditionally; return seconds until the balance is
        non-negative (0 = admitted now). Callers bound outstanding
        reservations (the per-class queue) so the deficit is bounded."""
        self._refill(now)
        w = self.wait_for(n)
        self.tokens -= n
        return w


class Decision:
    """A typed shed verdict (admitted requests get None, not a
    Decision — the hot path allocates nothing)."""

    __slots__ = ("status", "reason", "retry_after", "cls", "collection")

    def __init__(self, status: int, reason: str, retry_after: float,
                 cls: str, collection: str) -> None:
        self.status = status
        self.reason = reason
        self.retry_after = retry_after
        self.cls = cls
        self.collection = collection

    def headers(self) -> dict:
        return {
            "Retry-After": str(max(1, int(math.ceil(self.retry_after)))),
            "X-Sw-Qos-Reason": self.reason,
            "X-Sw-Qos-Class": self.cls,
        }

    def to_dict(self) -> dict:
        return {
            "error": "request shed by qos admission control",
            "reason": self.reason,
            "class": self.cls,
            "collection": self.collection,
            "retry_after": round(self.retry_after, 3),
        }


class AdmissionController:
    """Per-process admission state. `armed` is the one-attribute
    hot-path gate: False until the process is both enabled AND has
    something to enforce (a limit, a default, or a tightened gate) —
    a metered server with no QoS config pays one attribute read per
    request, nothing else."""

    def __init__(self, now=time.monotonic, sleep=time.sleep) -> None:
        self.enabled = False
        self.armed = False
        self._now = now
        self._sleep = sleep
        self._lock = threading.Lock()
        self._limits: dict[str, tuple] = {}    # coll -> (rate, burst)
        self._default: tuple | None = None     # for unlisted collections
        self._buckets: dict[str, TokenBucket] = {}
        self.queue_depth = DEFAULT_QUEUE_DEPTH
        self.queue_wait = DEFAULT_QUEUE_WAIT
        # class gates, set by the actuator: 1.0 = open, (0,1) = bucket
        # drains that much faster for the class, 0.0 = class fully shed
        self._gates: dict[str, float] = {}
        self.burn_retry_after = 2.0  # Retry-After hint for burn_shed
        # bounded-cardinality counters: collections with explicit limits
        # keep their name, the rest fold into usage's _other
        self.admitted_total: dict[tuple, int] = {}
        self.shed_total: dict[tuple, int] = {}
        self.queued_total: dict[tuple, int] = {}
        self._event_last: dict[tuple, float] = {}  # 1/s emit throttle

    # --- configuration --------------------------------------------------------
    def _rearm(self) -> None:
        self.armed = bool(self.enabled and (
            self._limits or self._default is not None
            or any(g < 1.0 for g in self._gates.values())))

    def enable(self) -> None:
        with self._lock:
            self.enabled = True
            self._rearm()

    def set_limits(self, limits: dict | None = None, default=None,
                   queue_depth: int | None = None,
                   queue_wait: float | None = None) -> None:
        """Declarative replace of the limit table (runtime POST and the
        CLI flag both land here). Buckets whose (rate, burst) did not
        change keep their token level — a no-op update must not re-grant
        a spent tenant a full burst."""
        with self._lock:
            if limits is not None:
                new = {}
                for coll, v in limits.items():
                    rate, burst = (v if isinstance(v, (tuple, list))
                                   else (float(v), None))
                    burst = float(burst) if burst is not None else max(
                        1.0, float(rate) * DEFAULT_BURST_FACTOR)
                    new[coll] = (float(rate), burst)
                old_buckets = self._buckets
                self._buckets = {
                    c: old_buckets[c]
                    for c, rb in new.items()
                    if c in old_buckets and self._limits.get(c) == rb
                }
                self._limits = new
            if default is not None:
                d = (default if isinstance(default, (tuple, list))
                     else (float(default),
                           max(1.0, float(default) * DEFAULT_BURST_FACTOR)))
                self._default = (float(d[0]), float(d[1]))
                # default changed: unlisted-tenant buckets re-key lazily
                for c in list(self._buckets):
                    if c not in self._limits:
                        del self._buckets[c]
            if queue_depth is not None:
                self.queue_depth = max(0, int(queue_depth))
            if queue_wait is not None:
                self.queue_wait = max(0.0, float(queue_wait))
            self._rearm()

    def set_gates(self, gates: dict) -> None:
        """Actuator seam: {class: factor in [0,1]}; missing classes are
        open. Unknown class names are rejected (closed vocabulary)."""
        for cls in gates:
            if cls not in PRIORITY_CLASSES:
                raise ValueError(f"unknown priority class {cls!r}")
        with self._lock:
            self._gates = {c: max(0.0, min(1.0, float(f)))
                           for c, f in gates.items()}
            self._rearm()

    def gates(self) -> dict:
        with self._lock:
            return dict(self._gates)

    # --- admission ------------------------------------------------------------
    def _bucket_for(self, collection: str) -> TokenBucket | None:
        rb = self._limits.get(collection) or self._default
        if rb is None:
            return None
        b = self._buckets.get(collection)
        if b is None:
            b = TokenBucket(rb[0], rb[1], now=self._now())
            self._buckets[collection] = b
        return b

    def _label(self, collection: str) -> str:
        if collection in self._limits:
            return collection
        from seaweedfs_tpu_torch.stats.usage import OTHER

        return OTHER

    def _count(self, table: dict, key: tuple) -> None:
        table[key] = table.get(key, 0) + 1

    def _shed(self, collection: str, cls: str, reason: str,
              retry_after: float) -> Decision:
        # caller holds the lock
        retry_after = min(max(retry_after, 0.1), 3600.0)
        self._count(self.shed_total, (cls, reason, self._label(collection)))
        d = Decision(_REASON_STATUS[reason], reason, retry_after, cls,
                     collection)
        # journal with a 1/s per-(collection, reason) throttle: a flood
        # of identical sheds must not evict the rest of the ring
        now = self._now()
        k = (collection, reason)
        if now - self._event_last.get(k, -1e9) >= 1.0:
            self._event_last[k] = now
            from seaweedfs_tpu_torch.stats import events as events_mod

            events_mod.emit(
                "qos_shed", collection=collection, cls=cls, reason=reason,
                status=d.status, retry_after=round(retry_after, 3),
            )
        return d

    def admit(self, collection: str, cls: str,
              cost: float = 1.0) -> Decision | None:
        """None = admitted; a Decision = typed shed. May block up to
        queue_wait seconds (the bounded admission queue)."""
        wait = 0.0
        with self._lock:
            gate = self._gates.get(cls, 1.0)
            if gate <= 0.0:
                return self._shed(collection, cls, "burn_shed",
                                  self.burn_retry_after)
            b = self._bucket_for(collection)
            if b is None:
                self._count(self.admitted_total,
                            (cls, self._label(collection)))
                return None
            # a tightened gate drains the bucket faster for this class
            eff = cost / gate
            wait = b.take(eff, self._now())
            if wait <= 0.0:
                self._count(self.admitted_total,
                            (cls, self._label(collection)))
                return None
            if wait > self.queue_wait:
                return self._shed(collection, cls, "over_limit", wait)
            waiting = self.queued_total.get(("_waiting", cls), 0)
            if waiting >= self.queue_depth:
                return self._shed(collection, cls, "queue_full",
                                  self.queue_wait)
            # reserve: debit now, sleep off the deficit outside the lock
            wait = b.reserve(eff, self._now())
            self.queued_total[("_waiting", cls)] = waiting + 1
            self._count(self.queued_total, (cls, self._label(collection)))
            self._count(self.admitted_total, (cls, self._label(collection)))
        try:
            if wait > 0:
                self._sleep(wait)
        finally:
            with self._lock:
                self.queued_total[("_waiting", cls)] -= 1
        return None

    # --- native-path seam (storage/fastlane.py) -------------------------------
    def charge(self, collection: str, n: float) -> None:
        """Debit a tenant's bucket for requests the NATIVE front door
        already served (folded from the engine's usage ABI deltas).
        Never sheds — the engine moved the bytes; the debit makes the
        tenant's next Python-path (or post-revoke) requests pay for
        them, so a limit holds across both paths."""
        if not self.armed or n <= 0:
            return
        with self._lock:
            b = self._bucket_for(collection)
            if b is not None:
                b.reserve(float(n), self._now())

    def over_limit(self, collection: str) -> bool:
        """True while the tenant's bucket is in deficit — the S3
        gateway's revalidation loop revokes a shedding bucket's native
        flags on this signal (so its traffic lands on the Python
        dispatcher where typed 429s are served) and restores them once
        the bucket recovers."""
        if not self.armed:
            return False
        with self._lock:
            if any(g <= 0.0 for g in self._gates.values()):
                return True  # a class is fully gated: serve typed 503s
            rb = self._limits.get(collection) or self._default
            if rb is None:
                return False
            b = self._bucket_for(collection)
            b._refill(self._now())
            return b.tokens < 1.0

    # --- observability --------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            shed: dict = {}
            for (cls, reason, coll), n in self.shed_total.items():
                shed.setdefault(cls, {})[f"{reason}:{coll}"] = n
            return {
                "enabled": self.enabled,
                "armed": self.armed,
                "limits": {c: list(rb) for c, rb in self._limits.items()},
                "default": list(self._default) if self._default else None,
                "queue_depth": self.queue_depth,
                "queue_wait": self.queue_wait,
                "gates": dict(self._gates),
                "admitted": {
                    f"{cls}:{coll}": n
                    for (cls, coll), n in self.admitted_total.items()},
                "queued": {
                    f"{cls}:{coll}": n
                    for (cls, coll), n in self.queued_total.items()
                    if cls != "_waiting"},
                "shed": shed,
                "buckets": {
                    c: round(b.tokens, 3)
                    for c, b in self._buckets.items()},
            }

    def _self_lines(self) -> list[str]:
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, _fmt_value

        with self._lock:
            admitted = dict(self.admitted_total)
            shed = dict(self.shed_total)
            queued = {k: v for k, v in self.queued_total.items()
                      if k[0] != "_waiting"}
            limits = dict(self._limits)
            gates = dict(self._gates)
        lines = [
            "# HELP SeaweedFS_qos_admitted_total requests admitted by QoS"
            " admission control, by class and collection",
            "# TYPE SeaweedFS_qos_admitted_total counter",
        ]
        for (cls, coll), n in sorted(admitted.items()):
            lines.append("SeaweedFS_qos_admitted_total"
                         + _fmt_labels(("class", "collection"), (cls, coll))
                         + f" {n}")
        lines.extend([
            "# HELP SeaweedFS_qos_shed_total requests shed with a typed"
            " 429/503, by class, closed reason and collection",
            "# TYPE SeaweedFS_qos_shed_total counter",
        ])
        for (cls, reason, coll), n in sorted(shed.items()):
            lines.append("SeaweedFS_qos_shed_total"
                         + _fmt_labels(("class", "reason", "collection"),
                                       (cls, reason, coll))
                         + f" {n}")
        lines.extend([
            "# HELP SeaweedFS_qos_queued_total requests smoothed through"
            " the bounded admission queue instead of shedding",
            "# TYPE SeaweedFS_qos_queued_total counter",
        ])
        for (cls, coll), n in sorted(queued.items()):
            lines.append("SeaweedFS_qos_queued_total"
                         + _fmt_labels(("class", "collection"), (cls, coll))
                         + f" {n}")
        lines.extend([
            "# HELP SeaweedFS_qos_limit_rps configured admission rate per"
            " collection (requests/s)",
            "# TYPE SeaweedFS_qos_limit_rps gauge",
        ])
        for coll, (rate, _burst) in sorted(limits.items()):
            lines.append("SeaweedFS_qos_limit_rps"
                         + _fmt_labels(("collection",), (coll,))
                         + f" {_fmt_value(rate)}")
        lines.extend([
            "# HELP SeaweedFS_qos_gate actuator class gate (1 = open,"
            " 0 = class fully shed)",
            "# TYPE SeaweedFS_qos_gate gauge",
        ])
        for cls in PRIORITY_CLASSES:
            lines.append("SeaweedFS_qos_gate"
                         + _fmt_labels(("class",), (cls,))
                         + f" {_fmt_value(gates.get(cls, 1.0))}")
        return lines


_controller = AdmissionController()
_collector = None
_collector_lock = threading.Lock()


def controller() -> AdmissionController:
    return _controller


def admit(collection: str, cls: str) -> Decision | None:
    """The seam API: gateways call this before moving any bytes. The
    disarmed / no-limits path is ONE attribute check — a process with
    QoS off (or on but unconfigured) pays nothing (tier-1
    timing-asserts this, like faults/events)."""
    ctl = _controller
    if not ctl.armed:
        return None
    return ctl.admit(collection, cls)


def reset() -> None:
    """Return the process controller to a new one's state (its clock and
    collector kept): disabled, and no limits, gates, buckets or counts."""
    ctl = _controller
    with ctl._lock:
        ctl.enabled = False
        ctl._limits, ctl._default, ctl._buckets, ctl._gates = {}, None, {}, {}
        ctl.queue_depth, ctl.queue_wait = DEFAULT_QUEUE_DEPTH, DEFAULT_QUEUE_WAIT
        ctl.burn_retry_after = 2.0
        ctl.admitted_total, ctl.shed_total, ctl.queued_total = {}, {}, {}
        ctl._event_last = {}
        ctl._rearm()


def enable() -> None:
    """Arm the process controller + register its self-metrics collector
    (idempotent — the same lifecycle as events.enable())."""
    global _collector
    with _collector_lock:
        if _collector is None:
            from seaweedfs_tpu_torch.stats.metrics import default_registry

            _collector = default_registry().register_collector(
                _controller._self_lines, names=QOS_FAMILIES)
    _controller.enable()
