"""Bounded-cardinality per-collection (tenant) usage accounting.

Per-tenant metrics cannot ride ordinary Prometheus labels: a hostile or
merely enthusiastic client minting collections at will would mint series
with them, and the self-scrape history ring (stats/history.py) would carry
the explosion into every debug surface. So the accountant tracks heavy
hitters with a Space-Saving top-K sketch (Metwally et al., bounded memory,
per-key error bound) and folds everything evicted into a single `_other`
bucket. The sketch's error bound is itself exported so consumers
(cluster.heat, QoS admission) can judge how much to
trust a reported count.

Feeds:
- the filer write/read/delete handlers and the S3 dispatch path call
  `record()` inline (one dict lookup + a few adds under a lock — the
  arXiv:1207.6744 "background work must not tax foreground" rule is why
  the sketch is O(1) per offer, no sorting on the hot path);
- fastlane native ops bypass Python entirely, so the collector folds in
  counter DELTAS from the engine's per-collection usage ABI
  (`sw_fl_get_usage`, hasattr-gated; stale .so → Python-path only).

Evicting a tenant from the sketch emits a `tenant_overflow` journal event
(deduplicated per tenant per process) so `cluster.why <collection>` can
explain why a tenant's counts are approximate.
"""

from __future__ import annotations

import os
import threading

USAGE_FAMILIES = (
    "SeaweedFS_usage_requests_total",
    "SeaweedFS_usage_bytes_in_total",
    "SeaweedFS_usage_bytes_out_total",
    "SeaweedFS_usage_errors_total",
    "SeaweedFS_usage_tracked_collections",
    "SeaweedFS_usage_error_bound",
    "SeaweedFS_usage_overflow_total",
)

# sketch capacity: top-K tenants tracked exactly-ish; the rest fold into
# _other. 64 keeps the exposition small while covering any sane tenant
# count; raise it via env for dense multi-tenant deployments.
DEFAULT_K = 64

OTHER = "_other"  # reserved pseudo-collection for evicted mass

_DIMS = ("requests", "bytes_in", "bytes_out", "errors")


class SpaceSaving:
    """Space-Saving heavy-hitters sketch over a float-weighted stream.

    Invariants (the property test in tests/test_usage_heat.py drives
    adversarial orders against these):
      * at most `k` keys tracked, ever — memory is O(k);
      * for every tracked key:  count - err <= true <= count
        (counts overestimate; `err` is the min-count inherited at
        adoption time, 0 for keys that never displaced anyone);
      * `error_bound` >= err of every tracked key.

    `other` accumulates the counts of evicted keys — the mass the top-K
    view no longer attributes by name. NOT thread-safe; the owning
    accountant serializes access.
    """

    __slots__ = ("k", "counts", "errs", "other", "evictions", "error_bound")

    def __init__(self, k: int = DEFAULT_K):
        if k < 1:
            raise ValueError("sketch k must be >= 1")
        self.k = int(k)
        self.counts: dict[str, float] = {}
        self.errs: dict[str, float] = {}
        self.other = 0.0
        self.evictions = 0
        self.error_bound = 0.0

    def offer(self, key: str, inc: float = 1.0) -> str | None:
        """Add `inc` weight to `key`. Returns the evicted key when the
        sketch was full and a minimum-count entry was displaced, else
        None."""
        if inc <= 0:
            return None
        counts = self.counts
        if key in counts:
            counts[key] += inc
            return None
        if len(counts) < self.k:
            counts[key] = inc
            self.errs[key] = 0.0
            return None
        victim = min(counts, key=counts.get)
        vcount = counts[victim]
        del counts[victim]
        self.other += vcount
        del self.errs[victim]
        # classic Space-Saving adoption: the newcomer inherits the
        # victim's count (it may have occurred up to vcount times while
        # untracked), and that inheritance IS its error bound
        counts[key] = vcount + inc
        self.errs[key] = vcount
        if vcount > self.error_bound:
            self.error_bound = vcount
        self.evictions += 1
        return victim

    def top(self, n: int | None = None) -> list[tuple[str, float, float]]:
        """[(key, count, err)] sorted by count descending."""
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            items = items[:n]
        return [(k, c, self.errs[k]) for k, c in items]

    # --- wire format / merge -------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready serialization for a telemetry frame (stats/aggregate).
        Zero errs are elided — most tracked keys never displaced anyone."""
        return {
            "k": self.k,
            "counts": dict(self.counts),
            "errs": {k: e for k, e in self.errs.items() if e},
            "other": self.other,
            "evictions": self.evictions,
            "error_bound": self.error_bound,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SpaceSaving":
        sk = cls(max(1, int(d.get("k") or DEFAULT_K)))
        counts = d.get("counts") or {}
        errs = d.get("errs") or {}
        # defensive truncation: a malformed frame must not grow the sketch
        # past its own declared capacity (deterministic order for tests)
        items = sorted(counts.items(),
                       key=lambda kv: (-float(kv[1]), kv[0]))[:sk.k]
        for key, c in items:
            sk.counts[str(key)] = float(c)
            sk.errs[str(key)] = float(errs.get(key, 0.0))
        sk.other = float(d.get("other") or 0.0)
        sk.evictions = int(d.get("evictions") or 0)
        sk.error_bound = float(d.get("error_bound") or 0.0)
        return sk

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Merge two sketches into a NEW sketch (inputs untouched), keeping
        the per-key invariant count - err <= true <= count under composed
        error bounds (the mergeable-summaries construction):

          * a key tracked by only one input may have occurred up to that
            input's min-count uX times while untracked there, so the
            absent side contributes (count=uX, err=uX) — 0 <= true <= uX
            keeps both sides of the invariant;
          * tracked-by-both keys sum counts and errs;
          * the union is truncated back to k = max(ka, kb) by count
            (deterministic tie-break on key, so merge is exactly
            commutative); truncated mass folds into `other`;
          * the exported scalar bound composes: it covers every kept
            key's err AND every truncated count (an untracked key's true
            count never exceeds what was dropped for it).
        """
        ua = min(self.counts.values()) if len(self.counts) >= self.k else 0.0
        ub = (min(other.counts.values())
              if len(other.counts) >= other.k else 0.0)
        union: dict[str, tuple[float, float]] = {}
        for key in self.counts.keys() | other.counts.keys():
            if key in self.counts:
                ca, ea = self.counts[key], self.errs[key]
            else:
                ca = ea = ua
            if key in other.counts:
                cb, eb = other.counts[key], other.errs[key]
            else:
                cb = eb = ub
            union[key] = (ca + cb, ea + eb)
        out = SpaceSaving(max(self.k, other.k))
        ranked = sorted(union.items(), key=lambda kv: (-kv[1][0], kv[0]))
        kept, dropped = ranked[:out.k], ranked[out.k:]
        for key, (c, e) in kept:
            out.counts[key] = c
            out.errs[key] = e
        out.other = self.other + other.other + sum(c for _, (c, _e) in dropped)
        out.evictions = self.evictions + other.evictions + len(dropped)
        out.error_bound = max(
            self.error_bound + other.error_bound,
            max((c for _, (c, _e) in dropped), default=0.0),
        )
        return out


class UsageAccountant:
    """Thread-safe multi-dimension tenant accountant: one Space-Saving
    sketch per dimension (requests, bytes in/out, errors), all bounded by
    the same K. Handler paths call record(); the metrics collector calls
    lines() at scrape time and folds in native-engine deltas first."""

    def __init__(self, k: int | None = None):
        if k is None:
            k = int(os.environ.get("SEAWEEDFS_TPU_USAGE_K", DEFAULT_K))
        self.k = k
        self._lock = threading.Lock()
        self._sketches = {dim: SpaceSaving(k) for dim in _DIMS}
        # engines whose native per-collection counters we fold in at
        # scrape time, with the last-seen cumulative snapshot per engine
        self._engines: list = []
        self._engine_last: dict[int, dict] = {}
        self._overflow_emitted: set[str] = set()

    # --- hot path -----------------------------------------------------------
    def record(self, collection: str, requests: float = 1.0,
               bytes_in: float = 0.0, bytes_out: float = 0.0,
               error: bool = False) -> None:
        coll = collection or "default"
        evicted = None
        with self._lock:
            sk = self._sketches
            if requests > 0:
                evicted = sk["requests"].offer(coll, requests)
            if bytes_in > 0:
                sk["bytes_in"].offer(coll, bytes_in)
            if bytes_out > 0:
                sk["bytes_out"].offer(coll, bytes_out)
            if error:
                sk["errors"].offer(coll, 1.0)
        if evicted is not None:
            self._note_overflow(evicted)

    def _note_overflow(self, evicted: str) -> None:
        """Journal an eviction edge, once per tenant per process — a
        tenant churning in and out of the top-K must not flood the ring."""
        if evicted in self._overflow_emitted:
            return
        self._overflow_emitted.add(evicted)
        from seaweedfs_tpu_torch.stats import events as events_mod

        events_mod.emit("tenant_overflow", collection=evicted, k=self.k)

    # --- native-engine feed --------------------------------------------------
    def attach_engine(self, engine) -> None:
        """Fold a fastlane engine's per-collection native-op counters into
        the sketches at every scrape (deltas vs the previous scrape, so
        restarts and handler-path double counting cannot happen: native ops
        never pass through record())."""
        with self._lock:
            if engine not in self._engines:
                self._engines.append(engine)

    def detach_engine(self, engine) -> None:
        with self._lock:
            if engine in self._engines:
                self._engines.remove(engine)
                self._engine_last.pop(id(engine), None)

    def _fold_engines(self) -> None:
        """Caller holds no lock; takes it internally per engine."""
        with self._lock:
            engines = list(self._engines)
        for eng in engines:
            try:
                snap = eng.usage_metrics()
            except Exception:
                snap = None
            if not snap:
                continue
            key = id(eng)
            evicted_all = []
            charges = []
            with self._lock:
                last = self._engine_last.get(key, {})
                for coll, row in snap.items():
                    prev = last.get(coll, {})
                    d_req = sum(
                        max(0, row[f] - prev.get(f, 0))
                        for f in ("reads", "writes", "deletes"))
                    d_in = max(0, row["write_bytes"]
                               - prev.get("write_bytes", 0))
                    d_out = max(0, row["read_bytes"]
                                - prev.get("read_bytes", 0))
                    name = coll or "default"
                    sk = self._sketches
                    if d_req > 0:
                        ev = sk["requests"].offer(name, float(d_req))
                        if ev is not None:
                            evicted_all.append(ev)
                        charges.append((name, float(d_req)))
                    if d_in > 0:
                        sk["bytes_in"].offer(name, float(d_in))
                    if d_out > 0:
                        sk["bytes_out"].offer(name, float(d_out))
                self._engine_last[key] = snap
            for ev in evicted_all:
                self._note_overflow(ev)
            if charges:
                # native-path admission check (qos/admission.py): requests
                # the engine front door served still debit the tenant's
                # token bucket, so a limit holds across both paths. The
                # unarmed path is one attribute check, like emit()
                from seaweedfs_tpu_torch.qos import admission as qos_mod

                ctl = qos_mod.controller()
                if ctl.armed:
                    for name, d_req in charges:
                        ctl.charge(name, d_req)

    # --- export --------------------------------------------------------------
    def snapshot(self, n: int | None = None) -> dict:
        """JSON-ready view for /debug/usage and cluster.heat."""
        self._fold_engines()
        with self._lock:
            req = self._sketches["requests"]
            merged: dict[str, dict] = {}
            for dim in _DIMS:
                for key, count, err in self._sketches[dim].top():
                    row = merged.setdefault(key, {"collection": key})
                    row[dim] = count
                    row[dim + "_err"] = err
            rows = sorted(merged.values(),
                          key=lambda r: -r.get("requests", 0.0))
            if n is not None:
                rows = rows[:n]
            return {
                "k": self.k,
                "tenants": rows,
                "other": {dim: self._sketches[dim].other for dim in _DIMS},
                "error_bound": req.error_bound,
                "evictions": req.evictions,
                "tracked": len(req.counts),
            }

    def export_sketches(self) -> dict:
        """Serialized per-dimension sketches for a telemetry frame
        (stats/aggregate.build_frame): native-engine deltas folded first,
        then a consistent copy of all four dimensions under the lock."""
        self._fold_engines()
        with self._lock:
            return {dim: self._sketches[dim].to_dict() for dim in _DIMS}

    def lines(self) -> list[str]:
        """Prometheus text-format lines (Collector fn)."""
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, _fmt_value

        self._fold_engines()
        out = []
        fam_by_dim = {
            "requests": "SeaweedFS_usage_requests_total",
            "bytes_in": "SeaweedFS_usage_bytes_in_total",
            "bytes_out": "SeaweedFS_usage_bytes_out_total",
            "errors": "SeaweedFS_usage_errors_total",
        }
        with self._lock:
            for dim, fam in fam_by_dim.items():
                sk = self._sketches[dim]
                kind = "counter"
                out.append(f"# TYPE {fam} {kind}")
                for key, count, _err in sk.top():
                    lbl = _fmt_labels(("collection",), (key,))
                    out.append(f"{fam}{lbl} {_fmt_value(count)}")
                if sk.other > 0:
                    lbl = _fmt_labels(("collection",), (OTHER,))
                    out.append(f"{fam}{lbl} {_fmt_value(sk.other)}")
            req = self._sketches["requests"]
            out.append("# TYPE SeaweedFS_usage_tracked_collections gauge")
            out.append("SeaweedFS_usage_tracked_collections "
                       f"{len(req.counts)}")
            out.append("# TYPE SeaweedFS_usage_error_bound gauge")
            out.append("SeaweedFS_usage_error_bound "
                       f"{_fmt_value(req.error_bound)}")
            out.append("# TYPE SeaweedFS_usage_overflow_total counter")
            out.append(f"SeaweedFS_usage_overflow_total {req.evictions}")
        return out


# --- process singleton -------------------------------------------------------
_accountant: UsageAccountant | None = None
_collector = None
_lock = threading.Lock()


def accountant() -> UsageAccountant:
    """The process accountant; once made, returned without the lock (every
    metered request asks for it)."""
    global _accountant
    acct = _accountant
    if acct is not None:
        return acct
    with _lock:
        if _accountant is None:
            _accountant = UsageAccountant()
        return _accountant


def reset() -> None:
    """Empty the process accountant in place (its collector stays bound to
    it): no tenants, engines or overflow notes."""
    acct = accountant()
    with acct._lock:
        acct._sketches = {d: SpaceSaving(acct.k) for d in acct._sketches}
        acct._engines.clear()
        acct._engine_last.clear()
        acct._overflow_emitted.clear()


def enable() -> None:
    """Register the process accountant's collector (idempotent; called by
    HTTPService.enable_metrics alongside the history ring's start)."""
    global _collector
    acct = accountant()
    with _lock:
        if _collector is None:
            from seaweedfs_tpu_torch.stats.metrics import default_registry

            _collector = default_registry().register_collector(
                acct.lines, names=USAGE_FAMILIES)
