"""In-process metrics history ring: rates over time from point-in-time
counters — the fourth observability leg (beside traces, metrics and
health, and profiles: *trends*). The port's copy of the JAX package's
`stats/history.py`.

Every `/metrics` surface so far is a single scrape: `cluster.check`
cannot tell a volume server doing 80k req/s from an idle one, cannot
compute error *ratios* or GB/s, and nothing notices a counter that
stopped moving. `MetricsHistory` closes that gap without an external
Prometheus: a background thread self-scrapes the process `Registry`
(reusing `parse_exposition` on `Registry.render()` — the exact text a
remote scraper would see) into fixed-size per-series ring buffers, so
any window inside the retention horizon can answer "what was the rate?".

Memory is bounded on both axes: `slots` samples per series (deque
maxlen) and `max_series` distinct series (new series past the cap are
counted as dropped, never stored). The scrape thread only exists once a
server enables metrics (`HTTPService.enable_metrics`); a bare library
import pays nothing.

`counter_rate` is the Prometheus `rate()` discipline: a counter that
*decreases* between samples means the process restarted (or a stale
fastlane `.so` rebound its atomics) — the post-reset value counts as
accumulation since the reset, and the result is clamped non-negative,
never a huge negative spike. `SeaweedFS_process_start_time_seconds`
(stats.metrics.PROCESS_START_TIME) is the companion restart signal.

Served on every role as `GET /debug/metrics/history?family=&window=`
(server/httpd._register_debug_routes); `stats/alerts.py` evaluates its
rules against this ring on every scrape; `cluster.top` renders the
cluster-wide view. The design follows the Mnemosyne/Prometheus-style
monitoring literature in PAPERS.md: rates-over-time and rules are the
layer that makes raw metrics actionable.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from seaweedfs_tpu_torch.stats.metrics import default_registry, parse_exposition

DEFAULT_INTERVAL = float(os.environ.get("SEAWEEDFS_TPU_HISTORY_INTERVAL", "5"))
DEFAULT_SLOTS = int(os.environ.get("SEAWEEDFS_TPU_HISTORY_SLOTS", "120"))
DEFAULT_MAX_SERIES = int(
    os.environ.get("SEAWEEDFS_TPU_HISTORY_MAX_SERIES", "4096")
)

# Exposition names with these suffixes carry counter semantics (histogram
# _sum/_count/_bucket components are cumulative too): windowed rates make
# sense; everything else is a gauge (last value is the story).
COUNTER_SUFFIXES = ("_total", "_sum", "_count", "_bucket")

HISTORY_FAMILIES = (
    "SeaweedFS_stats_history_scrapes_total",
    "SeaweedFS_stats_history_series",
    "SeaweedFS_stats_history_dropped_series_total",
)


def counter_rate(samples, window: float, now: float | None = None):
    """Windowed per-second rate of a cumulative counter -> float | None.

    `samples` is an iterable of (unix_ts, value). Only points inside
    [now - window, now] count; fewer than two points -> None (no rate is
    honest, 0.0 would claim idleness). A decrease between consecutive
    samples is a counter reset (process restart): the post-reset value is
    the accumulation since the reset — Prometheus rate() semantics — and
    the result is clamped >= 0, never a negative spike.
    """
    now = time.time() if now is None else now
    cutoff = now - window
    pts = [(t, v) for t, v in samples if t >= cutoff]
    if len(pts) < 2:
        return None
    total = 0.0
    prev = pts[0][1]
    for _, v in pts[1:]:
        delta = v - prev
        if delta < 0:  # reset: count what accumulated after it
            delta = max(v, 0.0)
        total += delta
        prev = v
    span = pts[-1][0] - pts[0][0]
    if span <= 0:
        return None
    return max(total, 0.0) / span


def quantile_from_bucket_rates(bucket_rates: dict, q: float,
                               flags: dict | None = None):
    """Interpolated quantile from per-`le` cumulative bucket *rates* (the
    windowed rate of each `_bucket` series keeps the cumulative shape:
    rate of cumulative is cumulative of rates). -> seconds | None.

    When the requested rank lands in the +Inf overflow bucket the true
    quantile is unknowable from the histogram — the value returned is the
    largest finite bound (a LOWER bound on the truth, never a fabricated
    finite latency) and `flags["inf_mass"]` is set True so consumers
    (cluster.top's p99 column) can render it as ">bound" instead of
    "=bound". With no finite bucket at all: None, still flagged."""
    items = sorted(bucket_rates.items())
    if not items:
        return None
    total = items[-1][1]  # highest bound (ideally +Inf) carries the count
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in items:
        if cum >= rank:
            if bound == float("inf"):
                # overflow bucket: clamp to the largest finite bound,
                # flagged — a lower bound on the truth, not an estimate
                if flags is not None:
                    flags["inf_mass"] = True
                finite = [b for b, _ in items if b != float("inf")]
                return max(finite) if finite else None
            if cum <= prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound


class MetricsHistory:
    """Fixed-size per-series ring of (ts, value) samples, fed by
    self-scraping the registry. Thread-safe; listeners (the alert engine)
    run after every scrape, outside the lock."""

    def __init__(self, registry=None, interval: float | None = None,
                 slots: int | None = None, max_series: int | None = None):
        self.registry = registry if registry is not None else default_registry()
        self.interval = max(
            0.05, float(DEFAULT_INTERVAL if interval is None else interval)
        )
        self.slots = max(2, int(DEFAULT_SLOTS if slots is None else slots))
        self.max_series = int(
            DEFAULT_MAX_SERIES if max_series is None else max_series
        )
        # (family, sorted-labels-tuple) -> (labels_dict, deque[(ts, value)])
        self._series: dict[tuple, tuple] = {}
        # every key ever observed (stored, refused at the cap, or purged):
        # only keys NOT in here are genuinely new and safe to zero-seed —
        # a long-lived counter admitted late (cap freed up, collector
        # re-registered) must not rate its whole cumulative value into one
        # interval. Bounded: past 8x the series cap, seeding just stops.
        self._ever_seen: set[tuple] = set()
        self._lock = threading.Lock()
        self._listeners: list = []
        self.scrapes_total = 0
        self.dropped_series_total = 0
        self.last_scrape = 0.0
        self._stop: threading.Event | None = None
        self._collector = self.registry.register_collector(
            self._self_lines, names=HISTORY_FAMILIES
        )

    @property
    def retention_seconds(self) -> float:
        return self.slots * self.interval

    # --- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        """Start the background scrape loop. Idempotent."""
        with self._lock:
            if self._stop is not None:
                return
            self._stop = threading.Event()
            stop = self._stop
        t = threading.Thread(
            target=self._loop, args=(stop,), name="sw-metrics-history",
            daemon=True,
        )
        t.start()

    def _loop(self, stop: threading.Event) -> None:  # pragma: no cover - timing
        while not stop.wait(self.interval):
            try:
                self.scrape_once()
            except Exception:
                pass

    def stop(self) -> None:
        with self._lock:
            stop, self._stop = self._stop, None
        if stop is not None:
            stop.set()

    def close(self) -> None:
        """stop() + unregister the self-metrics collector (tests that build
        private histories on private registries don't need this; anything
        attached to a long-lived registry does)."""
        self.stop()
        self.registry.unregister_collector(self._collector)

    # --- scraping --------------------------------------------------------------
    def scrape_once(self, now: float | None = None) -> None:
        """One self-scrape: render the registry, parse it back, append one
        sample per series. `now` is injectable for deterministic tests."""
        now = time.time() if now is None else float(now)
        samples = parse_exposition(self.registry.render())
        with self._lock:
            # lazily-built eviction pool for cap pressure: series that
            # VANISHED from the registry (last sample predates the previous
            # scrape — an unregistered collector, e.g. a stopped server's
            # per-volume/per-node gauges) may be reclaimed to admit a live
            # newcomer. Without this, a churning fleet permanently locks
            # dead series into the cap and a brand-new series carrying an
            # alert signal (the first 5xx of an error storm) is refused.
            reclaim: list | None = None
            for name, labels, value in samples:
                key = (name, tuple(sorted(labels.items())))
                ent = self._series.get(key)
                if ent is None:
                    genuinely_new = (
                        key not in self._ever_seen
                        and len(self._ever_seen) < 8 * self.max_series
                    )
                    if len(self._ever_seen) < 8 * self.max_series:
                        self._ever_seen.add(key)
                    if len(self._series) >= self.max_series:
                        if reclaim is None:
                            reclaim = sorted(
                                (k for k, (_, dq) in self._series.items()
                                 if not dq or dq[-1][0] < self.last_scrape),
                                key=lambda k: (
                                    self._series[k][1][-1][0]
                                    if self._series[k][1] else 0.0),
                                reverse=True,  # pop() takes the oldest
                            )
                        victim = None
                        while reclaim:
                            k = reclaim.pop()
                            kdq = self._series[k][1]
                            # re-check at pop time: a vanished series can
                            # REAPPEAR later in this same scrape's samples
                            # — once updated it is live again, not a victim
                            if not kdq or kdq[-1][0] < self.last_scrape:
                                victim = k
                                break
                        if victim is None:
                            self.dropped_series_total += 1
                            continue
                        del self._series[victim]
                    dq = collections.deque(maxlen=self.slots)
                    # a counter series appearing between scrapes was
                    # implicitly 0 at the previous one (the registry omits
                    # zero-valued children) — seed it so a fresh burst
                    # (e.g. the first 5xx of an error storm) rates from
                    # its very first sample instead of needing two. Only
                    # for GENUINELY new keys: one seen before (refused at
                    # the cap, or purged) carries an unknown prior value.
                    if self.last_scrape > 0 and genuinely_new \
                            and name.endswith(COUNTER_SUFFIXES):
                        dq.append((self.last_scrape, 0.0))
                    ent = self._series[key] = (labels, dq)
                ent[1].append((now, value))
            self.scrapes_total += 1
            self.last_scrape = now
            # purge series that stopped being exported (a stopped server
            # unregisters its collector): past the retention horizon their
            # stale last values must not keep feeding gauge-based alerts
            horizon = now - self.retention_seconds
            dead = [k for k, (_, dq) in self._series.items()
                    if not dq or dq[-1][0] < horizon]
            for k in dead:
                del self._series[k]
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(self, now)
            except Exception:
                pass

    def ensure_fresh(self, max_age: float | None = None) -> None:
        """Scrape now unless a sample newer than `max_age` (default: the
        scrape interval) exists — keeps `/debug/metrics/history` and
        `-once` dashboards current even before the loop's next tick."""
        max_age = self.interval if max_age is None else max_age
        if time.time() - self.last_scrape >= max_age:
            self.scrape_once()

    # --- listeners (the alert engine hooks in here) ----------------------------
    def add_listener(self, fn) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # --- durable-store seam (stats/store.py) -----------------------------------
    def samples_since(self, since: float) -> list[tuple]:
        """-> [(t, family, labels_dict, value)] every stored sample
        strictly after `since`, oldest first — the telemetry store's
        flusher pulls the ring tail through this watermark (the ring is
        the buffer; a deferred flush just re-pulls the same tail)."""
        out = []
        with self._lock:
            for (name, _), (labels, dq) in self._series.items():
                for t, v in dq:
                    if t > since:
                        out.append((t, name, dict(labels), v))
        out.sort(key=lambda p: p[0])
        return out

    def preload(self, points) -> int:
        """Inject replayed samples (t, family, labels_dict, value) from a
        spool — restart replay, before live scraping. The replay
        watermark becomes `last_scrape`, so the next live scrape
        zero-seeds nothing that already has history (replayed keys join
        `_ever_seen`) and `counter_rate`'s reset clamp turns the restart
        into a plain counter reset instead of a phantom spike."""
        pts = sorted(points, key=lambda p: p[0])
        n = 0
        with self._lock:
            for t, name, labels, v in pts:
                key = (name, tuple(sorted(labels.items())))
                ent = self._series.get(key)
                if ent is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series_total += 1
                        continue
                    if len(self._ever_seen) < 8 * self.max_series:
                        self._ever_seen.add(key)
                    ent = self._series[key] = (
                        dict(labels),
                        collections.deque(maxlen=self.slots))
                ent[1].append((float(t), float(v)))
                n += 1
            if pts:
                self.last_scrape = max(self.last_scrape, pts[-1][0])
        return n

    # --- views -----------------------------------------------------------------
    def rates(self, family: str, window: float, now: float | None = None):
        """-> [(labels_dict, rate | None)] for every series of `family`."""
        now = time.time() if now is None else now
        cutoff = now - window
        with self._lock:
            items = [
                (dict(labels), [p for p in dq if p[0] >= cutoff])
                for (name, _), (labels, dq) in self._series.items()
                if name == family
            ]
        return [(labels, counter_rate(pts, window, now))
                for labels, pts in items]

    def latests(self, family: str, require_current: bool = True):
        """-> [(labels_dict, value, ts)] newest sample per series. With
        require_current (default) only series still present in the most
        recent scrape count — an unregistered collector's leftovers must
        not keep firing gauge alerts."""
        with self._lock:
            out = []
            for (name, _), (labels, dq) in self._series.items():
                if name != family or not dq:
                    continue
                ts, value = dq[-1]
                if require_current and ts < self.last_scrape:
                    continue
                out.append((dict(labels), value, ts))
        return out

    def snapshot(self, family: str | None = None, window: float | None = None,
                 max_samples: int = 16, now: float | None = None,
                 since: float | None = None) -> list[dict]:
        """JSON-ready series view for /debug/metrics/history: last value,
        windowed rate (counter-suffixed families only), and up to
        `max_samples` trailing raw points (0 omits them). `family` matches
        exactly or as a prefix (`SeaweedFS_http_request_seconds` pulls its
        _bucket/_sum/_count components too).

        `since` is an incremental cursor: only samples strictly after that
        timestamp are returned (series with nothing new are omitted
        entirely), so a poller passing the previous response's watermark
        (`last_scrape`) stops re-shipping the full ring every cycle. The
        windowed `rate` still uses the full window — a cursor narrows the
        shipped points, not the math."""
        now = time.time() if now is None else now
        window = self.retention_seconds if window is None else window
        cutoff = now - window
        with self._lock:
            items = [
                (name, dict(labels), list(dq))
                for (name, _), (labels, dq) in sorted(self._series.items())
                if family is None or name == family
                or name.startswith(family + "_")
            ]
        out = []
        for name, labels, pts in items:
            win = [(t, v) for t, v in pts if t >= cutoff]
            if not win:
                continue
            fresh = win if since is None \
                else [(t, v) for t, v in win if t > since]
            if not fresh:
                continue  # nothing new past the cursor: omit the series
            entry = {
                "family": name,
                "labels": labels,
                "last": win[-1][1],
                "last_ts": round(win[-1][0], 3),
                "rate": (
                    counter_rate(win, window, now)
                    if name.endswith(COUNTER_SUFFIXES) else None
                ),
            }
            if max_samples > 0:
                entry["samples"] = [
                    [round(t, 3), v] for t, v in fresh[-max_samples:]
                ]
            out.append(entry)
        return out

    def families(self) -> list[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def clear(self) -> None:
        """Drop every stored sample (tests: neutralize an injected fault
        so later windows don't keep seeing it). Counters survive. Also
        forgets the last scrape time: a wiped ring has no "previous
        scrape", so the next one must not zero-seed every counter series
        (that would re-manufacture the very rates clear() removed)."""
        with self._lock:
            self._series.clear()
            self.last_scrape = 0.0

    # --- self-observability -----------------------------------------------------
    def _self_lines(self) -> list[str]:
        with self._lock:
            scrapes = self.scrapes_total
            series = len(self._series)
            dropped = self.dropped_series_total
        return [
            "# HELP SeaweedFS_stats_history_scrapes_total self-scrapes into"
            " the metrics history ring",
            "# TYPE SeaweedFS_stats_history_scrapes_total counter",
            f"SeaweedFS_stats_history_scrapes_total {scrapes:g}",
            "# HELP SeaweedFS_stats_history_series distinct series currently"
            " retained in the history ring",
            "# TYPE SeaweedFS_stats_history_series gauge",
            f"SeaweedFS_stats_history_series {series:g}",
            "# HELP SeaweedFS_stats_history_dropped_series_total new series"
            " refused because the ring hit its series cap",
            "# TYPE SeaweedFS_stats_history_dropped_series_total counter",
            f"SeaweedFS_stats_history_dropped_series_total {dropped:g}",
        ]


_default: MetricsHistory | None = None
_default_lock = threading.Lock()


def default_history() -> MetricsHistory:
    """Process-wide history over the default registry. Created lazily; the
    scrape loop only starts when a server enables metrics (enable_metrics
    calls .start()), so the ring costs nothing until the process serves."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsHistory()
        return _default
