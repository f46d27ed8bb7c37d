"""Access-heat scoring and capacity forecasting over the history rings.

Three consumers drove the design:
`cluster.heat` / `cluster.top` render the cluster's thermal picture, the
capacity_forecast alert pair pages before a disk actually fills, and the
upcoming tiering work will move volumes by these scores.

HeatEngine (every role that meters itself):
  * per-volume heat — a windowed EWMA over the per-volume native-op rate
    series the volume server already exports
    (`SeaweedFS_volume_fastlane_volume_requests_total`), re-exported as
    the gauge `SeaweedFS_volume_heat_score{server,volume}`. Smoothing
    matters: tiering must not flap a volume between tiers because one
    scrape caught a burst. Promote/demote threshold crossings are
    hysteresis-gated and journaled (`heat_promoted` / `heat_demoted`)
    so `cluster.why` can explain a tier move after the fact.
  * days-to-full — an ordinary least-squares fit over each data
    directory's `SeaweedFS_volume_disk_used_bytes` ring samples gives a
    fill slope (bytes/s); dividing the latest free-bytes gauge by it
    yields `SeaweedFS_node_days_to_full{node,dir}`. The gauge only
    exists while the slope is meaningfully positive — deleting data
    flattens the fit and the series (and its alert) clears itself.

HeatRollup (master only): heartbeats carry per-volume cumulative op
counters (volume.py annotates them from the engine's per-volume atomics);
the rollup turns consecutive beats into per-(node, collection) rates,
EWMA-smooths them, and exports `SeaweedFS_heat_collection_score` /
`SeaweedFS_heat_node_score` — the cluster-wide view no single server's
ring can assemble. Entries expire when a node stops beating.

Everything here runs at scrape/heartbeat cadence off the ring — never on
a request path (the arXiv:1207.6744 foreground-protection principle).
"""

from __future__ import annotations

import os
import threading
import time

HEAT_FAMILIES = (
    "SeaweedFS_volume_heat_score",
    "SeaweedFS_node_days_to_full",
)

ROLLUP_FAMILIES = (
    "SeaweedFS_heat_collection_score",
    "SeaweedFS_heat_node_score",
)

# EWMA smoothing weight for new observations, and the hysteresis pair
# (ops/s) whose crossings journal heat_promoted / heat_demoted edges
DEFAULT_ALPHA = 0.3
DEFAULT_PROMOTE = float(os.environ.get("SEAWEEDFS_TPU_HEAT_PROMOTE", "10"))
DEFAULT_DEMOTE = float(os.environ.get("SEAWEEDFS_TPU_HEAT_DEMOTE", "2"))
# rate window for heat (seconds) and the fit window for the capacity
# forecast — the forecast window bounds how long stale fill history can
# keep a days-to-full gauge alive after a mass deletion
DEFAULT_WINDOW = 60.0
DEFAULT_FORECAST_WINDOW = 300.0
# slopes below this (bytes/s) are noise, not a fill trend
MIN_FILL_SLOPE = 1.0


def linear_slope(points) -> float | None:
    """Ordinary least-squares slope of [(t, v)] -> units/second, or None
    when the fit is degenerate (fewer than 3 points or zero time span)."""
    pts = list(points)
    n = len(pts)
    if n < 3:
        return None
    mean_t = sum(t for t, _ in pts) / n
    mean_v = sum(v for _, v in pts) / n
    sxx = sum((t - mean_t) ** 2 for t, _ in pts)
    if sxx <= 0:
        return None
    sxy = sum((t - mean_t) * (v - mean_v) for t, v in pts)
    return sxy / sxx


class HeatEngine:
    """Per-process heat scorer + capacity forecaster, attached as a
    history listener so it refreshes on every scrape. Tests build private
    instances and call observe(now) with injected clocks."""

    def __init__(self, history=None, alpha: float = DEFAULT_ALPHA,
                 window: float = DEFAULT_WINDOW,
                 promote: float = DEFAULT_PROMOTE,
                 demote: float = DEFAULT_DEMOTE,
                 forecast_window: float = DEFAULT_FORECAST_WINDOW,
                 min_slope: float = MIN_FILL_SLOPE):
        if demote > promote:
            raise ValueError("demote threshold must not exceed promote")
        from seaweedfs_tpu_torch.stats import history as history_mod

        self.history = (history if history is not None
                        else history_mod.default_history())
        self.alpha = float(alpha)
        self.window = float(window)
        self.promote = float(promote)
        self.demote = float(demote)
        self.forecast_window = float(forecast_window)
        self.min_slope = float(min_slope)
        self._lock = threading.Lock()
        self._scores: dict[tuple, float] = {}   # (server, volume) -> EWMA
        self._hot: set[tuple] = set()
        self._days: dict[tuple, float] = {}     # (node, dir) -> days
        # seconds of signal the last fit actually covered (>= the raw
        # forecast_window once the durable 1m tier contributes)
        self._fit_window = float(forecast_window)
        self._listener = None

    # --- lifecycle -----------------------------------------------------------
    def attach(self) -> None:
        """Refresh on every history scrape. Idempotent."""
        if self._listener is None:
            self._listener = lambda hist, now: self.observe(now)
            self.history.add_listener(self._listener)

    def close(self) -> None:
        if self._listener is not None:
            self.history.remove_listener(self._listener)
            self._listener = None

    # --- scoring -------------------------------------------------------------
    def observe(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self._observe_heat(now)
        self._observe_forecast(now)

    def _observe_heat(self, now: float) -> None:
        from seaweedfs_tpu_torch.stats import events as events_mod

        agg: dict[tuple, float] = {}
        for labels, rate in self.history.rates(
                "SeaweedFS_volume_fastlane_volume_requests_total",
                self.window, now):
            if rate is None:
                continue
            key = (str(labels.get("server", "")),
                   str(labels.get("volume", "")))
            agg[key] = agg.get(key, 0.0) + rate
        promoted, demoted = [], []
        with self._lock:
            a = self.alpha
            for key, raw in agg.items():
                prev = self._scores.get(key)
                self._scores[key] = (
                    raw if prev is None else prev + a * (raw - prev))
            # series gone quiet (volume unregistered, rate window empty):
            # decay toward zero instead of freezing a stale score
            for key in list(self._scores):
                if key not in agg:
                    s = self._scores[key] * (1.0 - a)
                    if s < 1e-3:
                        if key in self._hot:
                            self._hot.discard(key)
                            demoted.append((key, 0.0))
                        del self._scores[key]
                    else:
                        self._scores[key] = s
            for key, score in self._scores.items():
                if key not in self._hot and score >= self.promote:
                    self._hot.add(key)
                    promoted.append((key, score))
                elif key in self._hot and score <= self.demote:
                    self._hot.discard(key)
                    demoted.append((key, score))
        for (server, vol), score in promoted:
            events_mod.emit("heat_promoted", volume=_int_or_none(vol),
                            node=server, score=round(score, 3))
        for (server, vol), score in demoted:
            events_mod.emit("heat_demoted", volume=_int_or_none(vol),
                            node=server, score=round(score, 3))

    def _observe_forecast(self, now: float) -> None:
        free = {
            (str(l.get("server", "")), str(l.get("dir", ""))): v
            for l, v, _ in self.history.latests(
                "SeaweedFS_volume_disk_free_bytes")
        }
        snap = self.history.snapshot(
            "SeaweedFS_volume_disk_used_bytes",
            window=self.forecast_window,
            max_samples=self.history.slots, now=now)
        # durable extension: when the telemetry store (stats/store.py)
        # holds 1m rollups of the fill series, the OLS fit rides
        # hours-to-days of real signal instead of the 5-minute in-memory
        # window — a days-scale extrapolation finally fitted on a
        # days-scale trend. Spool points older than the raw window
        # prepend; raw ring points carry the fresh tail.
        durable: dict[tuple, list] = {}
        try:
            from seaweedfs_tpu_torch.stats import store as store_mod

            st = store_mod.store()
            if st is not None:
                for lk, pts in st.forecast_points(
                        "SeaweedFS_volume_disk_used_bytes").items():
                    labels = dict(lk)
                    key = (str(labels.get("server", "")),
                           str(labels.get("dir", "")))
                    durable.setdefault(key, []).extend(pts)
        except Exception:
            pass
        fresh: dict[tuple, float] = {}
        window_used = self.forecast_window
        for entry in snap:
            labels = entry.get("labels", {})
            key = (str(labels.get("server", "")), str(labels.get("dir", "")))
            raw = [(t, v) for t, v in (entry.get("samples") or ())]
            raw_t0 = raw[0][0] if raw else now
            pts = sorted(
                p for p in durable.get(key, ()) if p[0] < raw_t0
            ) + raw
            slope = linear_slope(pts)
            if slope is None or slope < self.min_slope:
                continue
            fb = free.get(key)
            if fb is None or fb < 0:
                continue
            fresh[key] = fb / slope / 86400.0
            if pts:
                window_used = max(window_used, now - pts[0][0])
        with self._lock:
            self._days = fresh
            self._fit_window = window_used

    # --- export --------------------------------------------------------------
    def lines(self) -> list[str]:
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, _fmt_value

        out = []
        with self._lock:
            scores = sorted(self._scores.items())
            days = sorted(self._days.items())
        out.append("# TYPE SeaweedFS_volume_heat_score gauge")
        for (server, vol), score in scores:
            lbl = _fmt_labels(("server", "volume"), (server, vol))
            out.append(
                f"SeaweedFS_volume_heat_score{lbl} {_fmt_value(score)}")
        out.append("# TYPE SeaweedFS_node_days_to_full gauge")
        for (node, d), v in days:
            lbl = _fmt_labels(("node", "dir"), (node, d))
            out.append(f"SeaweedFS_node_days_to_full{lbl} {_fmt_value(v)}")
        return out

    def snapshot(self) -> dict:
        """JSON-ready view for /debug/heat and cluster.heat."""
        with self._lock:
            vols = [
                {"server": server, "volume": vol,
                 "score": round(score, 3),
                 "hot": (server, vol) in self._hot}
                for (server, vol), score in sorted(
                    self._scores.items(), key=lambda kv: -kv[1])
            ]
            forecast = [
                {"node": node, "dir": d, "days_to_full": round(v, 2)}
                for (node, d), v in sorted(self._days.items())
            ]
        return {
            "volumes": vols,
            "forecast": forecast,
            "params": {"alpha": self.alpha, "window": self.window,
                       "promote": self.promote, "demote": self.demote,
                       "forecast_window": self.forecast_window,
                       "fit_window": round(self._fit_window, 1)},
        }


def _int_or_none(v):
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


class HeatRollup:
    """Master-side cluster heat: consecutive heartbeats' per-volume
    cumulative op counters -> per-(node, collection) EWMA rates ->
    collection/node scores. Not a listener — the heartbeat handler feeds
    it directly, so cadence follows the pulse, not the scrape loop."""

    def __init__(self, alpha: float = DEFAULT_ALPHA, expire: float = 60.0):
        self.alpha = float(alpha)
        self.expire = float(expire)
        self._lock = threading.Lock()
        self._last: dict[tuple, tuple] = {}   # (node, vid) -> (ops, ts)
        self._rate: dict[tuple, list] = {}    # (node, coll) -> [ewma, ts]

    def feed(self, node: str, volumes, now: float | None = None) -> None:
        now = time.time() if now is None else now
        per_coll: dict[str, float] = {}
        saw_delta = False
        with self._lock:
            for v in volumes or ():
                try:
                    vid = int(v.get("id", 0))
                except (TypeError, ValueError):
                    continue
                coll = str(v.get("collection", "") or "") or "default"
                ops = int(v.get("read_ops", 0) or 0) \
                    + int(v.get("write_ops", 0) or 0)
                key = (node, vid)
                prev = self._last.get(key)
                self._last[key] = (ops, now)
                if prev is None:
                    continue
                dt = now - prev[1]
                if dt <= 0:
                    continue
                d = ops - prev[0]
                if d < 0:  # counter reset (volume server restart)
                    d = ops
                saw_delta = True
                per_coll[coll] = per_coll.get(coll, 0.0) + d / dt
            if saw_delta or per_coll:
                a = self.alpha
                node_colls = {c for (n, c) in self._rate if n == node}
                for coll, r in per_coll.items():
                    ent = self._rate.get((node, coll))
                    if ent is None:
                        self._rate[(node, coll)] = [r, now]
                    else:
                        ent[0] += a * (r - ent[0])
                        ent[1] = now
                # collections this node no longer reports decay to zero
                for coll in node_colls - set(per_coll):
                    ent = self._rate[(node, coll)]
                    ent[0] *= (1.0 - a)
                    ent[1] = now
                    if ent[0] < 1e-3:
                        del self._rate[(node, coll)]
            # forget nodes that stopped beating entirely
            cutoff = now - self.expire
            for key in [k for k, (_, ts) in self._last.items()
                        if ts < cutoff]:
                del self._last[key]
            for key in [k for k, ent in self._rate.items()
                        if ent[1] < cutoff]:
                del self._rate[key]

    def _sums(self) -> tuple[dict, dict]:
        colls: dict[str, float] = {}
        nodes: dict[str, float] = {}
        with self._lock:
            for (node, coll), (r, _ts) in self._rate.items():
                colls[coll] = colls.get(coll, 0.0) + r
                nodes[node] = nodes.get(node, 0.0) + r
        return colls, nodes

    def lines(self) -> list[str]:
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, _fmt_value

        colls, nodes = self._sums()
        out = ["# TYPE SeaweedFS_heat_collection_score gauge"]
        for coll, r in sorted(colls.items()):
            lbl = _fmt_labels(("collection",), (coll,))
            out.append(
                f"SeaweedFS_heat_collection_score{lbl} {_fmt_value(r)}")
        out.append("# TYPE SeaweedFS_heat_node_score gauge")
        for node, r in sorted(nodes.items()):
            lbl = _fmt_labels(("node",), (node,))
            out.append(f"SeaweedFS_heat_node_score{lbl} {_fmt_value(r)}")
        return out

    def snapshot(self) -> dict:
        colls, nodes = self._sums()
        return {
            "collections": [
                {"collection": c, "score": round(r, 3)}
                for c, r in sorted(colls.items(), key=lambda kv: -kv[1])
            ],
            "nodes": [
                {"node": n, "score": round(r, 3)}
                for n, r in sorted(nodes.items(), key=lambda kv: -kv[1])
            ],
        }


# --- process singletons ------------------------------------------------------
_engine: HeatEngine | None = None
_collector = None
_lock = threading.Lock()
# master rollups register here so the role-agnostic /debug/heat route can
# merge their snapshots (a test process may host several masters)
_rollups: list[HeatRollup] = []


def engine() -> HeatEngine:
    global _engine
    with _lock:
        if _engine is None:
            _engine = HeatEngine()
        return _engine


def enable() -> None:
    """Attach the process heat engine to the history ring + register its
    collector (idempotent; called by HTTPService.enable_metrics)."""
    global _collector
    eng = engine()
    eng.attach()
    with _lock:
        if _collector is None:
            from seaweedfs_tpu_torch.stats.metrics import default_registry

            _collector = default_registry().register_collector(
                eng.lines, names=HEAT_FAMILIES)


def register_rollup(rollup: HeatRollup) -> None:
    with _lock:
        if rollup not in _rollups:
            _rollups.append(rollup)


def unregister_rollup(rollup: HeatRollup) -> None:
    with _lock:
        if rollup in _rollups:
            _rollups.remove(rollup)


def rollups() -> list[HeatRollup]:
    with _lock:
        return list(_rollups)
