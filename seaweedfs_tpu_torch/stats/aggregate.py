"""Cluster telemetry plane: mergeable frames in, one-fetch state out.

Every observability layer before this one is per-process: the Space-Saving
usage sketches (stats/usage.py) live inside each filer/S3 gateway, SLO burn
(stats/alerts.py) is evaluated against each process's own history ring, and
`cluster.top`/`cluster.check` fan-out-scrape N endpoints to reassemble a
cluster view client-side. That is exactly the wrong observer for admission
control: a tenant pushing 1/N of the abuse budget through each of N
gateways never trips a per-process threshold, and an error-budget burn
spread across gateways never shows a single process 14x over. Actuation
must key on the aggregate load, not one observer's slice (the
background-vs-foreground accounting insight of arXiv:1207.6744).

So every role ships a compact **telemetry frame** to the leader master on
its existing push cadence (volume: heartbeat body; filer: /cluster/register
body; S3/webdav: a TelemetryPusher thread POSTing /cluster/telemetry;
master: self-feeds from its maintenance loop):

    {v, node, role, proc, ts, seq, interval,
     usage:   {dim: SpaceSaving.to_dict()},      # mergeable sketches
     samples: [[family, {labels}, value], ...],  # SLO-relevant cumulative
                                                 # counters, role-filtered,
                                                 # method label pre-summed
     alerts:  [{alert, severity}, ...],          # current firing edges
     slos:    {name: {window: burn}}}            # local burn state

The master-side TelemetryAggregator merges frames into cluster-level
series: per-tenant usage via SpaceSaving.merge (composed error bounds —
the exported bound always covers the true count), per-role request/error
rates from summed per-sender counter rates (reset-clamped via
history.counter_rate), and the multi-window burn rules of alerts.py re-evaluated
over the MERGED stream by duck-typing the history interface
(`rates(family, window, now)`) that alerts.slo_burn consumes. A sender
that stops reporting is itself a finding: staleness (3x its own declared
interval) raises `cluster_telemetry_stale` and exports
`SeaweedFS_cluster_telemetry_stale{node}`.

Everything is served from ONE fetch — `GET /debug/cluster/telemetry` on
the master — which `cluster.top` renders as a rollup header and
`cluster.check` prefers over the N-endpoint alert fan-out when live.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque

from seaweedfs_tpu_torch.stats import usage as usage_mod

CLUSTER_FAMILIES = (
    "SeaweedFS_cluster_usage_requests_total",
    "SeaweedFS_cluster_usage_bytes_in_total",
    "SeaweedFS_cluster_usage_bytes_out_total",
    "SeaweedFS_cluster_usage_errors_total",
    "SeaweedFS_cluster_usage_error_bound",
    "SeaweedFS_cluster_usage_tracked_collections",
    "SeaweedFS_cluster_slo_burn_rate",
    "SeaweedFS_cluster_request_rate",
    "SeaweedFS_cluster_error_rate",
    "SeaweedFS_cluster_telemetry_stale",
    "SeaweedFS_cluster_telemetry_senders",
    "SeaweedFS_cluster_telemetry_frames_total",
    "SeaweedFS_cluster_telemetry_frame_age_seconds",
    "SeaweedFS_cluster_alerts_firing",
)

# (name, severity) — the cluster-scope alert rules the aggregator owns.
# The lint (tools/check_metric_names.py) checks uniqueness + severities.
CLUSTER_RULES = (
    ("cluster_slo_burn_fast", "critical"),
    ("cluster_slo_burn_slow", "warning"),
    ("cluster_telemetry_stale", "warning"),
)

FRAME_VERSION = 1

# default push cadence for roles without an existing master link (S3,
# webdav); heartbeat-carried frames use the sender's own pulse
DEFAULT_INTERVAL = 5.0

# the cumulative families a frame carries, role-filtered at build time:
# enough to re-evaluate every DEFAULT_SLOS availability + latency rule
# over the merged stream, and nothing else (bytes/frame is the point)
FRAME_SAMPLE_FAMILIES = (
    "SeaweedFS_http_request_total",
    "SeaweedFS_http_request_seconds",
)

_seq_lock = threading.Lock()
_seq = 0


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def _sum_role_series(m, role: str, summed: dict) -> None:
    """Add one frame family's series of `role` into `summed`: the request
    counter by code, the latency histogram's buckets by `le` (the burn
    rules never read _sum/_count), pre-summed across `method`. Read off
    the metric's samples, which gives what rendering the family and
    parsing the text back gives (the JAX package's way) at a small part of
    its cost: every role builds a frame a pulse, and the text of a
    long-lived process's request families runs to thousands of lines."""
    if m.kind not in ("counter", "histogram"):
        raise TypeError(f"{m.name}: not a frame family kind ({m.kind})")
    names = m.label_names
    if "role" not in names:
        return
    ri = names.index("role")
    ci = names.index("code") if "code" in names else None
    for name, key, extra, val in m.samples():
        if key[ri] != role:
            continue
        if m.kind == "counter":
            k = (name, key[ci] if ci is not None else "")
        elif extra:
            k = (name, extra[1])
        else:
            continue
        summed[k] = summed.get(k, 0.0) + float(val)


def build_frame(role: str, node: str, interval: float = DEFAULT_INTERVAL,
                registry=None, acct=None, now: float | None = None) -> dict:
    """Assemble this process's telemetry frame for `role`.

    `samples` carries only the SLO-relevant families, filtered to the
    sender's own role (co-located roles in one process — test clusters —
    ship disjoint series, so the aggregator can sum without double
    counting) and pre-summed across the `method` label (the burn rules
    only match on role/code/le; dropping method shrinks the frame and the
    merged cardinality)."""
    from seaweedfs_tpu_torch.stats import alerts as alerts_mod
    from seaweedfs_tpu_torch.stats import profiler
    from seaweedfs_tpu_torch.stats.metrics import default_registry

    now = time.time() if now is None else now
    # normalize to host:port — filer/S3 senders pass their full url while
    # master/volume pass host:port; one key shape keeps the sender table
    # and the stale gauge's {node} label consistent
    node = node.split("://", 1)[-1].rstrip("/")
    reg = registry if registry is not None else default_registry()
    if acct is None:
        acct = usage_mod.accountant()

    summed: dict[tuple, float] = {}
    for n in FRAME_SAMPLE_FAMILIES:
        m = reg.get(n)
        if m is not None:
            _sum_role_series(m, role, summed)
    samples = [[name, {"role": role, "code" if name.endswith("_total") else "le": lv}, value]
               for (name, lv), value in sorted(summed.items())]

    alerts_state: list[dict] = []
    slos_state: dict = {}
    eng = getattr(alerts_mod, "_engine", None)
    if eng is not None:
        try:
            firing = dict(eng.firing)
            alerts_state = [
                {"alert": name, "severity": info.get("severity", "?")}
                for name, info in sorted(firing.items())
            ]
            slos_state = {
                name: dict(windows)
                for name, windows in getattr(eng, "_slo_burns", {}).items()
            }
        except Exception:
            pass

    return {
        "v": FRAME_VERSION,
        "node": node,
        "role": role,
        "proc": profiler.PROCESS_TOKEN,
        "ts": now,
        "seq": _next_seq(),
        "interval": float(interval),
        "usage": acct.export_sketches(),
        "samples": samples,
        "alerts": alerts_state,
        "slos": slos_state,
    }


class TelemetryPusher:
    """Background frame shipper for roles with no existing master link
    (S3, webdav). POSTs build_frame() to {master}/cluster/telemetry every
    `interval`, re-targeting to the leader the response names (same
    redirect discipline as the volume heartbeat). Push failures are
    swallowed — the aggregator's staleness tracking IS the alert for a
    sender that cannot reach the master."""

    def __init__(self, role: str, node, master_url: str,
                 interval: float = DEFAULT_INTERVAL, registry=None):
        self.role = role
        self._node = node  # str or zero-arg callable (port known late)
        self.master_url = master_url.rstrip("/")
        self.interval = float(interval)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.pushed = 0
        self.errors = 0

    def node(self) -> str:
        n = self._node
        return n() if callable(n) else n

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def push_once(self) -> bool:
        try:
            frame = build_frame(self.role, self.node(),
                                interval=self.interval,
                                registry=self._registry)
            # the port's client: an `https` master (process mTLS) gets
            # the client certificate, as every other hop does
            from seaweedfs_tpu_torch.server.httpd import http_request

            status, _hdrs, body = http_request(
                "POST", self.master_url + "/cluster/telemetry",
                json.dumps(frame).encode(),
                {"Content-Type": "application/json"}, timeout=5,
            )
            if status >= 400:
                raise IOError(f"telemetry push -> {status}")
            out = json.loads(body or b"{}")
            leader = (out.get("leader") or "").rstrip("/")
            if leader and leader != self.master_url:
                self.master_url = leader
            self.pushed += 1
            return True
        except Exception:
            self.errors += 1
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()


class _Sender:
    """Per-sender ingest state: identity, freshness, last sketches/edges,
    and a bounded ring per counter series (receiver-clock timestamps, so
    sender clock skew cannot corrupt window math)."""

    __slots__ = ("node", "role", "proc", "ts", "rx", "seq", "interval",
                 "frame_bytes", "usage", "alerts", "slos", "series",
                 "frames")

    def __init__(self, node: str):
        self.node = node
        self.role = ""
        self.proc = ""
        self.ts = 0.0      # sender's own clock (age diagnostics only)
        self.rx = 0.0      # receiver clock at last accepted frame
        self.seq = None
        self.interval = DEFAULT_INTERVAL
        self.frame_bytes = 0
        self.usage: dict = {}
        self.alerts: list = []
        self.slos: dict = {}
        self.series: dict[tuple, deque] = {}
        self.frames = 0


class TelemetryAggregator:
    """Leader-master merge point for telemetry frames (see module doc).

    Implements the slice of the MetricsHistory interface that
    alerts.slo_burn / alerts._sum_rates consume — `rates()` and
    `latests()` — over the merged per-sender series, so the
    multi-window burn rules run UNCHANGED against the cluster stream.

    Dedup rules for single-process test clusters (and any co-located
    deployment): usage sketches dedup by `proc` (the UsageAccountant is a
    process singleton — a filer and an S3 gateway sharing a process ship
    identical sketches), counter series dedup by `(proc, role)` (frames
    are role-filtered at build time, so co-located roles ship disjoint
    series; two same-role services in one process collapse to one)."""

    def __init__(self, params: dict | None = None, slots: int = 120,
                 stale_factor: float = 3.0, expire_seconds: float = 900.0,
                 top_n: int = 16):
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod

        p = dict(alerts_mod.DEFAULT_PARAMS)
        p.update(params or {})
        self.params = p
        self.slots = int(slots)
        self.stale_factor = float(stale_factor)
        self.expire_seconds = float(expire_seconds)
        self.top_n = int(top_n)
        self._lock = threading.RLock()
        self._senders: dict[str, _Sender] = {}
        self.frames_total = 0
        self.frames_rejected = 0
        self.bytes_total = 0
        self.merge_seconds = 0.0   # cumulative ingest cost (bench)
        self.firing: dict[str, dict] = {}
        self._last_eval = 0.0

    # --- ingest ---------------------------------------------------------------
    def ingest(self, frame, now: float | None = None) -> bool:
        """Merge one frame. Returns False (and counts a rejection) on a
        malformed or replayed frame — a bad sender must never poison the
        cluster view."""
        t0 = time.perf_counter()
        now = time.time() if now is None else now
        try:
            ok = self._ingest(frame, now)
        except Exception:
            ok = False
        with self._lock:
            self.merge_seconds += time.perf_counter() - t0
            if ok:
                self.frames_total += 1
            else:
                self.frames_rejected += 1
        return ok

    def _ingest(self, frame, now: float) -> bool:
        if not isinstance(frame, dict):
            return False
        node = frame.get("node")
        role = frame.get("role")
        if not isinstance(node, str) or not node \
                or not isinstance(role, str) or not role:
            return False
        ts = frame.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts):
            return False
        proc = str(frame.get("proc") or "")
        seq = frame.get("seq")
        seq = int(seq) if isinstance(seq, (int, float)) else None
        with self._lock:
            s = self._senders.get(node)
            if s is None:
                s = self._senders[node] = _Sender(node)
            elif (seq is not None and s.seq is not None
                    and proc == s.proc and seq <= s.seq):
                return False  # replay / out-of-order duplicate
            if proc != s.proc:
                # restart: cumulative counters reset; counter_rate's
                # reset-clamp handles the value drop, keep the rings
                s.proc = proc
            s.role = role
            s.ts = float(ts)
            s.rx = now
            s.seq = seq
            s.frames += 1
            iv = frame.get("interval")
            if isinstance(iv, (int, float)) and 0 < iv < 3600:
                s.interval = float(iv)
            try:
                s.frame_bytes = len(json.dumps(frame))
            except Exception:
                s.frame_bytes = 0
            self.bytes_total += s.frame_bytes
            usage = frame.get("usage")
            if isinstance(usage, dict):
                s.usage = usage
            s.alerts = [a for a in (frame.get("alerts") or ())
                        if isinstance(a, dict)]
            s.slos = frame.get("slos") if isinstance(
                frame.get("slos"), dict) else {}
            for row in frame.get("samples") or ():
                try:
                    fam, labels, value = row
                    value = float(value)
                except Exception:
                    continue
                if not isinstance(labels, dict) or not math.isfinite(value):
                    continue
                key = (str(fam), tuple(sorted(
                    (str(k), str(v)) for k, v in labels.items())))
                dq = s.series.get(key)
                if dq is None:
                    dq = s.series[key] = deque(maxlen=self.slots)
                dq.append((now, value))
        return True

    # --- sender views ---------------------------------------------------------
    def _live(self, now: float) -> list[_Sender]:
        return [s for s in self._senders.values()
                if now - s.rx <= self.expire_seconds]

    def _counter_senders(self, now: float) -> list[_Sender]:
        """Live senders, deduped by (proc, role) — newest frame wins."""
        best: dict[tuple, _Sender] = {}
        for s in self._live(now):
            key = (s.proc or s.node, s.role)
            cur = best.get(key)
            if cur is None or s.rx > cur.rx:
                best[key] = s
        return list(best.values())

    def stale_senders(self, now: float | None = None) -> dict[str, float]:
        """{node: age_seconds} for every live sender past 3x its own
        declared interval — a gateway that stops reporting is a finding."""
        now = time.time() if now is None else now
        out = {}
        with self._lock:
            for s in self._live(now):
                age = now - s.rx
                if age > self.stale_factor * max(s.interval, 1.0):
                    out[s.node] = age
        return out

    # --- the history duck-type alerts.slo_burn consumes -----------------------
    def rates(self, family: str, window: float, now: float | None = None):
        """[(labels, rate|None)] across deduped senders' series — same
        shape MetricsHistory.rates returns, so _sum_rates and the latency
        per-bound summation work unchanged over the merged stream."""
        from seaweedfs_tpu_torch.stats.history import counter_rate

        now = time.time() if now is None else now
        out = []
        with self._lock:
            for s in self._counter_senders(now):
                for (fam, litems), dq in s.series.items():
                    if fam != family:
                        continue
                    out.append((dict(litems),
                                counter_rate(list(dq), window, now)))
        return out

    def latests(self, family: str, require_current: bool = True):
        """[(labels, value, ts)] — last sample per deduped series."""
        now = time.time()
        out = []
        with self._lock:
            for s in self._counter_senders(now):
                if require_current and now - s.rx > \
                        self.stale_factor * max(s.interval, 1.0):
                    continue
                for (fam, litems), dq in s.series.items():
                    if fam != family or not dq:
                        continue
                    t, v = dq[-1]
                    out.append((dict(litems), v, t))
        return out

    # --- merged tenant usage --------------------------------------------------
    def merged_usage(self, n: int | None = None,
                     now: float | None = None) -> dict:
        """Cluster-wide tenant view: per-dimension SpaceSaving.merge over
        one sketch per process (dedup by proc — co-located roles share an
        accountant), with the composed error bound exported alongside."""
        now = time.time() if now is None else now
        n = self.top_n if n is None else n
        with self._lock:
            best: dict[str, _Sender] = {}
            for s in self._live(now):
                if not s.usage:
                    continue
                key = s.proc or s.node
                cur = best.get(key)
                if cur is None or s.rx > cur.rx:
                    best[key] = s
            sketches = [s.usage for s in best.values()]
        merged: dict[str, usage_mod.SpaceSaving] = {}
        for dim in ("requests", "bytes_in", "bytes_out", "errors"):
            sk = None
            for u in sketches:
                d = u.get(dim)
                if not isinstance(d, dict):
                    continue
                part = usage_mod.SpaceSaving.from_dict(d)
                sk = part if sk is None else sk.merge(part)
            merged[dim] = sk if sk is not None \
                else usage_mod.SpaceSaving(usage_mod.DEFAULT_K)
        rows: dict[str, dict] = {}
        for dim, sk in merged.items():
            for key, count, err in sk.top():
                row = rows.setdefault(key, {"collection": key})
                row[dim] = count
                row[dim + "_err"] = err
        ranked = sorted(rows.values(), key=lambda r: -r.get("requests", 0.0))
        req = merged["requests"]
        return {
            "tenants": ranked[:n] if n is not None else ranked,
            "other": {dim: sk.other for dim, sk in merged.items()},
            "error_bound": req.error_bound,
            "evictions": req.evictions,
            "tracked": len(req.counts),
            "processes": len(sketches),
        }

    # --- cluster rules --------------------------------------------------------
    def burn_rows(self, now: float | None = None) -> list[dict]:
        """Merged-stream burn per (slo, window) — the burn rules' inputs
        and the SeaweedFS_cluster_slo_burn_rate gauge."""
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod

        now = time.time() if now is None else now
        p = self.params
        rows = []
        for slo in p.get("slos") or ():
            for window in (p["slo_fast_window"], p["slo_slow_window"]):
                burn = alerts_mod.slo_burn(self, slo, window, now)
                if burn is None:
                    continue
                rows.append({"slo": slo.name, "window": window,
                             "burn": burn})
        return rows

    def evaluate(self, now: float | None = None) -> dict:
        """Run the cluster rules over the merged stream; update firing
        state with rising/clearing edges into the flight recorder (same
        alert_raised/alert_cleared events the per-process engine emits,
        so cluster.why brackets cluster incidents too)."""
        from seaweedfs_tpu_torch.stats import alerts as alerts_mod
        from seaweedfs_tpu_torch.stats import events as events_mod

        now = time.time() if now is None else now
        p = self.params
        results: dict[str, tuple[float, str]] = {}
        res = alerts_mod._check_slo_fast_burn(self, now, p)
        if res is not None:
            results["cluster_slo_burn_fast"] = res
        res = alerts_mod._check_slo_slow_burn(self, now, p)
        if res is not None:
            results["cluster_slo_burn_slow"] = res
        stale = self.stale_senders(now)
        if stale:
            worst = max(stale.values())
            detail = ", ".join(
                f"{node} silent {age:.0f}s"
                for node, age in sorted(stale.items()))
            results["cluster_telemetry_stale"] = (
                worst, f"telemetry senders gone quiet: {detail}")
        severities = dict(CLUSTER_RULES)
        rising, cleared = [], []
        with self._lock:
            for name, _sev in CLUSTER_RULES:
                res = results.get(name)
                cur = self.firing.get(name)
                if res is None:
                    if cur is not None:
                        cleared.append((name, dict(cur)))
                        del self.firing[name]
                    continue
                value, detail = res
                if cur is None:
                    info = {"severity": severities[name], "since": now,
                            "value": value, "detail": detail}
                    self.firing[name] = info
                    rising.append((name, dict(info)))
                else:
                    cur["value"] = value
                    cur["detail"] = detail
            snapshot = {k: dict(v) for k, v in self.firing.items()}
            self._last_eval = time.time()
        for name, info in rising:
            events_mod.emit("alert_raised", alert=name,
                            severity=info.get("severity", "?"),
                            detail=str(info.get("detail", ""))[:200])
        for name, info in cleared:
            events_mod.emit("alert_cleared", alert=name,
                            severity=info.get("severity", "?"),
                            after_s=round(now - info.get("since", now), 2))
        return snapshot

    def _maybe_evaluate(self) -> None:
        if time.time() - self._last_eval > 1.0:
            self.evaluate()

    # --- export ---------------------------------------------------------------
    def snapshot(self, n: int | None = None,
                 now: float | None = None) -> dict:
        """The GET /debug/cluster/telemetry body: the one fetch."""
        now = time.time() if now is None else now
        alerts_firing = self.evaluate(now)
        usage = self.merged_usage(n=n, now=now)
        rates: dict[str, dict] = {}
        for labels, rate in self.rates(
                "SeaweedFS_http_request_total", self.params["window"], now):
            if rate is None:
                continue
            role = labels.get("role", "?")
            row = rates.setdefault(role, {"req_rate": 0.0, "err_rate": 0.0})
            row["req_rate"] += rate
            if labels.get("code", "").startswith("5"):
                row["err_rate"] += rate
        stale = self.stale_senders(now)
        with self._lock:
            senders = {
                s.node: {
                    "role": s.role, "proc": s.proc, "seq": s.seq,
                    "interval": s.interval, "frames": s.frames,
                    "frame_bytes": s.frame_bytes,
                    "last_rx": round(s.rx, 3),
                    "frame_ts": round(s.ts, 3),
                    "age": round(now - s.rx, 3),
                    "stale": s.node in stale,
                    "alerts": list(s.alerts),
                }
                for s in self._live(now)
            }
            totals = {
                "frames_total": self.frames_total,
                "frames_rejected": self.frames_rejected,
                "bytes_total": self.bytes_total,
                "merge_seconds": round(self.merge_seconds, 6),
            }
        return {
            "ts": now,
            "senders": senders,
            "usage": usage,
            "rates": rates,
            "slos": self.burn_rows(now),
            "alerts": alerts_firing,
            "windows": {"fast": self.params["slo_fast_window"],
                        "slow": self.params["slo_slow_window"]},
            **totals,
        }

    def lines(self) -> list[str]:
        """Prometheus text-format lines (Collector fn on the master)."""
        from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, _fmt_value

        self._maybe_evaluate()
        now = time.time()
        out: list[str] = []
        usage = self.merged_usage(now=now)
        fam_by_dim = {
            "requests": "SeaweedFS_cluster_usage_requests_total",
            "bytes_in": "SeaweedFS_cluster_usage_bytes_in_total",
            "bytes_out": "SeaweedFS_cluster_usage_bytes_out_total",
            "errors": "SeaweedFS_cluster_usage_errors_total",
        }
        for dim, fam in fam_by_dim.items():
            out.append(f"# TYPE {fam} counter")
            for row in usage["tenants"]:
                if dim not in row:
                    continue
                lbl = _fmt_labels(("collection",), (row["collection"],))
                out.append(f"{fam}{lbl} {_fmt_value(row[dim])}")
            other = usage["other"].get(dim, 0.0)
            if other > 0:
                lbl = _fmt_labels(("collection",), (usage_mod.OTHER,))
                out.append(f"{fam}{lbl} {_fmt_value(other)}")
        out.append("# TYPE SeaweedFS_cluster_usage_error_bound gauge")
        out.append("SeaweedFS_cluster_usage_error_bound "
                   f"{_fmt_value(usage['error_bound'])}")
        out.append("# TYPE SeaweedFS_cluster_usage_tracked_collections gauge")
        out.append("SeaweedFS_cluster_usage_tracked_collections "
                   f"{usage['tracked']}")
        out.append("# TYPE SeaweedFS_cluster_slo_burn_rate gauge")
        for row in self.burn_rows(now):
            lbl = _fmt_labels(("slo", "window"),
                              (row["slo"], f"{row['window']:g}"))
            out.append(
                f"SeaweedFS_cluster_slo_burn_rate{lbl}"
                f" {_fmt_value(row['burn'])}")
        role_rates: dict[str, dict] = {}
        for labels, rate in self.rates(
                "SeaweedFS_http_request_total", self.params["window"], now):
            if rate is None:
                continue
            role = labels.get("role", "?")
            row = role_rates.setdefault(role, {"req": 0.0, "err": 0.0})
            row["req"] += rate
            if labels.get("code", "").startswith("5"):
                row["err"] += rate
        out.append("# TYPE SeaweedFS_cluster_request_rate gauge")
        out.append("# TYPE SeaweedFS_cluster_error_rate gauge")
        for role, row in sorted(role_rates.items()):
            lbl = _fmt_labels(("role",), (role,))
            out.append(
                f"SeaweedFS_cluster_request_rate{lbl}"
                f" {_fmt_value(row['req'])}")
            out.append(
                f"SeaweedFS_cluster_error_rate{lbl}"
                f" {_fmt_value(row['err'])}")
        stale = self.stale_senders(now)
        with self._lock:
            live = self._live(now)
            out.append("# TYPE SeaweedFS_cluster_telemetry_stale gauge")
            out.append("# TYPE SeaweedFS_cluster_telemetry_frame_age_seconds"
                       " gauge")
            for s in sorted(live, key=lambda s: s.node):
                lbl = _fmt_labels(("node",), (s.node,))
                out.append("SeaweedFS_cluster_telemetry_stale"
                           f"{lbl} {1 if s.node in stale else 0}")
                out.append("SeaweedFS_cluster_telemetry_frame_age_seconds"
                           f"{lbl} {_fmt_value(max(0.0, now - s.rx))}")
            out.append("# TYPE SeaweedFS_cluster_telemetry_senders gauge")
            out.append(f"SeaweedFS_cluster_telemetry_senders {len(live)}")
            out.append("# TYPE SeaweedFS_cluster_telemetry_frames_total"
                       " counter")
            out.append("SeaweedFS_cluster_telemetry_frames_total "
                       f"{self.frames_total}")
            out.append("# TYPE SeaweedFS_cluster_alerts_firing gauge")
            for name, info in sorted(self.firing.items()):
                lbl = _fmt_labels(("alert", "severity"),
                                  (name, info.get("severity", "?")))
                out.append(f"SeaweedFS_cluster_alerts_firing{lbl} 1")
        return out
