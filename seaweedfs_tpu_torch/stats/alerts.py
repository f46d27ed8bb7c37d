"""Declarative rate-based alerting over the metrics history ring.

`cluster.check` can see a read-only volume; it cannot see an error-ratio
climbing, a heartbeat going stale between manual checks, or a disk
filling overnight. The `AlertEngine` evaluates a fixed set of declarative
rules (stats/history.py windowed rates + freshest gauge values) after
every history scrape, keeps per-rule firing state with rising-edge
counters, and exports it three ways:

  * `SeaweedFS_alerts_firing{alert,severity}` 0/1 on `/metrics` through a
    Registry collector (so an external Prometheus — and `cluster.check`,
    which scrapes every node — sees the state with zero extra plumbing),
    plus `SeaweedFS_alerts_fired_total{alert,severity}` rising edges;
  * `GET /debug/alerts` (server/httpd) — full JSON with value + detail;
  * `cluster.check -fail` exits nonzero on any firing *critical* alert,
    and `cluster.top` renders the firing set live.

Rules are plain (name, severity, description, check) records — the check
gets (history, now, params) and returns None or (value, detail). Names
ride into the `alert` label, so `tools/check_metric_names.py` lints them
like metric names. Thresholds live in one `params` dict
(`engine().configure(...)` to tune).
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch.stats import history as history_mod
from seaweedfs_tpu_torch.stats.metrics import _fmt_labels, default_registry

ALERT_FAMILIES = ("SeaweedFS_alerts_firing",)
SLO_FAMILIES = ("SeaweedFS_slo_burn_rate",)


class Slo:
    """One declarative service-level objective, evaluated off the history
    ring into an error-budget burn rate per window:

      * kind="availability": objective = success ratio (0.999 -> 0.1%
        error budget); burn = (5xx share of the role's requests) /
        (1 - objective).
      * kind="latency": objective = the quantile (0.99) that must land
        within `threshold_s`; burn = (share of requests slower than the
        threshold) / (1 - objective). The threshold snaps to a histogram
        bucket bound, so the share is exact, not interpolated.

    A burn rate of 1.0 spends the budget exactly at the sustainable
    rate; 14x over the fast window pages (the multi-window burn-rate
    discipline from the SRE workbook, scaled to the ring's retention)."""

    __slots__ = ("name", "role", "kind", "objective", "threshold_s",
                 "description")

    def __init__(self, name: str, role: str, kind: str, objective: float,
                 threshold_s: float = 0.0, description: str = ""):
        self.name = name
        self.role = role
        self.kind = kind
        self.objective = float(objective)
        self.threshold_s = float(threshold_s)
        self.description = description


DEFAULT_SLOS = (
    Slo("master_availability", "master", "availability", 0.999,
        description="99.9% of master control-plane requests succeed"),
    Slo("volume_availability", "volume", "availability", 0.999,
        description="99.9% of volume data-plane requests succeed"),
    Slo("filer_availability", "filer", "availability", 0.999,
        description="99.9% of filer requests succeed"),
    Slo("s3_availability", "s3", "availability", 0.999,
        description="99.9% of s3 gateway requests succeed"),
    Slo("volume_read_p99", "volume", "latency", 0.99, threshold_s=0.25,
        description="99% of volume requests complete within 250ms"),
    Slo("filer_p99", "filer", "latency", 0.99, threshold_s=0.5,
        description="99% of filer requests complete within 500ms"),
)


# minimum request rate (req/s over the window) below which a burn rate
# is not computed at all: with a handful of samples, one slow cold-start
# request IS the p99 and "burns" 100x for the whole window — which the
# QoS actuator would dutifully answer by shedding every write on an
# otherwise idle cluster. Same idea as error_min_rate for
# http_error_ratio: don't judge an SLO on statistical noise. Latency
# needs the higher floor: under ~1 req/s a window can't tell a p99
# violation from a p67 one, while availability error shares stay
# meaningful at lower traffic (mirroring error_min_rate = 0.5).
SLO_MIN_RATE = {"availability": 0.5, "latency": 1.0}


def slo_burn(hist, slo: Slo, window: float, now: float,
             min_rate: float | None = None):
    """Error-budget burn rate for one SLO over one window -> float | None
    (None = not enough traffic/samples to judge, distinct from 0.0)."""
    if min_rate is None:
        min_rate = SLO_MIN_RATE.get(slo.kind, 0.0)
    budget = 1.0 - slo.objective
    if budget <= 0:
        return None
    if slo.kind == "availability":
        total = _sum_rates(
            hist, "SeaweedFS_http_request_total", window, now,
            match=lambda l: l.get("role") == slo.role,
        )
        if not total or total < min_rate:
            return None
        errs = _sum_rates(
            hist, "SeaweedFS_http_request_total", window, now,
            match=lambda l: (l.get("role") == slo.role
                             and l.get("code", "").startswith("5")),
        ) or 0.0
        return (errs / total) / budget
    # latency: cumulative bucket rates keep the cumulative shape (rate of
    # cumulative is cumulative of rates), so the share of requests slower
    # than the threshold bound is (total - cum_at_bound) / total
    per_bound: dict[float, float] = {}
    for labels, rate in hist.rates(
        "SeaweedFS_http_request_seconds_bucket", window, now
    ):
        if rate is None or labels.get("role") != slo.role:
            continue
        le = labels.get("le", "")
        bound = float("inf") if le == "+Inf" else float(le)
        per_bound[bound] = per_bound.get(bound, 0.0) + rate
    total = per_bound.get(float("inf"))
    if not total or total < min_rate:
        return None
    candidates = [b for b in per_bound
                  if b != float("inf") and b >= slo.threshold_s - 1e-12]
    good = per_bound[min(candidates)] if candidates else total
    slow_share = max(0.0, total - good) / total
    return slow_share / budget


DEFAULT_PARAMS = {
    # evaluation window (seconds) for every rate-based rule
    "window": 60.0,
    # http_error_ratio: 5xx share of all requests, with a minimum absolute
    # 5xx rate so three stray 500s in a quiet minute don't page anyone
    "error_ratio": 0.05,
    "error_min_rate": 0.5,
    # disk_near_cap: percent of a data directory's filesystem in use
    "disk_capacity_pct": 95.0,
    # metrics_push_errors: any sustained push failure is worth a warning
    "push_error_rate": 0.0,
    # trace_ring_drops: eviction churn this fast means the ring is blind
    "trace_drop_rate": 100.0,
    # fastlane_fallback: sustained PATHOLOGICAL front-door fallbacks per
    # second (no_lease / lease_spent / backpressure / upstream) — expected
    # gate traffic (cache misses, query reads, auth'd requests) never
    # counts. r05's silently-rejected filer lease is the motivating case.
    "fastlane_fallback_rate": 1.0,
    # ec_pipeline_starved: a stage waiting this many times longer than it
    # works (and at all meaningfully) is starved by its neighbor
    "starvation_wait_ratio": 3.0,
    "starvation_min_wait": 0.05,
    # degraded_reads: needle reads surviving only through EC
    # reconstruction / alternate sources at this sustained rate mean a
    # fault is in flight (torn .dat, lost shard/holder) — the reads
    # succeed, which is exactly why nothing else pages
    "degraded_read_rate": 0.5,
    # scrub_findings: ANY sustained rate of proved silent damage warns —
    # reads still succeed, so nothing else would page for bitrot
    "scrub_finding_rate": 0.0,
    # capacity_forecast: page on the stats/heat.py days-to-full fit —
    # warning gives humans time to add capacity, critical means the
    # fill will win within an operational window. The gauge only exists
    # while the fill slope is positive, so deleting data clears both.
    "forecast_warn_days": 14.0,
    "forecast_crit_days": 3.0,
    # telemetry_spool_near_cap: a durable-telemetry tier (stats/store.py)
    # holding this share of its byte cap is about to evict (or already
    # evicting) its oldest segments — retention is now bounded by
    # -telemetry.retention, not by time; raise it to keep more history
    "telemetry_spool_ratio": 0.9,
    # SLO multi-window burn-rate alerting: the fast window pages on an
    # incident spending the error budget 14x faster than sustainable
    # (critical, self-clears once the burst ages out of the window); the
    # slow window warns on a 3x sustained burn, gated on the fast window
    # still showing burn >= 1 so a long-resolved incident stops warning.
    "slo_fast_window": 60.0,
    "slo_slow_window": 300.0,
    "slo_fast_burn": 14.0,
    "slo_slow_burn": 3.0,
    # the SLO set itself is a param so deployments (and tests/bench) can
    # swap objectives without subclassing the engine
    "slos": DEFAULT_SLOS,
    # qos_shed_interactive: the HIGHEST priority class being shed at a
    # sustained rate is an incident, never policy — the qos actuator
    # sheds background, then writes, and only a tenant's own exhausted
    # bucket (or an explicit operator floor) touches interactive
    "qos_interactive_shed_rate": 0.5,
}


class Rule:
    """One declarative alert rule. `check(history, now, params)` returns
    None (not firing) or (value, detail)."""

    __slots__ = ("name", "severity", "description", "check")

    def __init__(self, name: str, severity: str, description: str, check):
        self.name = name
        self.severity = severity
        self.description = description
        self.check = check


def _sum_rates(hist, family: str, window: float, now: float, match=None):
    """Sum of windowed rates across a family's series (None when no
    series has enough samples — distinct from a true 0.0 rate)."""
    total = None
    for labels, rate in hist.rates(family, window, now):
        if rate is None:
            continue
        if match is not None and not match(labels):
            continue
        total = (total or 0.0) + rate
    return total


def _check_http_error_ratio(hist, now, p):
    w = p["window"]
    total = _sum_rates(hist, "SeaweedFS_http_request_total", w, now)
    if not total:
        return None
    errs = _sum_rates(
        hist, "SeaweedFS_http_request_total", w, now,
        match=lambda l: l.get("code", "").startswith("5"),
    ) or 0.0
    ratio = errs / total
    if errs > p["error_min_rate"] and ratio > p["error_ratio"]:
        return ratio, (
            f"{errs:.2f}/s of {total:.2f}/s requests are 5xx"
            f" ({ratio:.1%} > {p['error_ratio']:.0%})"
        )
    return None


def _check_heartbeat_stale(hist, now, p):
    # the master's stale gauge already encodes its 3x-pulse threshold;
    # latests(require_current) ignores a stopped master's leftovers
    ages = {
        l.get("node", ""): v
        for l, v, _ in hist.latests("SeaweedFS_master_heartbeat_age_seconds")
    }
    stale = []
    for labels, value, _ in hist.latests("SeaweedFS_master_stale_heartbeats"):
        if value > 0:
            node = labels.get("node", "?")
            stale.append((node, ages.get(node, value)))
    if not stale:
        return None
    worst = max(age for _, age in stale)
    return worst, "stale heartbeat from " + ", ".join(
        f"{node} ({age:.1f}s)" for node, age in sorted(stale)
    )


def _check_disk_near_cap(hist, now, p):
    used = {
        tuple(sorted(l.items())): v
        for l, v, _ in hist.latests("SeaweedFS_volume_disk_used_bytes")
    }
    details, worst = [], None
    for labels, free, _ in hist.latests("SeaweedFS_volume_disk_free_bytes"):
        u = used.get(tuple(sorted(labels.items())))
        if u is None or u + free <= 0:
            continue
        pct = 100.0 * u / (u + free)
        if pct >= p["disk_capacity_pct"]:
            details.append(
                f"{labels.get('server', '?')} {labels.get('dir', '?')}"
                f" {pct:.1f}% used"
            )
            worst = max(worst or 0.0, pct)
    if not details:
        return None
    return worst, "disk near capacity: " + "; ".join(sorted(details))


def _check_push_errors(hist, now, p):
    rate = _sum_rates(
        hist, "SeaweedFS_stats_push_errors_total", p["window"], now
    )
    if rate is not None and rate > p["push_error_rate"]:
        return rate, f"metrics pushes failing at {rate:.2f}/s"
    return None


def _check_trace_drops(hist, now, p):
    rate = _sum_rates(
        hist, "SeaweedFS_stats_trace_dropped_total", p["window"], now
    )
    if rate is not None and rate > p["trace_drop_rate"]:
        return rate, (
            f"trace ring dropping {rate:.0f} spans/s"
            " (capacity churn — raise SEAWEEDFS_TPU_TRACE_CAPACITY?)"
        )
    return None


def _check_fastlane_fallback(hist, now, p):
    """A front-door engine silently falling back to the Python path for a
    BROKEN reason (the filer lease rejected/spent, drain backpressure, the
    upstream volume hop failing) — distinct from expected gate fallbacks
    like cache misses or auth'd requests, which are business as usual."""
    from ..storage.fastlane import PATHOLOGICAL_REASONS

    bad = set(PATHOLOGICAL_REASONS)
    details, worst = [], None
    for family, role in (
        ("SeaweedFS_filer_fastlane_fallback_total", "filer"),
        ("SeaweedFS_s3_fastlane_fallback_total", "s3"),
    ):
        per_reason: dict[str, float] = {}
        for labels, rate in hist.rates(family, p["window"], now):
            if rate is None or labels.get("reason", "") not in bad:
                continue
            r = labels.get("reason", "?")
            per_reason[r] = per_reason.get(r, 0.0) + rate
        total = sum(per_reason.values())
        if total > p["fastlane_fallback_rate"]:
            top = max(per_reason.items(), key=lambda kv: kv[1])
            details.append(
                f"{role} falling back at {total:.1f}/s"
                f" (mostly '{top[0]}')"
            )
            worst = max(worst or 0.0, total)
    if not details:
        return None
    return worst, "; ".join(details)


def _check_degraded_reads(hist, now, p):
    """Reads are SUCCEEDING through reconstruction — client dashboards
    stay green while redundancy quietly absorbs a fault. A sustained
    rate is the signal the maintenance daemon's heal should already be
    racing; per-reason breakdown rides in the detail."""
    per_reason: dict[str, float] = {}
    for labels, rate in hist.rates(
        "SeaweedFS_volume_degraded_reads_total", p["window"], now
    ):
        if rate is None or rate <= 0:
            continue
        r = labels.get("reason", "?")
        per_reason[r] = per_reason.get(r, 0.0) + rate
    total = sum(per_reason.values())
    if total <= p["degraded_read_rate"]:
        return None
    top = max(per_reason.items(), key=lambda kv: kv[1])
    return total, (
        f"reads degrading at {total:.2f}/s (mostly '{top[0]}') —"
        f" a fault is being absorbed by EC reconstruction"
    )


def _check_scrub_findings(hist, now, p):
    """An integrity scrub pass proved SILENT damage (bitrot, torn shard,
    diverged replica) — nothing else will page for it, because reads are
    still succeeding. The maintenance daemon's on_fire hook races a
    scrub repair scan off this edge."""
    per_kind: dict[str, float] = {}
    for labels, rate in hist.rates(
        "SeaweedFS_volume_scrub_findings_total", p["window"], now
    ):
        if rate is None or rate <= 0:
            continue
        k = labels.get("kind", "?")
        per_kind[k] = per_kind.get(k, 0.0) + rate
    total = sum(per_kind.values())
    if total <= p["scrub_finding_rate"]:
        return None
    top = max(per_kind.items(), key=lambda kv: kv[1])
    return total, (
        f"scrub detecting silent damage at {total:.2f} finding(s)/s"
        f" (mostly '{top[0]}')"
    )


def _check_ec_starved(hist, now, p):
    per_stage: dict[str, dict] = {}
    for labels, rate in hist.rates(
        "SeaweedFS_volume_ec_pipeline_seconds_sum", p["window"], now
    ):
        if rate is None:
            continue
        st = per_stage.setdefault(labels.get("stage", "?"), {})
        state = labels.get("state", "")
        st[state] = st.get(state, 0.0) + rate
    starved, worst = [], None
    for stage, st in sorted(per_stage.items()):
        busy = st.get("busy", 0.0)
        wait = st.get("wait", 0.0)
        if wait > p["starvation_min_wait"] and \
                wait > p["starvation_wait_ratio"] * busy:
            starved.append(f"{stage} (busy {busy:.2f}s/s, wait {wait:.2f}s/s)")
            worst = max(worst or 0.0, wait)
    if not starved:
        return None
    return worst, "EC pipeline stage starving: " + ", ".join(starved)


def _check_slo_fast_burn(hist, now, p):
    """An incident is spending the error budget an order of magnitude
    faster than sustainable RIGHT NOW — the paging signal."""
    worst, details = None, []
    for slo in p.get("slos") or ():
        burn = slo_burn(hist, slo, p["slo_fast_window"], now)
        if burn is not None and burn > p["slo_fast_burn"]:
            details.append(
                f"{slo.name} burning {burn:.0f}x its error budget"
                f" over {p['slo_fast_window']:g}s"
            )
            worst = max(worst or 0.0, burn)
    if not details:
        return None
    return worst, "; ".join(details)


def _check_slo_slow_burn(hist, now, p):
    """A sustained slow leak of the error budget; the fast-window gate
    (burn >= 1) keeps a long-resolved incident from warning forever
    while its errors age out of the slow window."""
    worst, details = None, []
    for slo in p.get("slos") or ():
        slow = slo_burn(hist, slo, p["slo_slow_window"], now)
        if slow is None or slow <= p["slo_slow_burn"]:
            continue
        fast = slo_burn(hist, slo, p["slo_fast_window"], now)
        if fast is None or fast < 1.0:
            continue
        details.append(
            f"{slo.name} burning {slow:.1f}x its error budget"
            f" over {p['slo_slow_window']:g}s (still burning)"
        )
        worst = max(worst or 0.0, slow)
    if not details:
        return None
    return worst, "; ".join(details)


def _check_capacity_forecast_at(hist, now, p, horizon_days):
    """Shared body of the capacity_forecast pair: any node/dir whose
    days-to-full fit (stats/heat.py) undercuts the horizon."""
    details, worst = [], None
    for labels, days, _ in hist.latests("SeaweedFS_node_days_to_full"):
        if days < 0 or days > horizon_days:
            continue
        details.append(
            f"{labels.get('node', '?')} {labels.get('dir', '?')}"
            f" full in {days:.1f}d"
        )
        # "worst" = soonest-to-full, but evaluate() keeps the max value;
        # report the horizon shortfall so bigger means worse
        worst = max(worst or 0.0, horizon_days - days)
    if not details:
        return None
    return worst, "capacity forecast: " + "; ".join(sorted(details))


def _check_telemetry_spool(hist, now, p):
    """Any durable-telemetry tier (stats/store.py) holding >= the ratio
    of its byte cap: oldest-segment eviction is imminent (or running),
    so retention is byte-bounded — an ops heads-up, like the capacity
    forecast, not an incident page."""
    caps = {
        labels.get("tier", ""): v
        for labels, v, _ in hist.latests(
            "SeaweedFS_telemetry_spool_cap_bytes")
        if v > 0
    }
    details, worst = [], None
    for labels, used, _ in hist.latests("SeaweedFS_telemetry_spool_bytes"):
        cap = caps.get(labels.get("tier", ""))
        if not cap:
            continue
        ratio = used / cap
        if ratio < p["telemetry_spool_ratio"]:
            continue
        details.append(
            f"tier {labels.get('tier', '?')} at {ratio:.0%} of"
            f" {int(cap)}B cap")
        worst = max(worst or 0.0, ratio)
    if not details:
        return None
    return worst, ("telemetry spool near cap (oldest segments evict;"
                   " raise -telemetry.retention to keep more): "
                   + "; ".join(sorted(details)))


def _check_capacity_forecast(hist, now, p):
    return _check_capacity_forecast_at(hist, now, p, p["forecast_warn_days"])


def _check_capacity_forecast_critical(hist, now, p):
    return _check_capacity_forecast_at(hist, now, p, p["forecast_crit_days"])


def _check_qos_shed_interactive(hist, now, p):
    """Interactive (highest-class) requests being shed sustainedly: a
    tenant limit is starving foreground traffic or an operator lowered
    the interactive floor under real load. `cluster.check -fail` exits
    nonzero on this (criticals are problems)."""
    per_reason: dict[str, float] = {}
    for labels, rate in hist.rates("SeaweedFS_qos_shed_total",
                                   p["window"], now):
        if rate is None or labels.get("class") != "interactive":
            continue
        r = labels.get("reason", "?")
        per_reason[r] = per_reason.get(r, 0.0) + rate
    total = sum(per_reason.values())
    if total <= p["qos_interactive_shed_rate"]:
        return None
    top = max(per_reason.items(), key=lambda kv: kv[1])
    return total, (f"interactive requests shed at {total:.1f}/s"
                   f" (mostly '{top[0]}') — the highest priority class"
                   " must not shed sustainedly")


def default_rules() -> list[Rule]:
    return [
        Rule("http_error_ratio", "critical",
             "5xx share of HTTP requests over the window exceeds the"
             " threshold", _check_http_error_ratio),
        Rule("heartbeat_stale", "critical",
             "a volume server's master heartbeat is stale (3x pulse)",
             _check_heartbeat_stale),
        Rule("disk_near_cap", "critical",
             "a volume data directory's filesystem is nearly full",
             _check_disk_near_cap),
        Rule("metrics_push_errors", "warning",
             "pushes to the metrics gateway are failing",
             _check_push_errors),
        Rule("trace_ring_drops", "warning",
             "the trace ring is evicting spans faster than the threshold",
             _check_trace_drops),
        Rule("ec_pipeline_starved", "warning",
             "an EC pipeline stage spends far longer waiting than working",
             _check_ec_starved),
        Rule("fastlane_fallback", "warning",
             "a filer/S3 front door is falling back to the Python path"
             " for a pathological reason (lease, backpressure, upstream)",
             _check_fastlane_fallback),
        Rule("degraded_reads", "warning",
             "needle reads are being served through EC reconstruction"
             " at a sustained rate (a fault is in flight)",
             _check_degraded_reads),
        Rule("scrub_findings", "warning",
             "integrity scrub passes are detecting silent damage"
             " (bitrot, torn shards, diverged replicas)",
             _check_scrub_findings),
        Rule("telemetry_spool_near_cap", "warning",
             "a durable-telemetry spool tier is near its byte cap —"
             " oldest segments are being evicted (retention is now"
             " byte-bounded)", _check_telemetry_spool),
        Rule("capacity_forecast", "warning",
             "a data directory's fill trend reaches capacity within the"
             " warning horizon (days-to-full linear fit)",
             _check_capacity_forecast),
        Rule("capacity_forecast_critical", "critical",
             "a data directory's fill trend reaches capacity within the"
             " critical horizon — add capacity or shed data now",
             _check_capacity_forecast_critical),
        Rule("slo_burn_fast", "critical",
             "an SLO's error budget is burning faster than the fast-"
             "window threshold (incident in progress)",
             _check_slo_fast_burn),
        Rule("slo_burn_slow", "warning",
             "an SLO's error budget is burning at a sustained multiple"
             " over the slow window (and still burning now)",
             _check_slo_slow_burn),
        Rule("qos_shed_interactive", "critical",
             "admission control is shedding the highest priority class"
             " at a sustained rate (tenant limit starving foreground"
             " traffic, or the interactive floor was lowered)",
             _check_qos_shed_interactive),
    ]


class AlertEngine:
    """Evaluates rules against a MetricsHistory; keeps firing state;
    exports it as `SeaweedFS_alerts_firing` through a Registry collector.
    Attached as a history listener, so state refreshes on every scrape."""

    def __init__(self, history=None, rules=None, registry=None, params=None):
        self.history = (
            history if history is not None else history_mod.default_history()
        )
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.rules = list(default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {sorted(names)}")
        self.params = dict(DEFAULT_PARAMS)
        if params:
            self.params.update(params)
        self._lock = threading.Lock()
        self.firing: dict[str, dict] = {}  # name -> {severity,since,value,detail}
        self.fired_events = 0  # rising edges since process start
        # rising-edge listeners: fn(rule_name, info) called once per edge
        # (not while a rule keeps firing) — the maintenance daemon reacts
        # to disk_near_cap/heartbeat_stale through this hook
        self._on_fire: list = []
        self._last_eval = 0.0
        self._fired_total = self.registry.counter(
            "SeaweedFS_alerts_fired_total",
            "alert rising edges (rule transitioned to firing)",
            ("alert", "severity"),
        )
        self._collector = self.registry.register_collector(
            self._lines, names=ALERT_FAMILIES
        )
        # SLO error-budget burn gauges, refreshed on every evaluation —
        # the history ring self-scrapes these right back, so cluster.top
        # sees cluster-wide burn with zero extra plumbing
        self._slo_burns: dict[str, dict] = {}
        self._slo_collector = self.registry.register_collector(
            self._slo_lines, names=SLO_FAMILIES
        )
        self.history.add_listener(self._on_scrape)

    def close(self) -> None:
        self.history.remove_listener(self._on_scrape)
        self.registry.unregister_collector(self._collector)
        self.registry.unregister_collector(self._slo_collector)

    def configure(self, **params) -> None:
        """Tune thresholds (keys of DEFAULT_PARAMS)."""
        unknown = set(params) - set(DEFAULT_PARAMS)
        if unknown:
            raise ValueError(f"unknown alert params: {sorted(unknown)}")
        self.params.update(params)

    def add_on_fire(self, fn) -> None:
        """Subscribe to rising edges: fn(rule_name, info) fires once when a
        rule transitions to firing (info = {severity, since, value,
        detail}). Listeners run outside the engine lock, after the firing
        state is committed; a raising listener is swallowed (it must not
        take down the scrape that evaluated the rules)."""
        with self._lock:
            if fn not in self._on_fire:
                self._on_fire.append(fn)

    def remove_on_fire(self, fn) -> None:
        with self._lock:
            if fn in self._on_fire:
                self._on_fire.remove(fn)

    def _on_scrape(self, hist, now) -> None:
        self.evaluate(now=now)

    def _slo_update(self, now: float) -> None:
        """Recompute every SLO's fast/slow burn rate into the cache the
        collector and /debug/alerts serve (computed once per evaluation,
        not per scrape-time render)."""
        p = self.params
        burns: dict[str, dict] = {}
        for slo in p.get("slos") or ():
            try:
                fast = slo_burn(self.history, slo, p["slo_fast_window"], now)
                slow = slo_burn(self.history, slo, p["slo_slow_window"], now)
            except Exception:
                continue  # a broken SLO must not take down the scrape
            burns[slo.name] = {
                "role": slo.role, "kind": slo.kind,
                "objective": slo.objective,
                "threshold_s": slo.threshold_s,
                "burn_fast": None if fast is None else round(fast, 4),
                "burn_slow": None if slow is None else round(slow, 4),
            }
        with self._lock:
            self._slo_burns = burns

    def slo_status(self) -> dict:
        """{slo_name: {role, kind, objective, burn_fast, burn_slow}} —
        the /debug/alerts `slos` block cluster.top renders."""
        with self._lock:
            return {k: dict(v) for k, v in self._slo_burns.items()}

    def _slo_lines(self) -> list[str]:
        with self._lock:
            burns = {k: dict(v) for k, v in self._slo_burns.items()}
        lines = [
            "# HELP SeaweedFS_slo_burn_rate error-budget burn rate per"
            " SLO and window (1.0 = spending the budget exactly at the"
            " sustainable rate)",
            "# TYPE SeaweedFS_slo_burn_rate gauge",
        ]
        from seaweedfs_tpu_torch.stats.metrics import _fmt_value

        for name in sorted(burns):
            b = burns[name]
            for win, key in (("fast", "burn_fast"), ("slow", "burn_slow")):
                v = b.get(key)
                if v is None:
                    continue
                lines.append(
                    "SeaweedFS_slo_burn_rate"
                    + _fmt_labels(("slo", "window"), (name, win))
                    + f" {_fmt_value(v)}"
                )
        return lines

    def _run_checks(self, now: float, params: dict) -> dict:
        results = {}
        for rule in self.rules:
            try:
                res = rule.check(self.history, now, params)
            except Exception:
                res = None  # a broken rule must not take down the scrape
            if res is not None:
                results[rule.name] = res
        return results

    def evaluate(self, now: float | None = None) -> dict:
        """Run every rule, update firing state (rising edges counted),
        return a snapshot {name: {severity, since, value, detail}}."""
        now = time.time() if now is None else now
        results = self._run_checks(now, self.params)
        self._slo_update(now)
        self._last_eval = time.time()
        rising: list[tuple[str, dict]] = []
        cleared: list[tuple[str, dict]] = []
        with self._lock:
            for rule in self.rules:
                res = results.get(rule.name)
                cur = self.firing.get(rule.name)
                if res is None:
                    if cur is not None:
                        cleared.append((rule.name, dict(cur)))
                        del self.firing[rule.name]
                    continue
                value, detail = res
                if cur is None:
                    info = {
                        "severity": rule.severity, "since": now,
                        "value": value, "detail": detail,
                    }
                    self.firing[rule.name] = info
                    self.fired_events += 1
                    self._fired_total.labels(rule.name, rule.severity).inc()
                    rising.append((rule.name, dict(info)))
                else:
                    cur["value"] = value
                    cur["detail"] = detail
            snapshot = {k: dict(v) for k, v in self.firing.items()}
            listeners = list(self._on_fire)
        # outside the lock: a listener may call back into the engine.
        # Rising AND clearing edges land in the flight recorder so
        # cluster.why can bracket an incident (alert_raised ... cleared).
        from seaweedfs_tpu_torch.stats import events as events_mod

        for name, info in rising:
            events_mod.emit("alert_raised", alert=name,
                            severity=info.get("severity", "?"),
                            detail=str(info.get("detail", ""))[:200])
            for fn in listeners:
                try:
                    fn(name, info)
                except Exception:
                    pass  # a broken listener must not sink the scrape
        for name, info in cleared:
            events_mod.emit("alert_cleared", alert=name,
                            severity=info.get("severity", "?"),
                            after_s=round(now - info.get("since", now), 2))
        return snapshot

    def status(self, window: float | None = None,
               now: float | None = None) -> dict:
        """The /debug/alerts body: every rule with its firing state. A
        window override evaluates transiently (canonical firing state —
        the one /metrics exports — always uses the configured window)."""
        now = time.time() if now is None else now
        # ensure_fresh's scrape already re-evaluates via the listener; only
        # evaluate here when no fresh evaluation exists (double rule runs
        # per dashboard poll would double the history scans)
        self.history.ensure_fresh()
        if window is None or float(window) == self.params["window"]:
            if time.time() - self._last_eval > self.history.interval:
                self.evaluate(now=now)
            with self._lock:
                firing = {k: dict(v) for k, v in self.firing.items()}
        else:
            p = dict(self.params)
            p["window"] = float(window)
            firing = {}
            for name, (value, detail) in self._run_checks(now, p).items():
                rule = next(r for r in self.rules if r.name == name)
                prev = self.firing.get(name)
                firing[name] = {
                    "severity": rule.severity,
                    "since": prev["since"] if prev else now,
                    "value": value, "detail": detail,
                }
        alerts = []
        for rule in self.rules:
            st = firing.get(rule.name)
            entry = {
                "name": rule.name,
                "severity": rule.severity,
                "description": rule.description,
                "firing": st is not None,
            }
            if st is not None:
                entry["since"] = round(st["since"], 3)
                entry["value"] = round(float(st["value"]), 6)
                entry["detail"] = st["detail"]
            alerts.append(entry)
        alerts.sort(key=lambda a: (
            not a["firing"], a["severity"] != "critical", a["name"]
        ))
        return {
            "window": float(window if window is not None
                            else self.params["window"]),
            "firing": sum(1 for a in alerts if a["firing"]),
            "alerts": alerts,
            "slos": self.slo_status(),
            "slo_windows": {"fast": self.params["slo_fast_window"],
                            "slow": self.params["slo_slow_window"]},
        }

    def snapshot(self) -> dict:
        """Public view of the firing state + edge counter (bench.py's
        request_rates summary reads this; no private-state reach-ins)."""
        with self._lock:
            return {
                "fired_events": self.fired_events,
                "firing": sorted(self.firing),
            }

    def _lines(self) -> list[str]:
        with self._lock:
            firing = set(self.firing)
        lines = [
            "# HELP SeaweedFS_alerts_firing 1 while the alert rule fires"
            " (see /debug/alerts for detail)",
            "# TYPE SeaweedFS_alerts_firing gauge",
        ]
        for rule in self.rules:  # every rule exports, firing or not
            lines.append(
                "SeaweedFS_alerts_firing"
                + _fmt_labels(("alert", "severity"), (rule.name, rule.severity))
                + (" 1" if rule.name in firing else " 0")
            )
        return lines


_engine: AlertEngine | None = None
_engine_lock = threading.Lock()


def engine() -> AlertEngine:
    """Process-wide engine over the default history/registry. Created
    lazily (first metered server or first /debug/alerts hit)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = AlertEngine()
        return _engine
