"""Prometheus metric-namespace lint for the port:
SeaweedFS_<subsystem>_<name>[_unit][_total].

The port's copy of the JAX package's `tools/check_metric_names.py`,
pointed at the port's registry. It walks every family the process
registry can expose (the counters and histograms registered at import or
enable time, the lazily-created kernel families, and the collector-declared
names of the master, the volume servers and the stats modules) and fails
on any name that breaks the convention, so the metric namespace cannot
drift. Its subsystem list, alert-rule rules and task-type rules are the
JAX package's:

  * name matches  SeaweedFS_<subsystem>_<snake_case>  with a known
    subsystem
  * counters end in _total
  * histograms end in a base unit (_seconds or _bytes)
  * gauges do not end in _total (that suffix promises counter semantics)
  * alert-rule names are unique snake_case with a known severity
  * maintenance task-type names are unique snake_case, each with a
    detector and an executor

plus the reason, state, event-type and fault-point vocabularies.
`exposition_violations(text)` lints the families a role's `/metrics`
actually renders.

plus the usage/heat, cluster-telemetry, spool and qos contracts, and the
fastlane's front-door reasons. Every declared event type has a seam in the
port (`NOT_PORTED_EVENTS` is empty).

    python -m seaweedfs_tpu_torch.tools.check_metric_names
"""

from __future__ import annotations

import os
import re
import sys

NAME_RE = re.compile(
    r"^SeaweedFS_"
    r"(master|volume|filer|s3|http|stats|mount|mq|iam|alerts|process"
    r"|maintenance|faults|events|slo|usage|heat|node|cluster|telemetry"
    r"|qos)_"
    r"[a-z][a-z0-9]*(_[a-z0-9]+)*$"
)

# fault-point names: dotted lowercase, at least two segments
FAULT_POINT_RE = re.compile(
    r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$"
)

# Prometheus build-info convention: no subsystem segment
SPECIAL_NAMES = {"SeaweedFS_build_info"}

ALERT_RULE_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)*$")
ALERT_SEVERITIES = {"critical", "warning"}

HISTOGRAM_UNITS = ("_seconds", "_bytes")

# event types declared without a seam in the port: none
NOT_PORTED_EVENTS: set[str] = set()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.join(os.path.dirname(_PKG), "tests")


def _read_tests(names) -> tuple[str, list[str]]:
    """The concatenated source of the named test files, and the missing."""
    src, missing = "", []
    for tf in names:
        try:
            with open(os.path.join(_TESTS, tf)) as f:
                src += f.read()
        except OSError:
            missing.append(tf)
    return src, missing


def collect() -> tuple[dict[str, str], list[str]]:
    """-> ({family: kind} for registry-backed metrics, [collector names])."""
    from seaweedfs_tpu_torch import maintenance
    from seaweedfs_tpu_torch.qos import admission as qos_mod
    from seaweedfs_tpu_torch.maintenance import scheduler as sched_mod
    from seaweedfs_tpu_torch.maintenance import scrub as scrub_mod
    from seaweedfs_tpu_torch.server.httpd import HTTPService
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.stats import alerts, default_registry, history, \
        profiler, trace
    from seaweedfs_tpu_torch.stats import aggregate as aggregate_mod
    from seaweedfs_tpu_torch.stats import events as events_mod
    from seaweedfs_tpu_torch.stats import heat as heat_mod
    from seaweedfs_tpu_torch.stats import store as store_mod
    from seaweedfs_tpu_torch.stats import usage as usage_mod
    from seaweedfs_tpu_torch.storage import crc
    from seaweedfs_tpu_torch.storage.erasure_coding import decoder as ec_decoder
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding import online as ec_online
    from seaweedfs_tpu_torch.storage.volume import degraded_reads_counter
    from seaweedfs_tpu_torch.util import faults as faults_mod

    # force the lazily-registered families into the registry
    for fam in (trace.EC_ENCODE_SECONDS, trace.EC_DECODE_SECONDS,
                trace.FILER_HASH_SECONDS, crc.VOLUME_CRC32C_SECONDS):
        trace._kernel_metrics(fam)
    ec_encoder._pipeline_hist()
    ec_online.ensure_metrics()
    ec_decoder.repair_metrics()
    ec_decoder.stream_metrics()
    maintenance.ensure_metrics()
    sched_mod.lazy_batch_counter()
    scrub_mod.ensure_metrics()
    store_mod.ensure_metrics()
    faults_mod._injected_counter()
    degraded_reads_counter()
    svc = HTTPService(port=0)  # never started: registration side effect only
    svc.metrics_role = "lint"
    reg = default_registry()
    reg.counter("SeaweedFS_http_request_total", "requests",
                ("role", "method", "code"))
    reg.histogram("SeaweedFS_http_request_seconds", "request latency",
                  ("role", "method"), exemplars=True)
    reg.counter("SeaweedFS_stats_push_errors_total",
                "failed pushes to the metrics gateway", ("role",))
    with reg._lock:
        kinds = {name: m.kind for name, m in reg._metrics.items()}
    collector_names = sorted(
        set(MasterServer.MASTER_METRIC_FAMILIES)
        | set(VolumeServer.METRIC_FAMILIES)
        | set(trace.TRACE_SELF_FAMILIES)
        | set(profiler.PROFILER_FAMILIES)
        | set(history.HISTORY_FAMILIES)
        | set(alerts.ALERT_FAMILIES)
        | set(alerts.SLO_FAMILIES)
        | set(events_mod.EVENT_FAMILIES)
        | set(maintenance.MAINTENANCE_FAMILIES)
        | set(usage_mod.USAGE_FAMILIES)
        | set(heat_mod.HEAT_FAMILIES)
        | set(heat_mod.ROLLUP_FAMILIES)
        | set(aggregate_mod.CLUSTER_FAMILIES)
        | set(qos_mod.QOS_FAMILIES)
    )
    return kinds, collector_names


def alert_rule_violations() -> list[str]:
    """Rule names become the `alert` label of SeaweedFS_alerts_firing and
    SeaweedFS_alerts_fired_total — lint them like metric names: unique
    snake_case, known severity."""
    from seaweedfs_tpu_torch.stats import alerts

    rules = alerts.default_rules()
    bad: list[str] = []
    seen: set[str] = set()
    for r in rules:
        if not ALERT_RULE_RE.match(r.name):
            bad.append(f"alert rule {r.name!r}: not snake_case")
        if r.name in seen:
            bad.append(f"alert rule {r.name!r}: duplicate name")
        seen.add(r.name)
        if r.severity not in ALERT_SEVERITIES:
            bad.append(f"alert rule {r.name!r}: severity {r.severity!r}"
                       f" not in {sorted(ALERT_SEVERITIES)}")
    return bad


def task_type_violations() -> list[str]:
    """Maintenance task-type names become the `task` label of every
    SeaweedFS_maintenance_* family AND the detector/executor registry
    keys — lint them like alert-rule names: unique snake_case, with a
    detector and an executor actually registered for each."""
    from seaweedfs_tpu_torch import maintenance

    bad: list[str] = []
    for name, spec in maintenance.TASK_TYPES.items():
        if not ALERT_RULE_RE.match(name):
            bad.append(f"maintenance task type {name!r}: not snake_case")
        if spec.name != name:
            bad.append(f"maintenance task type {name!r}: spec name"
                       f" mismatch ({spec.name!r})")
        if spec.concurrency < 1:
            bad.append(f"maintenance task type {name!r}: concurrency"
                       f" {spec.concurrency} < 1")
    for registry_name, registry in (
        ("detector", maintenance.DETECTORS),
        ("executor", maintenance.EXECUTORS),
    ):
        missing = set(maintenance.TASK_TYPES) ^ set(registry)
        for name in sorted(missing):
            bad.append(f"maintenance task type {name!r}: no matching"
                       f" {registry_name} registration")
    return bad


def front_reason_violations() -> list[str]:
    """Front-door fallback reasons ride into the `reason` label of the
    SeaweedFS_{filer,s3}_fastlane_fallback_total families — lint them
    (unique snake_case) and require the alert's pathological subset to be
    a real subset, so a renamed reason can't silently un-wire the
    fastlane_fallback rule."""
    from seaweedfs_tpu_torch.storage import fastlane

    bad: list[str] = []
    seen: set[str] = set()
    for name in fastlane.FALLBACK_REASONS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"fallback reason {name!r}: not snake_case")
        if name in seen:
            bad.append(f"fallback reason {name!r}: duplicate")
        seen.add(name)
    for name in fastlane.PATHOLOGICAL_REASONS:
        if name not in seen:
            bad.append(f"pathological reason {name!r}: not a declared"
                       f" fallback reason")
    for name in fastlane.FRONT_OPS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"front op {name!r}: not snake_case")
    return bad


def ec_online_reason_violations() -> list[str]:
    """Online-EC degrade reasons ride into the `reason` label of
    SeaweedFS_volume_ec_online_fallbacks_total — lint them like the
    front-door reason set (unique snake_case, the pathological subset —
    what bench asserts is zero in steady state — must stay a real
    subset so a renamed reason can't silently pass the acceptance)."""
    from seaweedfs_tpu_torch.storage.erasure_coding import online

    bad: list[str] = []
    seen: set[str] = set()
    for name in online.FALLBACK_REASONS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"ec_online fallback reason {name!r}: not snake_case")
        if name in seen:
            bad.append(f"ec_online fallback reason {name!r}: duplicate")
        seen.add(name)
    for name in online.PATHOLOGICAL_REASONS:
        if name not in seen:
            bad.append(f"ec_online pathological reason {name!r}: not a"
                       f" declared fallback reason")
    return bad


def fault_point_violations() -> list[str]:
    """Fault-point names become the `point` label of
    SeaweedFS_faults_injected_total and the chaos suite's coverage
    contract: unique dotted lowercase, every declared point registered by
    a real seam, and every point exercised by tests/test_torch_chaos.py."""
    from seaweedfs_tpu_torch.util import faults

    bad: list[str] = []
    seen: set[str] = set()
    for name in faults.ALL_POINTS:
        if not FAULT_POINT_RE.match(name):
            bad.append(f"fault point {name!r}: not dotted lowercase")
        if name in seen:
            bad.append(f"fault point {name!r}: duplicate")
        seen.add(name)
    # importing the seam modules registers their points
    import seaweedfs_tpu_torch.filer.wdclient  # noqa: F401
    import seaweedfs_tpu_torch.server.master  # noqa: F401
    import seaweedfs_tpu_torch.server.volume  # noqa: F401
    import seaweedfs_tpu_torch.storage.erasure_coding.ec_volume  # noqa: F401
    import seaweedfs_tpu_torch.storage.erasure_coding.online  # noqa: F401
    import seaweedfs_tpu_torch.storage.fastlane  # noqa: F401
    import seaweedfs_tpu_torch.storage.volume  # noqa: F401

    registered = set(faults.registered_points())
    for name in sorted(set(faults.ALL_POINTS) - registered):
        bad.append(f"fault point {name!r}: declared but no seam registers it")
    for name in sorted(registered - set(faults.ALL_POINTS)):
        bad.append(f"fault point {name!r}: registered but not declared")
    chaos_src, missing = _read_tests(("test_torch_chaos.py",))
    if missing:
        return bad + ["tests/test_torch_chaos.py missing: every fault point"
                      " must be exercised by the chaos suite"]
    for name in faults.ALL_POINTS:
        if name not in chaos_src:
            bad.append(f"fault point {name!r}: not exercised by"
                       f" tests/test_torch_chaos.py")
    return bad


def event_type_violations() -> list[str]:
    """Event types (stats/events.py) become the `type` label of
    SeaweedFS_events_recorded_total, /debug/events' filter vocabulary and
    cluster.why's rows: unique snake_case, every declared type (but
    NOT_PORTED_EVENTS) emitted by a real seam of the port, and every type
    exercised by tests/test_torch_events.py or test_torch_chaos.py."""
    from seaweedfs_tpu_torch.stats import events as events_mod

    bad: list[str] = []
    for name in events_mod.EVENT_TYPES:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"event type {name!r}: not snake_case")
    events_src = os.path.join("stats", "events.py")
    emitted: set[str] = set()
    for dirpath, _, files in os.walk(_PKG):
        for fn in files:
            path = os.path.join(dirpath, fn)
            # the registry itself, and this lint, do not count as seams
            if not fn.endswith(".py") or path.endswith(events_src) \
                    or path == os.path.abspath(__file__):
                continue
            with open(path) as f:
                src = f.read()
            for name in events_mod.EVENT_TYPES:
                if f'"{name}"' in src or f"'{name}'" in src:
                    emitted.add(name)
    for name in sorted(set(events_mod.EVENT_TYPES) - emitted
                       - NOT_PORTED_EVENTS):
        bad.append(f"event type {name!r}: declared but no seam emits it")
    test_src, missing = _read_tests(("test_torch_events.py",
                                     "test_torch_chaos.py",
                                     "test_torch_usage_heat.py",
                                     "test_torch_qos.py"))
    for tf in missing:
        bad.append(f"tests/{tf} missing: the event registry must be"
                   f" exercised by the suite")
    for name in sorted(set(events_mod.EVENT_TYPES) - NOT_PORTED_EVENTS):
        if name not in test_src:
            bad.append(f"event type {name!r}: not exercised by"
                       f" tests/test_torch_{{events,chaos,usage_heat,qos}}.py")
    return bad


def slo_violations() -> list[str]:
    """SLO names ride into the `slo` label of SeaweedFS_slo_burn_rate
    and the burn alerts' details — lint them like alert-rule names
    (unique snake_case, sane objectives, known kinds/roles), and require
    the two multi-window burn rules to exist with the right severities
    so a renamed rule can't silently un-page the fast burn."""
    from seaweedfs_tpu_torch.stats import alerts

    bad: list[str] = []
    seen: set[str] = set()
    known_roles = {"master", "volume", "filer", "s3", "webdav"}
    for slo in alerts.DEFAULT_SLOS:
        if not ALERT_RULE_RE.match(slo.name):
            bad.append(f"slo {slo.name!r}: not snake_case")
        if slo.name in seen:
            bad.append(f"slo {slo.name!r}: duplicate name")
        seen.add(slo.name)
        if slo.kind not in ("availability", "latency"):
            bad.append(f"slo {slo.name!r}: unknown kind {slo.kind!r}")
        if not (0.0 < slo.objective < 1.0):
            bad.append(f"slo {slo.name!r}: objective {slo.objective}"
                       f" not in (0, 1)")
        if slo.kind == "latency" and slo.threshold_s <= 0:
            bad.append(f"slo {slo.name!r}: latency slo needs a positive"
                       f" threshold_s")
        if slo.role not in known_roles:
            bad.append(f"slo {slo.name!r}: unknown role {slo.role!r}")
    severities = {r.name: r.severity for r in alerts.default_rules()}
    if severities.get("slo_burn_fast") != "critical":
        bad.append("alert rule slo_burn_fast: missing or not critical")
    if severities.get("slo_burn_slow") != "warning":
        bad.append("alert rule slo_burn_slow: missing or not warning")
    return bad


def repair_reason_violations() -> list[str]:
    """Repair modes / fallback reasons / chain-restart reasons ride into
    the labels of the SeaweedFS_volume_ec_repair_* families (and the
    shell verb's -mode flag) — lint them like the other reason sets:
    unique snake_case, the restart reasons a real subset of the fallback
    reasons (a restart that exhausts becomes that fallback), and the
    mode set exactly the classic/pipelined pair bench compares."""
    from seaweedfs_tpu_torch.storage.erasure_coding import decoder

    bad: list[str] = []
    if tuple(sorted(decoder.REPAIR_MODES)) != ("classic", "pipelined"):
        bad.append(f"repair modes {decoder.REPAIR_MODES!r}: expected"
                   f" exactly classic+pipelined")
    seen: set[str] = set()
    for name in decoder.REPAIR_FALLBACK_REASONS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"repair fallback reason {name!r}: not snake_case")
        if name in seen:
            bad.append(f"repair fallback reason {name!r}: duplicate")
        seen.add(name)
    for name in decoder.REPAIR_RESTART_REASONS:
        if name not in seen:
            bad.append(f"repair restart reason {name!r}: not a declared"
                       f" fallback reason")
    return bad


def stream_lazy_violations() -> list[str]:
    """The streaming-session chunk states (the `state` label of
    SeaweedFS_volume_ec_repair_stream_chunks_total) and the lazy-batch
    outcomes (the `outcome` label of
    SeaweedFS_maintenance_lazy_batch_total) — lint them like the other
    reason sets: unique snake_case, the streaming failure reasons
    (stream_stall, chunk_crc) declared restart reasons (so their
    exhaustion has a typed fallback), and the whole vocabulary exercised
    by the suite (a state nobody drives is a state nobody proved
    reachable)."""
    from seaweedfs_tpu_torch.maintenance import scheduler as sched_mod
    from seaweedfs_tpu_torch.storage.erasure_coding import decoder

    bad: list[str] = []
    for label, names in (
        ("stream chunk state", decoder.STREAM_CHUNK_STATES),
        ("lazy batch outcome", sched_mod.LAZY_OUTCOMES),
    ):
        seen: set[str] = set()
        for name in names:
            if not ALERT_RULE_RE.match(name):
                bad.append(f"{label} {name!r}: not snake_case")
            if name in seen:
                bad.append(f"{label} {name!r}: duplicate")
            seen.add(name)
    for reason in ("stream_stall", "chunk_crc"):
        if reason not in decoder.REPAIR_RESTART_REASONS:
            bad.append(f"streaming reason {reason!r}: not a declared"
                       f" restart reason")
    test_src, missing = _read_tests(("test_torch_repair.py",
                                     "test_torch_maintenance.py",
                                     "test_torch_chaos.py",
                                     "test_torch_observe.py"))
    for tf in missing:
        bad.append(f"tests/{tf} missing: the streaming/lazy sets"
                   f" must be exercised by the suite")
    for name in ("stream_stall", "chunk_crc",
                 *decoder.STREAM_CHUNK_STATES, *sched_mod.LAZY_OUTCOMES):
        if name not in test_src:
            bad.append(f"streaming/lazy name {name!r}: not exercised by"
                       f" tests/test_torch_repair.py, test_torch_maintenance.py,"
                       f" test_torch_chaos.py or test_torch_observe.py")
    return bad


def scrub_violations() -> list[str]:
    """Scrub finding kinds ride into the `kind` label of
    SeaweedFS_volume_scrub_{findings,repairs}_total, the scrub_finding
    event's attrs and the scrub repair routing table — lint them like
    the other reason sets (unique snake_case), require the `corrupt`
    fault mode to exist AND be exercised by the chaos suite (silent
    damage nobody injects is silent damage nobody proved detectable),
    and require the `scrub` maintenance task type to be registered."""
    from seaweedfs_tpu_torch import maintenance
    from seaweedfs_tpu_torch.maintenance import scrub as scrub_mod
    from seaweedfs_tpu_torch.util import faults

    bad: list[str] = []
    seen: set[str] = set()
    for name in scrub_mod.SCRUB_FINDING_KINDS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"scrub finding kind {name!r}: not snake_case")
        if name in seen:
            bad.append(f"scrub finding kind {name!r}: duplicate")
        seen.add(name)
    if "corrupt" not in faults.MODES:
        bad.append("fault mode 'corrupt' missing from faults.MODES"
                   " (scrub detection is untestable end to end)")
    if "scrub" not in maintenance.TASK_TYPES:
        bad.append("maintenance task type 'scrub' not registered")
    chaos_src, missing = _read_tests(("test_torch_chaos.py",))
    unit_src, missing2 = _read_tests(("test_torch_scrub.py",))
    test_src = chaos_src + unit_src
    for tf in missing + missing2:
        bad.append(f"tests/{tf} missing: the scrub subsystem must be"
                   f" exercised by the suite")
    if '"corrupt"' not in chaos_src and "'corrupt'" not in chaos_src:
        bad.append("fault mode 'corrupt': not exercised by"
                   " tests/test_torch_chaos.py")
    for name in scrub_mod.SCRUB_FINDING_KINDS:
        if name not in test_src:
            bad.append(f"scrub finding kind {name!r}: not exercised by"
                       f" tests/test_torch_scrub.py or test_torch_chaos.py")
    return bad


def degraded_reason_violations() -> list[str]:
    """Degraded-read reasons ride into the `reason` label of
    SeaweedFS_volume_degraded_reads_total (and the degraded_reads alert
    sums over them) — lint them like the other reason sets."""
    from seaweedfs_tpu_torch.storage.volume import DEGRADED_READ_REASONS

    bad: list[str] = []
    seen: set[str] = set()
    for name in DEGRADED_READ_REASONS:
        if not ALERT_RULE_RE.match(name):
            bad.append(f"degraded-read reason {name!r}: not snake_case")
        if name in seen:
            bad.append(f"degraded-read reason {name!r}: duplicate")
        seen.add(name)
    return bad


def usage_heat_violations() -> list[str]:
    """The tenant/heat telemetry contract: every usage/heat family
    declared, the sketch's _other sentinel reserved (a real collection
    named `_other` would alias the overflow row), the three heat/usage
    event types registered, and the capacity-forecast alert pair present
    with the right severities — so a renamed gauge can't silently
    un-wire cluster.check's days-to-full failure mode."""
    from seaweedfs_tpu_torch.stats import alerts
    from seaweedfs_tpu_torch.stats import events as events_mod
    from seaweedfs_tpu_torch.stats import heat as heat_mod
    from seaweedfs_tpu_torch.stats import usage as usage_mod

    bad: list[str] = []
    for fam in (*usage_mod.USAGE_FAMILIES, *heat_mod.HEAT_FAMILIES,
                *heat_mod.ROLLUP_FAMILIES):
        if fam in SPECIAL_NAMES:
            continue
        if not NAME_RE.match(fam):
            bad.append(f"usage/heat family {fam!r}: does not match"
                       f" SeaweedFS_<subsystem>_<snake_case>")
    if not usage_mod.OTHER.startswith("_"):
        bad.append(f"usage overflow sentinel {usage_mod.OTHER!r}: must"
                   f" start with '_' (real collections are snake_case)")
    if usage_mod.DEFAULT_K < 1:
        bad.append(f"usage DEFAULT_K {usage_mod.DEFAULT_K}: must be >= 1")
    for ev in ("tenant_overflow", "heat_promoted", "heat_demoted"):
        if ev not in events_mod.EVENT_TYPES:
            bad.append(f"event type {ev!r}: missing from the flight"
                       f" recorder registry")
    severities = {r.name: r.severity for r in alerts.default_rules()}
    if severities.get("capacity_forecast") != "warning":
        bad.append("alert rule capacity_forecast: missing or not warning")
    if severities.get("capacity_forecast_critical") != "critical":
        bad.append("alert rule capacity_forecast_critical: missing or"
                   " not critical")
    return bad


def cluster_telemetry_violations() -> list[str]:
    """The cluster telemetry plane's contract (stats/aggregate.py): every
    `cluster` family well-formed, the staleness + self-observability
    families present (a renamed stale gauge would silently un-wire the
    "gateway went quiet" finding), and the cluster-scope alert rule names
    unique snake_case with known severities — they become the `alert`
    label of SeaweedFS_cluster_alerts_firing."""
    from seaweedfs_tpu_torch.stats import aggregate as aggregate_mod

    bad: list[str] = []
    fams = aggregate_mod.CLUSTER_FAMILIES
    for fam in fams:
        if not NAME_RE.match(fam):
            bad.append(f"cluster family {fam!r}: does not match"
                       f" SeaweedFS_<subsystem>_<snake_case>")
        elif not fam.startswith("SeaweedFS_cluster_"):
            bad.append(f"cluster family {fam!r}: must live in the"
                       f" `cluster` subsystem")
    for required in ("SeaweedFS_cluster_telemetry_stale",
                     "SeaweedFS_cluster_telemetry_senders",
                     "SeaweedFS_cluster_telemetry_frames_total",
                     "SeaweedFS_cluster_telemetry_frame_age_seconds",
                     "SeaweedFS_cluster_usage_error_bound",
                     "SeaweedFS_cluster_slo_burn_rate",
                     "SeaweedFS_cluster_alerts_firing"):
        if required not in fams:
            bad.append(f"cluster family {required!r}: missing from"
                       f" CLUSTER_FAMILIES")
    seen: set[str] = set()
    for name, severity in aggregate_mod.CLUSTER_RULES:
        if name in seen:
            bad.append(f"cluster rule {name!r}: duplicate name")
        seen.add(name)
        if not name.startswith("cluster_"):
            bad.append(f"cluster rule {name!r}: must carry the cluster_"
                       f" prefix (dashboards must tell cluster-scope"
                       f" firing from per-process slo_burn_*)")
        if not ALERT_RULE_RE.match(name):
            bad.append(f"cluster rule {name!r}: not snake_case")
        if severity not in ALERT_SEVERITIES:
            bad.append(f"cluster rule {name!r}: severity {severity!r}"
                       f" not in {sorted(ALERT_SEVERITIES)}")
    return bad


def telemetry_violations() -> list[str]:
    """The durable-telemetry contract (stats/store.py): every spool
    family declared, in the `telemetry` subsystem, with the spool gauge
    + cap pair both present (the near-cap alert divides one by the
    other, so a renamed gauge would silently un-wire it), the flush and
    replay timers present, and the telemetry_spool_near_cap rule a
    warning — eviction is an ops heads-up, never an incident page."""
    from seaweedfs_tpu_torch.stats import alerts
    from seaweedfs_tpu_torch.stats import store as store_mod

    bad: list[str] = []
    fams = store_mod.TELEMETRY_FAMILIES
    for fam in fams:
        if not NAME_RE.match(fam):
            bad.append(f"telemetry family {fam!r}: does not match"
                       f" SeaweedFS_<subsystem>_<snake_case>")
        elif not fam.startswith("SeaweedFS_telemetry_"):
            bad.append(f"telemetry family {fam!r}: must live in the"
                       f" `telemetry` subsystem")
    for required in ("SeaweedFS_telemetry_spool_bytes",
                     "SeaweedFS_telemetry_spool_cap_bytes",
                     "SeaweedFS_telemetry_flush_seconds",
                     "SeaweedFS_telemetry_replay_seconds",
                     "SeaweedFS_telemetry_segments_evicted_total"):
        if required not in fams:
            bad.append(f"telemetry family {required!r}: missing from"
                       f" TELEMETRY_FAMILIES")
    tiers = {t for t, _, _ in store_mod.TIERS}
    for required_tier in ("raw", "1m", "10m", "events"):
        if required_tier not in tiers:
            bad.append(f"telemetry tier {required_tier!r}: missing from"
                       f" store.TIERS (the spool gauge's tier label set)")
    shares = sum(share for _, _, share in store_mod.TIERS)
    if not 0.99 <= shares <= 1.01:
        bad.append(f"telemetry tier shares sum to {shares:g}: the"
                   f" -telemetry.retention budget must be fully carved")
    severities = {r.name: r.severity for r in alerts.default_rules()}
    if severities.get("telemetry_spool_near_cap") != "warning":
        bad.append("alert rule telemetry_spool_near_cap: missing or"
                   " not warning")
    return bad


def qos_violations() -> list[str]:
    """The admission-control contract (qos/admission.py): every QoS
    family declared in the `qos` subsystem, the shed-reason and
    priority-class vocabularies closed (unique snake_case — they become
    the `reason`/`class` labels of SeaweedFS_qos_shed_total and the
    machine-readable 429/503 bodies clients retry on), every reason
    mapped to a 429 or 503, the qos_shed event registered AND emitted
    by the admission seam, and the qos_shed_interactive rule critical —
    sustained interactive-class shedding is exactly what cluster.check
    -fail must exit nonzero on."""
    from seaweedfs_tpu_torch.qos import admission as qos_mod
    from seaweedfs_tpu_torch.stats import alerts
    from seaweedfs_tpu_torch.stats import events as events_mod

    bad: list[str] = []
    for fam in qos_mod.QOS_FAMILIES:
        if not NAME_RE.match(fam):
            bad.append(f"qos family {fam!r}: does not match"
                       f" SeaweedFS_<subsystem>_<snake_case>")
        elif not fam.startswith("SeaweedFS_qos_"):
            bad.append(f"qos family {fam!r}: must live in the `qos`"
                       f" subsystem")
    for required in ("SeaweedFS_qos_admitted_total",
                     "SeaweedFS_qos_shed_total",
                     "SeaweedFS_qos_queued_total"):
        if required not in qos_mod.QOS_FAMILIES:
            bad.append(f"qos family {required!r}: missing from"
                       f" QOS_FAMILIES")
    for label, names in (
        ("qos shed reason", qos_mod.SHED_REASONS),
        ("qos priority class", qos_mod.PRIORITY_CLASSES),
    ):
        seen: set[str] = set()
        for name in names:
            if not ALERT_RULE_RE.match(name):
                bad.append(f"{label} {name!r}: not snake_case")
            if name in seen:
                bad.append(f"{label} {name!r}: duplicate")
            seen.add(name)
    for reason in qos_mod.SHED_REASONS:
        status = qos_mod._REASON_STATUS.get(reason)
        if status not in (429, 503):
            bad.append(f"qos shed reason {reason!r}: no 429/503 status"
                       f" mapping (clients can't type the rejection)")
    for reason in qos_mod._REASON_STATUS:
        if reason not in qos_mod.SHED_REASONS:
            bad.append(f"qos status mapping {reason!r}: not a declared"
                       f" shed reason")
    if "qos_shed" not in events_mod.EVENT_TYPES:
        bad.append("event type 'qos_shed': missing from the flight"
                   " recorder registry")
    adm = os.path.join(_PKG, "qos", "admission.py")
    try:
        with open(adm) as f:
            adm_src = f.read()
    except OSError:
        adm_src = ""
    if '"qos_shed"' not in adm_src and "'qos_shed'" not in adm_src:
        bad.append("event type 'qos_shed': not emitted by"
                   " qos/admission.py (the shed seam must journal)")
    severities = {r.name: r.severity for r in alerts.default_rules()}
    if severities.get("qos_shed_interactive") != "critical":
        bad.append("alert rule qos_shed_interactive: missing or not"
                   " critical")
    return bad


def violations(kinds: dict[str, str], collector_names: list[str]) -> list[str]:
    bad: list[str] = []
    for name in sorted(set(kinds) | set(collector_names)):
        if name in SPECIAL_NAMES:
            continue
        if not NAME_RE.match(name):
            bad.append(f"{name}: does not match "
                       "SeaweedFS_<subsystem>_<snake_case>")
    for name, kind in sorted(kinds.items()):
        if kind == "counter" and not name.endswith("_total"):
            bad.append(f"{name}: counter must end in _total")
        elif kind == "histogram" and not name.endswith(HISTOGRAM_UNITS):
            bad.append(f"{name}: histogram must end in a base unit "
                       f"({'/'.join(HISTOGRAM_UNITS)})")
        elif kind == "gauge" and name.endswith("_total"):
            bad.append(f"{name}: gauge must not end in _total")
    return bad


def exposition_violations(text: str) -> list[str]:
    """Lint the families one rendered exposition (a role's /metrics)
    declares through its `# TYPE` lines."""
    kinds = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                kinds[parts[2]] = parts[3]
    return violations(kinds, [])


def all_violations() -> tuple[int, list[str]]:
    """-> (families checked, every violation of every rule above)."""
    kinds, collector_names = collect()
    bad = violations(kinds, collector_names) + alert_rule_violations() \
        + task_type_violations() + front_reason_violations() \
        + ec_online_reason_violations() \
        + fault_point_violations() + degraded_reason_violations() \
        + repair_reason_violations() + stream_lazy_violations() \
        + event_type_violations() + slo_violations() + scrub_violations() \
        + usage_heat_violations() + cluster_telemetry_violations() \
        + telemetry_violations() + qos_violations()
    return len(set(kinds) | set(collector_names)), bad


def main() -> int:
    total, bad = all_violations()
    if bad:
        print(f"{len(bad)} metric-name violation(s) in {total} families:")
        for b in bad:
            print(f"  {b}")
        return 1
    print(f"{total} metric families OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
