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

Left out until their modules are ported: the fastlane's front-door reasons
(ROADMAP 10a-3), and the usage, heat, cluster-telemetry, spool and qos
contracts (10d-4c); `NOT_PORTED_EVENTS` names the event types whose seams
come with those slices.

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

# event types whose seams come with later slices: the native fastlane's
# lease and front door (ROADMAP 10a-3); usage, heat and qos (10d-4c)
NOT_PORTED_EVENTS = {
    "lease_churn", "fallback_fastlane", "tenant_overflow",
    "heat_promoted", "heat_demoted", "qos_shed",
}

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
    from seaweedfs_tpu_torch.maintenance import scheduler as sched_mod
    from seaweedfs_tpu_torch.maintenance import scrub as scrub_mod
    from seaweedfs_tpu_torch.server.httpd import HTTPService
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.stats import alerts, default_registry, history, \
        profiler, trace
    from seaweedfs_tpu_torch.stats import events as events_mod
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
                                     "test_torch_chaos.py"))
    for tf in missing:
        bad.append(f"tests/{tf} missing: the event registry must be"
                   f" exercised by the suite")
    for name in sorted(set(events_mod.EVENT_TYPES) - NOT_PORTED_EVENTS):
        if name not in test_src:
            bad.append(f"event type {name!r}: not exercised by"
                       f" tests/test_torch_events.py or test_torch_chaos.py")
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
        + task_type_violations() + ec_online_reason_violations() \
        + fault_point_violations() + degraded_reason_violations() \
        + repair_reason_violations() + stream_lazy_violations() \
        + event_type_violations() + slo_violations() + scrub_violations()
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
