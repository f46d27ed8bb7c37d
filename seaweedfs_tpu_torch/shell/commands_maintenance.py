"""cluster.maintenance — the operator surface of the autonomous
maintenance subsystem (`maintenance/`): status dashboard, runtime
enable/disable, dry-run toggling, forced scans.

The port's copy of `seaweedfs_tpu/shell/commands_maintenance.py`, whole.
Reference: upstream drives the same repairs as one-shot shell verbs
(`volume.fix.replication`, `ec.rebuild`, ...); here those verbs share
their plan/apply code with a daemon the port's master runs continuously,
and this verb inspects/steers that daemon over its /maintenance HTTP
plane.
"""

from __future__ import annotations

from .env import CommandEnv, ShellError
from .registry import command, parse_flags


def _render_status(st: dict) -> str:
    if not st.get("configured", True):
        return ("maintenance: not configured on this master"
                " (start with -maintenance or run"
                " `cluster.maintenance -enable`)")
    lines = [
        "maintenance: "
        + ("ENABLED" if st.get("enabled") else "DISABLED")
        + (" (dry-run: plans only, no mutations)" if st.get("dry_run") else "")
        + f", scan interval {st.get('interval', 0):g}s,"
        f" {st.get('scans', 0)} scan(s)"
    ]
    sched = st.get("scheduler", {})
    limits = sched.get("limits", {})
    lines.append(
        f"throttle: {limits.get('repair_rate', '?')} repairs/s"
        f" (burst {limits.get('repair_burst', '?')}),"
        f" global {limits.get('global_limit', '?')} in flight,"
        f" per-node {limits.get('per_node_limit', '?')}"
    )
    pressure = st.get("pressure")
    if pressure:
        lazy_w = pressure.get("lazy_window", 0)
        lines.append(
            f"pressure: {pressure.get('tokens', 0):.1f} tokens,"
            f" {pressure.get('in_flight', 0)}"
            f"/{pressure.get('global_limit', '?')} in flight,"
            f" {pressure.get('queued', 0)} queued"
            + (f", lazy window {lazy_w:g}s"
               f" ({pressure.get('lazy_held', 0)} held for co-stripe"
               f" batching)" if lazy_w else "")
        )
    counts = st.get("counts", {})
    stats = sched.get("stats", {})
    lines.append(
        f"totals: {stats.get('dispatched', 0)} dispatched,"
        f" {stats.get('completed', 0)} completed,"
        f" {stats.get('failed', 0)} failed,"
        f" {stats.get('deduped', 0)} deduped"
    )
    for task_type, spec in sorted(st.get("task_types", {}).items()):
        c = counts.get(task_type, {})
        done = ", ".join(f"{v} {k}" for k, v in sorted(c.items())) or "idle"
        lines.append(f"  {task_type} (prio {spec['priority']},"
                     f" cap {spec['concurrency']}): {done}")
    queued = sched.get("queued", [])
    in_flight = sched.get("in_flight", [])
    if queued:
        lines.append(f"{len(queued)} queued:")
        for t in queued[:10]:
            lazy = t.get("lazy") or {}
            lines.append(
                f"  {t['type']} volume={t['volume_id']} node={t['node']}"
                f" ({t['reason']})"
                + (f" [lazy: dispatch in {lazy['dispatch_in']}s,"
                   f" waiting for co-stripe losses]"
                   if lazy.get("held") else "")
            )
    if in_flight:
        lines.append(f"{len(in_flight)} in flight:")
        for t in in_flight:
            lines.append(f"  {t['type']} volume={t['volume_id']}"
                         f" node={t['node']}")
    for b in sched.get("backoff", []):
        lines.append(
            f"backing off: {b['type']} {b['target']}"
            f" ({b['failures']} failure(s), retry in {b['retry_in']}s)"
        )
    hist = st.get("history", [])
    if hist:
        lines.append(f"last {min(len(hist), 5)} of {len(hist)} task(s):")
        for h in hist[-5:]:
            t = h["task"]
            lines.append(
                f"  [{h['state']}] {t['type']} volume={t['volume_id']}"
                f" node={t['node']} {h['duration_ms']}ms"
                + (f" — {h['error']}" if h.get("error") else "")
            )
    return "\n".join(lines)


@command("cluster.maintenance",
         "[-status] [-enable [-dryRun|-apply]"
         " [-rebuildMode auto|pipelined|classic] [-lazyWindow <s>]]"
         " [-disable] [-now <task|all>]"
         " — inspect/steer the master's autonomous maintenance daemon"
         " (detect -> plan -> heal; /debug/maintenance). -enable alone"
         " preserves the daemon's current dry-run/rebuild/lazy modes")
def cmd_cluster_maintenance(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    actions = [f for f in ("enable", "disable", "now") if f in flags]
    if len(actions) > 1:
        raise ShellError(
            "pass at most one of -enable / -disable / -now")
    try:
        if "enable" in flags:
            if "dryRun" in flags and "apply" in flags:
                raise ShellError("pass only one of -dryRun / -apply")
            payload: dict = {}
            if "dryRun" in flags:
                payload["dryRun"] = True
            elif "apply" in flags:
                payload["dryRun"] = False
            if "rebuildMode" in flags:
                payload["rebuildMode"] = flags["rebuildMode"]
            if "lazyWindow" in flags:
                payload["lazyWindow"] = float(flags["lazyWindow"])
            out = env.post(
                f"{env.master_url}/maintenance/enable", payload,
            )
            lazy_w = out.get("lazy_window", 0)
            return (
                "maintenance enabled"
                + (" (dry-run)" if out.get("dry_run") else "")
                + f" — scan interval {out.get('interval', 0):g}s,"
                + f" rebuild mode {out.get('rebuild_mode', 'auto')}"
                + (f", lazy window {lazy_w:g}s" if lazy_w else "")
            )
        if "disable" in flags:
            env.post(f"{env.master_url}/maintenance/disable")
            return "maintenance disabled (queue paused, daemon idle)"
        if "now" in flags:
            task = flags["now"]
            payload = {} if task in ("true", "all") else {"task": task}
            out = env.post(f"{env.master_url}/maintenance/scan", payload)
            offered = out.get("offered", [])
            if not offered:
                return "scan found nothing new to repair"
            lines = [f"scan enqueued {len(offered)} task(s):"]
            lines += [
                f"  {t['type']} volume={t['volume_id']} node={t['node']}"
                f" ({t['reason']})" for t in offered
            ]
            return "\n".join(lines)
        st = env.get(f"{env.master_url}/debug/maintenance")
    except IOError as e:
        raise ShellError(str(e))
    return _render_status(st)
