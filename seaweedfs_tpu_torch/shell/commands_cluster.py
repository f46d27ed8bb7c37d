"""cluster.*, lock/unlock, collection.*, volume.list/status (reference
`weed/shell/command_cluster_ps.go`, `command_lock_unlock.go`,
`command_collection_*.go`, `command_volume_list.go`).

The port's copy of `lock`, `unlock`, `cluster.ps`, `collection.list`,
`collection.delete`, `volume.list`, `volume.status` and `cluster.scrub`
from `seaweedfs_tpu/shell/commands_cluster.py`, over routes the port's
master (`/cluster/ps`, `/col/list`, `/col/delete`, `/dir/status`) and
volume servers (`/admin/scrub/status`) serve. `cluster.ps` lists the
filers and brokers that registered with the master (`/cluster/register`).
`cluster.faults` arms, disarms and lists fault injection over every
discovered node's `/debug/faults` (the master, the volume servers of the
topology, the registered filers, the shell's filer and `-include`d urls).
`cluster.check`, `cluster.top`, `cluster.trace`, `cluster.profile`,
`cluster.why` and `cluster.heat` read every discovered node's `/metrics`
and debug routes (`/debug/{alerts,traces,pprof/profile,metrics/history,
events,usage,heat}`), fetched concurrently where a window must be
simultaneous; `cluster.check` and `cluster.top` first try the master's
one-fetch telemetry aggregate (`/debug/cluster/telemetry`) and fan out
when it answers nothing. `cluster.top -spool` and `cluster.why -spool`
read a dead process's telemetry spool off its segment files
(`stats/store.py`). `cluster.qos` shows every gateway's admission state
(`/debug/qos`) or sets its limits (`POST /qos/limits`). Their output is
the JAX verbs' over the same answers.
`mount.configure` reads and sets a running mount's quota over its admin
socket (`mount.start_admin_service`). `mq.topic.list`, `mq.topic.create`,
`mq.topic.describe`, `mq.topic.configure` and `mq.balance` speak to the
first mq broker registered with the master (`mq/broker.py`).
`cluster.raft.ps` lists the raft members of the shell's master and its
peers (`/raft/status`), and `cluster.raft.add` and `cluster.raft.remove`
change the membership through the leader (`/raft/{add,remove}`).
"""

from __future__ import annotations

import json
import time
import urllib.parse

from ..qos import PRIORITY_CLASSES
from ..server.httpd import http_request, peer_url
from ..stats import parse_exposition
from ..stats import profiler as prof_mod
from ..stats import store as store_mod
from ..stats.history import quantile_from_bucket_rates
from .env import CommandEnv, ShellError
from .registry import command, parse_flags


@command("lock", "acquire the exclusive admin lock on the master")
def cmd_lock(env: CommandEnv, args: list[str]) -> str:
    env.acquire_lock()
    return "lock acquired"


@command("unlock", "release the admin lock")
def cmd_unlock(env: CommandEnv, args: list[str]) -> str:
    env.release_lock()
    return "lock released"


@command("cluster.ps", "list cluster processes (masters, volume servers, filers)")
def cmd_cluster_ps(env: CommandEnv, args: list[str]) -> str:
    info = env.get(f"{env.master_url}/cluster/ps")
    lines = []
    for m in info.get("masters", []):
        lines.append(f"master {m['address']}" + (" leader" if m.get("isLeader") else ""))
    for v in info.get("volumeServers", []):
        lines.append(f"volumeServer {v['address']} dc={v['dataCenter']} rack={v['rack']}")
    for f in info.get("filers", []):
        lines.append(f"filer {f['address']}")
    for b in info.get("brokers", []):
        lines.append(f"broker {b['address']}")
    return "\n".join(lines)


def _fmt_gb(n: float) -> str:
    return f"{n / 1024**3:.1f}GB"


def _fetch_cluster_telemetry(env: CommandEnv, timeout: float = 10):
    """The master's one-fetch cluster aggregate (stats/aggregate.py), or
    None when the aggregator isn't live (no senders yet) — callers fall
    back to the N-endpoint fan-out."""
    try:
        out = env.get(f"{env.master_url}/debug/cluster/telemetry",
                      timeout=timeout)
    except Exception:
        return None
    if not isinstance(out, dict) or not out.get("senders"):
        return None
    return out


@command("collection.list", "list collections")
def cmd_collection_list(env: CommandEnv, args: list[str]) -> str:
    info = env.get(f"{env.master_url}/col/list")
    return "\n".join(
        f"collection {c['name'] or '(default)'}: {c['volumeCount']} volumes"
        for c in info["collections"]
    )


@command("collection.delete", "-collection <name> — delete all its volumes",
         needs_lock=True)
def cmd_collection_delete(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    name = flags.get("collection", flags.get("", ""))
    out = env.post(f"{env.master_url}/col/delete?collection={name}")
    return f"deleted {out['deleted']} volumes of collection {name!r}"


@command("volume.list", "list volumes per server (ref command_volume_list.go)")
def cmd_volume_list(env: CommandEnv, args: list[str]) -> str:
    lines = []
    for sv in env.servers():
        lines.append(
            f"{sv.id} dc={sv.dc} rack={sv.rack} "
            f"volumes={len(sv.volumes)}/{sv.max_volume_count}"
        )
        for vid, v in sorted(sv.volumes.items()):
            rp = v.get("replica_placement", 0)
            lines.append(
                f"  volume {vid} collection={v.get('collection', '') or '(default)'} "
                f"size={v.get('size', 0)} files={v.get('file_count', 0)} "
                f"deleted={v.get('delete_count', 0)} rp={rp:03d} "
                f"{'readonly' if v.get('read_only') else 'writable'}"
            )
        for vid, shards in sorted(sv.ec_shards.items()):
            lines.append(f"  ec volume {vid} shards={shards}")
    return "\n".join(lines)


@command("volume.status", "-volumeId <n> — show one volume's replicas + stats")
def cmd_volume_status(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags.get("volumeId", flags.get("", 0)))
    out = []
    for sv in env.servers():
        if vid in sv.volumes:
            out.append(json.dumps({"server": sv.id, **sv.volumes[vid]}))
    return "\n".join(out) if out else f"volume {vid} not found"


@command("cluster.scrub",
         "— integrity-scrub status across every volume server"
         " (/admin/scrub/status): bytes verified, scrub GB/s per kernel,"
         " unresolved findings, throttle budget")
def cmd_cluster_scrub(env: CommandEnv, args: list[str]) -> str:
    statuses: dict[str, dict] = {}
    for sv in env.servers():
        try:
            statuses[sv.id] = env.get(
                f"{sv.http}/admin/scrub/status", timeout=10)
        except Exception as e:
            statuses[sv.id] = {"error": str(e)}
    if not statuses:
        raise ShellError("no volume servers in the topology")
    lines = [f"integrity scrub across {len(statuses)} volume server(s):"]
    total_findings = 0
    now = time.time()
    for node, st in sorted(statuses.items()):
        if "error" in st:
            lines.append(f"  {node}: UNREACHABLE ({st['error']})")
            continue
        s = st.get("stats", {})
        gbps = (s.get("bytes_scanned", 0) / max(s.get("seconds", 0.0), 1e-9)
                / 1e9) if s.get("bytes_scanned") else 0.0
        last = s.get("last_pass_at", 0.0)
        age = f"{now - last:.0f}s ago" if last else "never"
        interval = st.get("interval", 0)
        lines.append(
            f"  {node}: {s.get('passes', 0)} pass(es) (last {age},"
            + (f" every {interval:g}s" if interval else " loop off")
            + f"), {s.get('needles_checked', 0)} needles +"
            f" {s.get('stripes_checked', 0)} stripe samples,"
            f" {_fmt_gb(s.get('bytes_scanned', 0))} verified"
            f" @ {gbps:.2f} GB/s,"
            f" budget {st.get('rate_bytes_per_sec', 0) / 1e6:.0f} MB/s"
            f" ({s.get('throttle_waits', 0)} throttle waits),"
            f" {s.get('tmp_removed', 0)} tmp swept"
        )
        unresolved = st.get("unresolved", [])
        total_findings += len(unresolved)
        for f in unresolved:
            lines.append(
                f"    finding: volume {f.get('volume_id')}"
                f" [{f.get('kind')}] {f.get('detail', '')}"
            )
    lines.append(
        "no unresolved findings — cluster integrity clean"
        if total_findings == 0
        else f"{total_findings} unresolved finding(s) — the maintenance"
             f" scrub task routes each to its heal"
    )
    return "\n".join(lines)


def _discover_endpoints(env: CommandEnv, include: str = "",
                        servers: list | None = None) -> set[str]:
    """Every /debug-capable node the shell can see: the master, each
    volume server in the topology, registered filers, plus -include'd
    urls (s3 gateways don't register with the master). Pass `servers` to
    reuse an already-fetched topology snapshot instead of re-fetching."""
    endpoints = {env.master_url}
    for extra in include.split(","):
        extra = extra.strip().rstrip("/")
        if extra:
            endpoints.add(peer_url(extra))
    try:
        for sv in (env.servers() if servers is None else servers):
            endpoints.add(sv.http)
    except Exception:
        pass
    try:
        ps = env.get(f"{env.master_url}/cluster/ps")
        for f in ps.get("filers", []):
            endpoints.add(f["address"])
    except Exception:
        pass
    if env.filer_url:
        endpoints.add(env.filer_url)
    return endpoints


def _scrape(url: str) -> list:
    """GET <url>/metrics -> parsed (name, labels, value) samples."""
    status, _, body = http_request("GET", f"{url}/metrics", timeout=10)
    if status != 200:
        raise IOError(f"GET {url}/metrics -> {status}")
    return parse_exposition(body.decode("utf-8", "replace"))




@command("cluster.check",
         "[-fail] [-capacityPct 90] [-include url,url] — health dashboard:"
         " replica/EC health, per-node disk + heartbeat freshness, volumes"
         " near the size cap, read-only volumes, fastlane"
         " native-vs-proxied hit rate, firing alerts (every discovered"
         " endpoint + -include'd gateways). -fail exits nonzero when any"
         " problem is found or any critical alert fires (scripting)")
def cmd_cluster_check(env: CommandEnv, args: list[str]) -> str:
    """Scrapes the Prometheus series (`SeaweedFS_master_*` topology
    gauges off the master, `SeaweedFS_volume_fastlane_*` + disk gauges off
    every volume server) and renders one cluster-health dashboard — the
    in-situ view arXiv:1709.05365 argues storage tuning needs."""
    flags = parse_flags(args)
    fail_mode = "fail" in flags
    try:
        cap_pct = float(flags.get("capacityPct", 90))
    except ValueError:
        raise ShellError("usage: cluster.check [-fail] [-capacityPct n]")

    servers = env.servers()
    replicas = env.volume_replicas()
    problems: list[str] = []
    if not servers:
        problems.append("no volume servers registered")
    # replica counts straight from the topology snapshot (works even when
    # a node's /metrics is unreachable)
    underrep_seen: set[str] = set()
    for vid, holders in sorted(replicas.items()):
        rp_byte = holders[0].volumes[vid].get("replica_placement", 0)
        want = (rp_byte // 100) + (rp_byte // 10) % 10 + rp_byte % 10 + 1
        if len(holders) < want:
            underrep_seen.add(str(vid))
            problems.append(
                f"volume {vid}: {len(holders)}/{want} replicas "
                f"({', '.join(h.id for h in holders)})"
            )

    # firing alerts: every node's /metrics carries the alert
    # engine's SeaweedFS_alerts_firing gauge; criticals are problems
    # (so -fail trips on an error storm or a stale heartbeat between
    # manual checks), warnings render informationally. Dedup by
    # (alert, severity): single-process clusters share one engine.
    firing_alerts: dict[str, str] = {}

    def note_alerts(samples: list) -> None:
        for name, labels, value in samples:
            if name == "SeaweedFS_alerts_firing" and value > 0:
                alert = labels.get("alert", "?")
                if firing_alerts.get(alert) != "critical":
                    firing_alerts[alert] = labels.get("severity", "warning")

    # --- master gauges: size limit, staleness, readonly, EC shard health ---
    size_limit = 30 * 1024**3
    stale_nodes: dict[str, float] = {}
    hb_age: dict[str, float] = {}
    free_slots: dict[str, float] = {}
    near_cap: list[str] = []
    readonly_volumes: list[str] = []
    try:
        msamples = _scrape(env.master_url)
    except Exception as e:
        msamples = []
        problems.append(f"master metrics unreachable: {e}")
    note_alerts(msamples)
    for name, labels, value in msamples:
        if name == "SeaweedFS_master_volume_size_limit_bytes":
            size_limit = value or size_limit
    for name, labels, value in msamples:
        node = labels.get("node", "")
        if name == "SeaweedFS_master_heartbeat_age_seconds":
            hb_age[node] = value
        elif name == "SeaweedFS_master_stale_heartbeats" and value > 0:
            stale_nodes[node] = hb_age.get(node, value)
        elif name == "SeaweedFS_master_free_slots":
            free_slots[node] = value
        elif name == "SeaweedFS_master_volume_size_bytes":
            if value >= size_limit * cap_pct / 100.0:
                near_cap.append(
                    f"volume {labels.get('volume')} on {node}: "
                    f"{_fmt_gb(value)} >= {cap_pct:g}% of "
                    f"{_fmt_gb(size_limit)} cap"
                )
        elif name == "SeaweedFS_master_volume_readonly" and value > 0:
            readonly_volumes.append(
                f"volume {labels.get('volume')} read-only on {node}"
            )
        elif name == "SeaweedFS_master_volumes_underreplicated" and value > 0:
            # skip vids the snapshot loop above already flagged — the gauge
            # catches what the snapshot can't (e.g. a layout whose last
            # holder vanished entirely), not the same fault twice
            if labels.get("volume") not in underrep_seen:
                problems.append(
                    f"volume {labels.get('volume')} under-replicated: "
                    f"{labels.get('have')}/{labels.get('want')} replicas"
                )
        elif name == "SeaweedFS_master_ec_missing_shards" and value > 0:
            problems.append(
                f"ec volume {labels.get('volume')}: {value:g} shard(s)"
                " without a live holder"
            )
    for node, age in sorted(stale_nodes.items()):
        problems.append(f"stale heartbeat from {node}: {age:.1f}s ago")
    problems.extend(near_cap)
    problems.extend(readonly_volumes)

    # --- per-node scrape: disk + fastlane hit rate -------------------------
    lines = [f"cluster.check @ {env.master_url}"]
    ec_count = sum(len(sv.ec_shards) for sv in servers)
    lines.append(
        f"topology: {len(servers)} volume servers, {len(replicas)} volumes,"
        f" {ec_count} ec volume holdings"
    )
    for sv in sorted(servers, key=lambda s: s.id):
        disk_used = disk_free = 0.0
        native = proxied = 0.0
        try:
            vsamples = _scrape(sv.http)
        except Exception as e:
            problems.append(f"{sv.id}: metrics unreachable ({e})")
            lines.append(f"node {sv.id} dc={sv.dc} rack={sv.rack}:"
                         " metrics unreachable")
            continue
        note_alerts(vsamples)
        for name, labels, value in vsamples:
            # the `server` label scopes series to this node when several
            # servers share one process registry (test clusters)
            if labels.get("server", sv.id) != sv.id:
                continue
            if name == "SeaweedFS_volume_disk_used_bytes":
                disk_used += value
            elif name == "SeaweedFS_volume_disk_free_bytes":
                disk_free += value
            elif name == "SeaweedFS_volume_fastlane_requests_total":
                native += value
            elif name == "SeaweedFS_volume_fastlane_proxied_total":
                proxied += value
        total = native + proxied
        rate = f"{100.0 * native / total:.1f}%" if total else "n/a"
        age = hb_age.get(sv.id)
        lines.append(
            f"node {sv.id} dc={sv.dc} rack={sv.rack}: "
            f"disk {_fmt_gb(disk_used)} used / {_fmt_gb(disk_free)} free, "
            f"free_slots={free_slots.get(sv.id, sv.free_slots()):g}, "
            f"heartbeat {f'{age:.1f}s ago' if age is not None else 'n/a'}, "
            f"fastlane native {rate}"
            f" ({native:g} native / {proxied:g} proxied)"
        )

    # alerts fire per PROCESS: in a multi-process cluster the filer/s3
    # engines are separate. When the master's telemetry aggregator is
    # live, ONE fetch covers them all — every sender's frame carries its
    # current alert edges, and the cluster-scope rules (merged SLO burn,
    # stale senders) only exist there. Fall back to fanning out
    # /debug/alerts across every discovered endpoint otherwise (the
    # filer's catch-all main port has no /metrics, but its debug routes
    # shadow file paths).
    tele = _fetch_cluster_telemetry(env)
    if tele is not None:
        senders = tele.get("senders") or {}
        stale = sorted(n for n, s in senders.items() if s.get("stale"))
        lines.append(
            f"telemetry: one-fetch master aggregate, {len(senders)}"
            f" sender(s)" + (f", {len(stale)} stale ({', '.join(stale)})"
                             if stale else ""))
        for name, info in (tele.get("alerts") or {}).items():
            if firing_alerts.get(name) != "critical":
                firing_alerts[name] = info.get("severity", "warning")
        for s in senders.values():
            for a in s.get("alerts") or ():
                name = a.get("alert", "?")
                if firing_alerts.get(name) != "critical":
                    firing_alerts[name] = a.get("severity", "warning")
    else:
        seen = {env.master_url} | {sv.http for sv in servers}
        for ep in sorted(_discover_endpoints(env, flags.get("include", ""),
                                             servers=servers) - seen):
            try:
                out = env.get(f"{ep}/debug/alerts", timeout=10)
            except Exception:
                continue  # an unreachable gateway must not sink the check
            for a in out.get("alerts", []):
                if a.get("firing"):
                    name = a.get("name", "?")
                    if firing_alerts.get(name) != "critical":
                        firing_alerts[name] = a.get("severity", "warning")

    for alert, sev in sorted(firing_alerts.items()):
        if sev == "critical":
            problems.append(
                f"alert {alert} firing [critical] (see /debug/alerts)"
            )
        else:
            lines.append(f"warning: alert {alert} firing (see /debug/alerts)")

    if problems:
        lines.append(f"{len(problems)} problem(s):")
        lines.extend("  " + p for p in problems)
        report = "\n".join(lines)
        if fail_mode:
            raise ShellError(report)
        return report
    lines.append("cluster is healthy")
    return "\n".join(lines)




def _fetch_concurrently(endpoints, fetch) -> None:
    """Run fetch(ep) for every endpoint on daemon threads and join. The
    shared fan-out under cluster.profile / cluster.top: each fetch
    swallows its own failures (an unreachable node must not sink the
    cluster view) and the wall-clock window stays simultaneous."""
    import threading as _threading

    threads = [
        _threading.Thread(target=fetch, args=(ep,), daemon=True)
        for ep in sorted(endpoints)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()




@command("cluster.trace",
         "[-limit n] [-minMs n] [-include url,url] — fetch /debug/traces"
         " from master + volume servers + filers (+ -include'd endpoints,"
         " e.g. s3 gateways) and render merged span trees")
def cmd_cluster_trace(env: CommandEnv, args: list[str]) -> str:
    """Cluster-wide trace view: every node keeps its own span ring; this
    merges them by trace id into one tree per request (the multi-process
    counterpart of the single-process ring in stats/trace.py). S3 gateways
    don't register with the master, so pass them via -include to get the
    [s3] root spans in a multi-process cluster."""
    import math

    flags = parse_flags(args)
    try:
        limit = int(flags.get("limit", 10))
        min_ms = float(flags.get("minMs", 0))
        if not math.isfinite(min_ms):
            raise ValueError(min_ms)
    except ValueError:
        raise ShellError(
            "usage: cluster.trace [-limit n] [-minMs n] [-include url,url]"
        )

    endpoints = _discover_endpoints(env, flags.get("include", ""))

    # trace_id -> span_id -> span; single-process clusters share one ring,
    # so keying by span id dedups identical copies from every endpoint
    merged: dict[str, dict[str, dict]] = {}
    reached = []
    # fetch deep with min_ms=0: node-side min_ms would drop a node's
    # fast child spans out of a slow cross-node trace, and a shallow
    # fetch would hide older slow traces behind recent fast ones — the
    # -minMs filter applies AFTER the merge, on whole-trace duration
    per_node = max(limit * 10, 100)
    for ep in sorted(endpoints):
        try:
            out = env.get(
                f"{ep}/debug/traces?limit={per_node}&min_ms=0",
                timeout=10,
            )
        except Exception:
            continue
        reached.append(ep)
        for tr in out.get("traces", []):
            slot = merged.setdefault(tr["trace_id"], {})
            for sp in tr["spans"]:
                slot[sp["span_id"]] = sp
    if not reached:
        raise ShellError("no /debug/traces endpoint reachable")

    def render_tree(spans: list[dict]) -> list[str]:
        ids = {s["span_id"] for s in spans}
        children: dict[str, list[dict]] = {}
        roots = []
        for s in sorted(spans, key=lambda s: s["start"]):
            if s["parent_id"] in ids:
                children.setdefault(s["parent_id"], []).append(s)
            else:
                roots.append(s)
        lines: list[str] = []

        def walk(s: dict, depth: int) -> None:
            lines.append(
                f"{'  ' * depth}[{s.get('role') or '-'}] {s['name']} "
                f"{s['duration_ms']}ms {s['status']}"
            )
            for c in children.get(s["span_id"], []):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 1)
        return lines

    rows = []
    for trace_id, by_id in merged.items():
        spans = list(by_id.values())
        start = min(s["start"] for s in spans)
        end = max(s["start"] + s["duration_ms"] / 1000.0 for s in spans)
        rows.append((start, (end - start) * 1000.0, trace_id, spans))
    rows.sort(reverse=True)
    out_lines = [f"merged traces from {len(reached)} endpoint(s)"]
    shown = 0
    for start, dur_ms, trace_id, spans in rows:
        if dur_ms < min_ms:
            continue
        if shown >= limit:
            break
        shown += 1
        roles = sorted({s["role"] for s in spans if s.get("role")})
        out_lines.append(
            f"trace {trace_id} {dur_ms:.1f}ms roles={','.join(roles)}"
        )
        out_lines.extend(render_tree(spans))
    if shown == 0:
        out_lines.append("no traces recorded (min_ms too high?)")
    return "\n".join(out_lines)


@command("cluster.profile",
         "[-seconds n] [-hz n] [-include url,url] [-out path] — sample every"
         " node's Python stacks concurrently (/debug/pprof/profile) and"
         " merge them, role-prefixed, into one flamegraph-ready"
         " collapsed-stack output")
def cmd_cluster_profile(env: CommandEnv, args: list[str]) -> str:
    """Cluster-wide CPU attribution: every reachable node samples itself
    for the same window (the fetches run concurrently — the window is
    wall-clock, so serial fetches would profile different moments), and
    the collapsed stacks merge under a per-role root (`master;...`,
    `volume;...`) so one flamegraph splits by role first. Several roles
    sharing one interpreter dedup by process identity — their stacks merge
    once, under a combined `role+role;` root, instead of counting the same
    process once per role. Feed the -out file to flamegraph.pl or
    speedscope as-is."""
    import math

    flags = parse_flags(args)
    try:
        seconds = float(flags.get("seconds", 2))
        hz = int(flags.get("hz", 100))
        if not math.isfinite(seconds) or seconds <= 0:
            raise ValueError(seconds)
    except ValueError:
        raise ShellError(
            "usage: cluster.profile [-seconds n] [-hz n] [-include url,url]"
            " [-out path]"
        )

    endpoints = _discover_endpoints(env, flags.get("include", ""))
    results: dict[str, dict] = {}

    def fetch(ep: str) -> None:
        try:
            results[ep] = env.get(
                f"{ep}/debug/pprof/profile?seconds={seconds:g}&hz={hz}"
                "&format=json",
                timeout=seconds + 30,
            )
        except Exception:
            pass

    _fetch_concurrently(endpoints, fetch)
    if not results:
        raise ShellError("no /debug/pprof/profile endpoint reachable")

    # group endpoints by process identity: in a single-process cluster
    # every role's endpoint sampled the SAME interpreter, and merging each
    # copy would multiply sample counts and attribute every role's threads
    # to every role (cluster.trace's span-id dedup, process-level)
    by_proc: dict[str, list[str]] = {}
    for ep in sorted(results):
        by_proc.setdefault(results[ep].get("proc") or ep, []).append(ep)
    merged: dict[str, int] = {}
    total_samples = 0
    for token in sorted(by_proc):
        eps = by_proc[token]
        roles = sorted({results[ep].get("role") or "node" for ep in eps})
        best = max(eps, key=lambda ep: int(results[ep].get("samples", 0)))
        out = results[best]
        prof_mod.merge_collapsed(
            merged, out.get("stacks", {}), prefix="+".join(roles)
        )
        total_samples += int(out.get("samples", 0))
    body = prof_mod.render_collapsed(merged)
    header = (
        f"profiled {len(results)}/{len(endpoints)} endpoint(s)"
        f" ({len(by_proc)} process(es)) for"
        f" {seconds:g}s @ {hz}Hz: {total_samples} samples,"
        f" {len(merged)} distinct stacks"
    )
    if "out" in flags:
        with open(flags["out"], "w") as f:
            f.write(body + "\n")
        return header + f"\ncollapsed stacks written to {flags['out']}"
    return header + "\n" + body


def _fmt_bytes_rate(n: float | None) -> str:
    if not n:
        return "-"
    for unit, div in (("GB/s", 1e9), ("MB/s", 1e6), ("KB/s", 1e3)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n:.0f}B/s"


def _fmt_uptime(sec: float | None) -> str:
    if sec is None or sec < 0:
        return "-"
    sec = int(sec)
    if sec >= 86400:
        return f"{sec // 86400}d{(sec % 86400) // 3600}h"
    if sec >= 3600:
        return f"{sec // 3600}h{(sec % 3600) // 60}m"
    if sec >= 60:
        return f"{sec // 60}m{sec % 60}s"
    return f"{sec}s"


@command("cluster.top",
         "[-once] [-interval 2] [-window 60] [-count n] [-include url,url]"
         " [-spool dir] [-snapshot file] — live dashboard: per-role"
         " request rates, 5xx%, p99, bytes/s, front-door native ratio,"
         " uptime and firing alerts from every node's history ring. -once"
         " renders a single frame and returns; -spool appends a dead"
         " process's rate history from its telemetry spool; -snapshot"
         " dumps one frame's cluster state as JSON")
def cmd_cluster_top(env: CommandEnv, args: list[str]) -> str:
    """The rates-over-time view cluster.check can't give: every reachable
    node serves its self-scraped history ring (/debug/metrics/history)
    and alert state (/debug/alerts); this fetches all of them
    CONCURRENTLY, dedups endpoints sharing one process (single-process
    clusters expose every role's series at every port), aggregates
    per-role request/error/byte rates, interpolates p99 from windowed
    bucket rates, and renders one table plus the firing alerts. Without
    -once it redraws every -interval seconds until -count frames (or
    Ctrl-C)."""
    import math
    import time as _time

    flags = parse_flags(args)
    try:
        interval = float(flags.get("interval", 2.0))
        window = float(flags.get("window", 60.0))
        count = int(flags.get("count", 0))
        if not math.isfinite(interval) or interval <= 0:
            raise ValueError(interval)
        if not math.isfinite(window) or window <= 0:
            raise ValueError(window)
    except ValueError:
        raise ShellError(
            "usage: cluster.top [-once] [-interval n] [-window n]"
            " [-count n] [-include url,url]"
        )
    # -snapshot implies -once: the JSON artifact is one frame's state
    once = "once" in flags or "snapshot" in flags
    spool_dir = flags.get("spool", "").strip()

    # endpoint discovery is cached ACROSS watch frames: re-walking
    # /dir/status + /cluster/ps every redraw turns a 30-node watch
    # session into a topology-hammering loop. The cache is invalidated
    # only when an endpoint fails to answer, so a node that moved (new
    # port, restart) heals on the next frame.
    cache: dict = {"endpoints": None}

    def frame() -> str:
        endpoints = cache["endpoints"]
        if not endpoints:
            endpoints = cache["endpoints"] = _discover_endpoints(
                env, flags.get("include", ""))
        hist_res: dict[str, dict] = {}
        alert_res: dict[str, dict] = {}

        def fetch(ep: str) -> None:
            try:  # samples=0: rates + last values only, no raw points
                hist_res[ep] = env.get(
                    f"{ep}/debug/metrics/history?window={window:g}&samples=0",
                    timeout=10,
                )
            except Exception:
                return  # an unreachable node must not sink the view
            try:
                alert_res[ep] = env.get(
                    f"{ep}/debug/alerts?window={window:g}", timeout=10
                )
            except Exception:
                pass

        _fetch_concurrently(endpoints, fetch)
        if len(hist_res) < len(endpoints):
            cache["endpoints"] = None  # refetch topology next frame
        if not hist_res and not spool_dir:
            raise ShellError("no /debug/metrics/history endpoint reachable")

        # cluster-rollup header: the master aggregate's merged view
        # (global rates, top tenants WITH error bars, burning cluster
        # SLOs) — one extra fetch, not one per node (skipped in
        # spool-only post-mortem mode: the cluster is dead)
        tele = _fetch_cluster_telemetry(env) if hist_res else None

        # one representative endpoint per process (cluster.profile's dedup)
        by_proc: dict[str, str] = {}
        for ep in sorted(hist_res):
            by_proc.setdefault(hist_res[ep].get("proc") or ep, ep)

        now = _time.time()
        roles: dict[str, dict] = {}
        # tenants/heat ride the SAME history fetch: the usage and heat
        # collectors export into each process's ring, so no extra RPCs
        tenants: dict[str, dict] = {}
        heat_vols: dict[tuple, float] = {}
        days_full: dict[tuple, float] = {}

        def row(role: str) -> dict:
            return roles.setdefault(role, {
                "req_s": 0.0, "err_s": 0.0, "bytes_s": 0.0,
                "fr_native": 0.0, "fr_fb": 0.0,
                "buckets": {}, "uptime": None, "version": None,
            })

        def tenant(coll: str) -> dict:
            return tenants.setdefault(coll, {
                "req_s": 0.0, "in_s": 0.0, "out_s": 0.0, "err_s": 0.0,
            })

        # qos admission plane (qos/admission.py): per-class admit/queue/
        # shed rates + the tenants being shed, off the same history fetch
        qos_cls: dict[str, dict] = {}
        qos_shed_colls: dict[str, float] = {}

        def qrow(cls: str) -> dict:
            return qos_cls.setdefault(cls, {
                "admit_s": 0.0, "queue_s": 0.0, "shed_s": 0.0,
            })

        for token in sorted(by_proc):
            series = hist_res[by_proc[token]].get("series", [])
            start_ts = None
            proc_roles: set[str] = set()
            version = None
            for s in series:
                fam = s.get("family", "")
                labels = s.get("labels", {})
                rate = s.get("rate")
                if fam == "SeaweedFS_http_request_total" and rate:
                    r = row(labels.get("role", "?"))
                    r["req_s"] += rate
                    if labels.get("code", "").startswith("5"):
                        r["err_s"] += rate
                elif fam == "SeaweedFS_http_request_seconds_bucket" and rate:
                    le = labels.get("le", "")
                    bound = float("inf") if le == "+Inf" else float(le)
                    b = row(labels.get("role", "?"))["buckets"]
                    b[bound] = b.get(bound, 0.0) + rate
                elif fam == "SeaweedFS_volume_fastlane_bytes_total" and rate:
                    row("volume")["bytes_s"] += rate
                elif fam in ("SeaweedFS_filer_fastlane_native_total",
                             "SeaweedFS_s3_fastlane_native_total") and rate:
                    role = "filer" if "filer" in fam else "s3"
                    row(role)["fr_native"] += rate
                elif fam in ("SeaweedFS_filer_fastlane_fallback_total",
                             "SeaweedFS_s3_fastlane_fallback_total") and rate:
                    role = "filer" if "filer" in fam else "s3"
                    row(role)["fr_fb"] += rate
                elif fam == "SeaweedFS_usage_requests_total" and rate:
                    tenant(labels.get("collection", "?"))["req_s"] += rate
                elif fam == "SeaweedFS_usage_bytes_in_total" and rate:
                    tenant(labels.get("collection", "?"))["in_s"] += rate
                elif fam == "SeaweedFS_usage_bytes_out_total" and rate:
                    tenant(labels.get("collection", "?"))["out_s"] += rate
                elif fam == "SeaweedFS_usage_errors_total" and rate:
                    tenant(labels.get("collection", "?"))["err_s"] += rate
                elif fam == "SeaweedFS_qos_admitted_total" and rate:
                    qrow(labels.get("class", "?"))["admit_s"] += rate
                elif fam == "SeaweedFS_qos_queued_total" and rate:
                    qrow(labels.get("class", "?"))["queue_s"] += rate
                elif fam == "SeaweedFS_qos_shed_total" and rate:
                    qrow(labels.get("class", "?"))["shed_s"] += rate
                    coll = labels.get("collection", "?")
                    qos_shed_colls[coll] = \
                        qos_shed_colls.get(coll, 0.0) + rate
                elif fam == "SeaweedFS_volume_heat_score":
                    key = (labels.get("server", "?"),
                           labels.get("volume", "?"))
                    heat_vols[key] = max(heat_vols.get(key, 0.0),
                                         s.get("last") or 0.0)
                elif fam == "SeaweedFS_node_days_to_full":
                    key = (labels.get("node", "?"), labels.get("dir", "?"))
                    v = s.get("last")
                    if v is not None:
                        days_full[key] = min(days_full.get(key, v), v)
                elif fam == "SeaweedFS_process_start_time_seconds":
                    start_ts = s.get("last")
                elif fam == "SeaweedFS_build_info":
                    proc_roles.add(labels.get("role", "?"))
                    version = labels.get("version")
            for role in proc_roles:
                r = row(role)
                if start_ts:
                    up = now - start_ts
                    r["uptime"] = max(r["uptime"] or 0.0, up)
                if version and not r["version"]:
                    r["version"] = version

        firing: dict[str, dict] = {}
        slo_rows: dict[str, dict] = {}
        seen_procs: set[str] = set()
        for ep in sorted(alert_res):
            token = alert_res[ep].get("proc") or ep
            if token in seen_procs:
                continue
            seen_procs.add(token)
            for a in alert_res[ep].get("alerts", []):
                if a.get("firing"):
                    firing.setdefault(a["name"], a)
            # per-slo burn: the worst process's reading wins (one slow
            # filer is the story, not the fleet average)
            for name, s in (alert_res[ep].get("slos") or {}).items():
                cur = slo_rows.setdefault(name, dict(s))
                for k in ("burn_fast", "burn_slow"):
                    v = s.get(k)
                    if v is not None and (cur.get(k) is None
                                          or v > cur[k]):
                        cur[k] = v

        # p99 exemplars (histogram bucket -> trace id): per role, the
        # slowest sample's trace INSIDE the window — the p99 row's "go
        # look" link. Exemplars never expire server-side (freshest per
        # bucket), so without the ts filter one old multi-second request
        # would pin the column to a long-evicted trace forever.
        exemplar: dict[str, dict] = {}
        cutoff = _time.time() - window
        for token in sorted(by_proc):
            ex = hist_res[by_proc[token]].get("exemplars") or {}
            for e in ex.get("SeaweedFS_http_request_seconds", []):
                if e.get("ts", 0) < cutoff:
                    continue
                role = e.get("labels", {}).get("role", "?")
                cur = exemplar.get(role)
                if cur is None or e.get("value", 0) > cur.get("value", 0):
                    exemplar[role] = e

        # -snapshot rides the render pass: the same numbers the table
        # shows, pre-formatting, so the JSON artifact and the terminal
        # frame can never disagree
        snap: dict = {
            "ts": now,
            "master": env.master_url,
            "window": window,
            "processes": len(by_proc),
            "endpoints": len(hist_res),
            "cluster_telemetry": tele,
            "roles": {},
            "tenants": tenants,
            "heat": [
                {"server": srv, "volume": vid, "score": score}
                for (srv, vid), score in sorted(heat_vols.items(),
                                                key=lambda kv: -kv[1])
            ],
            "days_to_full": [
                {"node": node, "dir": d, "days": days}
                for (node, d), days in sorted(days_full.items(),
                                              key=lambda kv: kv[1])
            ],
            "slos": slo_rows,
            "alerts_firing": firing,
            "qos": {
                "classes": qos_cls,
                "top_shed": [
                    {"collection": coll, "shed_s": r}
                    for coll, r in sorted(qos_shed_colls.items(),
                                          key=lambda kv: -kv[1])
                ],
            },
        }
        cache["snap"] = snap
        lines = [
            f"cluster.top @ {env.master_url}  window={window:g}s  "
            f"{len(by_proc)} process(es), {len(hist_res)} endpoint(s)",
        ]
        if tele is not None:
            rates = tele.get("rates") or {}
            total_req = sum(r.get("req_rate", 0.0) for r in rates.values())
            total_err = sum(r.get("err_rate", 0.0) for r in rates.values())
            err_pct = 100.0 * total_err / total_req if total_req else 0.0
            senders = tele.get("senders") or {}
            n_stale = sum(1 for s in senders.values() if s.get("stale"))
            bits = [
                f"cluster: {total_req:.1f} req/s  5xx {err_pct:.2f}%  "
                f"senders {len(senders)}"
                + (f" ({n_stale} stale)" if n_stale else "")
            ]
            top3 = (tele.get("usage") or {}).get("tenants") or []
            if top3:
                bits.append("top tenants: " + ", ".join(
                    f"{t['collection']}"
                    f" {t.get('requests', 0):.0f}"
                    f"±{t.get('requests_err', 0):.0f}"
                    for t in top3[:3]))
            burning = sorted(
                name for name in (tele.get("alerts") or {})
                if name.startswith("cluster_slo_burn"))
            bits.append("burning: " + (", ".join(burning) or "none"))
            lines.append("  ".join(bits))
        lines.append(
            f"{'role':<10} {'req/s':>9} {'5xx%':>7} {'p99 ms':>9}"
            f" {'bytes/s':>10} {'front%':>7} {'uptime':>8}  version"
            f"  p99-trace"
        )
        for role in sorted(roles):
            r = roles[role]
            qflags: dict = {}
            p99 = quantile_from_bucket_rates(r["buckets"], 0.99,
                                             flags=qflags)
            # inf_mass: the p99 fell in the +Inf bucket — the clamped
            # value is a lower bound, rendered ">x", never "=x"
            if p99 is None:
                p99_txt = "n/a"
            elif qflags.get("inf_mass"):
                p99_txt = f">{p99 * 1e3:.0f}"
            else:
                p99_txt = f"{p99 * 1e3:.2f}"
            err_pct = (
                f"{100.0 * r['err_s'] / r['req_s']:.1f}" if r["req_s"] else "-"
            )
            # front-door ratio: share of data-plane-shaped requests the
            # filer/S3 engine served without touching Python
            fr_total = r["fr_native"] + r["fr_fb"]
            front = (
                f"{100.0 * r['fr_native'] / fr_total:.1f}" if fr_total else "-"
            )
            ex = exemplar.get(role)
            snap["roles"][role] = {
                "req_s": r["req_s"], "err_s": r["err_s"],
                "bytes_s": r["bytes_s"],
                "p99_s": p99,
                "p99_lower_bound": bool(qflags.get("inf_mass")),
                "front_native": r["fr_native"], "front_fallback": r["fr_fb"],
                "uptime_s": r["uptime"], "version": r["version"],
                "p99_trace": ex["trace_id"] if ex else None,
            }
            lines.append(
                f"{role:<10} {r['req_s']:>9.1f} {err_pct:>7}"
                f" {p99_txt:>9}"
                f" {_fmt_bytes_rate(r['bytes_s']):>10}"
                f" {front:>7}"
                f" {_fmt_uptime(r['uptime']):>8}  {r['version'] or '-'}"
                f"  {ex['trace_id'] if ex else '-'}"
            )
        if not roles:
            lines.append("(no rates yet — the history ring needs two"
                         " scrapes inside the window)")
        if tenants:
            top5 = sorted(tenants.items(),
                          key=lambda kv: -kv[1]["req_s"])[:5]
            lines.append("tenants (top by req/s):")
            for coll, t in top5:
                lines.append(
                    f"  {coll:<20} {t['req_s']:>8.1f}/s"
                    f"  in={_fmt_bytes_rate(t['in_s'])}"
                    f"  out={_fmt_bytes_rate(t['out_s'])}"
                    + (f"  err={t['err_s']:.2f}/s" if t["err_s"] else "")
                )
        if qos_cls:
            lines.append("qos (admitted/queued/shed per class):")
            order = [c for c in PRIORITY_CLASSES if c in qos_cls] + sorted(
                c for c in qos_cls if c not in PRIORITY_CLASSES)
            for cls in order:
                q = qos_cls[cls]
                lines.append(
                    f"  {cls:<12} {q['admit_s']:>8.1f}/s"
                    f"  queued={q['queue_s']:.2f}/s"
                    f"  shed={q['shed_s']:.2f}/s")
            top_shed = sorted(qos_shed_colls.items(),
                              key=lambda kv: -kv[1])[:3]
            if top_shed:
                lines.append("  top shed tenants: " + ", ".join(
                    f"{coll} {r:.2f}/s" for coll, r in top_shed))
        if heat_vols or days_full:
            bits = []
            if heat_vols:
                hot = sorted(heat_vols.items(), key=lambda kv: -kv[1])[:3]
                bits.append("hottest " + ", ".join(
                    f"{srv} v{vid}={score:.1f}"
                    for (srv, vid), score in hot))
            if days_full:
                soon = sorted(days_full.items(), key=lambda kv: kv[1])[:3]
                bits.append("days-to-full " + ", ".join(
                    f"{node} {d}={days:.1f}d"
                    for (node, d), days in soon))
            lines.append("heat: " + "; ".join(bits))
        if slo_rows:
            lines.append("slo error-budget burn (x sustainable;"
                         " fast/slow window):")
            for name in sorted(slo_rows):
                s = slo_rows[name]
                fast, slow = s.get("burn_fast"), s.get("burn_slow")
                obj = s.get("objective", 0.0)
                lines.append(
                    f"  {name:<24} obj={obj:.3%}"
                    f"  fast={'-' if fast is None else f'{fast:.2f}x'}"
                    f"  slow={'-' if slow is None else f'{slow:.2f}x'}"
                )
        if firing:
            lines.append(f"{len(firing)} alert(s) firing:")
            for name in sorted(firing):
                a = firing[name]
                lines.append(
                    f"  [{a.get('severity', '?')}] {name}:"
                    f" {a.get('detail', '')}"
                )
        else:
            lines.append("no alerts firing")
        if spool_dir:
            # post-mortem: the dead process's rate history, straight off
            # its telemetry spool's segment files — no live endpoint
            try:
                info = store_mod.spool_info(spool_dir)
                series = store_mod.read_series(
                    spool_dir, "SeaweedFS_http_request_total",
                    tiers=("raw", "1m"))
            except OSError as e:
                raise ShellError(f"spool {spool_dir}: {e}")
            total = sum(t.get("bytes", 0) for t in info.values())
            rates: dict[str, float] = {}
            t_lo = t_hi = None
            for (_fam, labels), pts in sorted(series.items()):
                if len(pts) < 2:
                    continue
                (ta, va), (tb, vb) = pts[0], pts[-1]
                t_lo = ta if t_lo is None else min(t_lo, ta)
                t_hi = tb if t_hi is None else max(t_hi, tb)
                if tb > ta and vb >= va:  # counter reset inside: skip
                    role = dict(labels).get("role", "?")
                    rates[role] = rates.get(role, 0.0) \
                        + (vb - va) / (tb - ta)
            lines.append(
                f"post-mortem spool {spool_dir}: " + "  ".join(
                    f"{t}={info[t]['bytes']}B/{info[t]['segments']}seg"
                    for t, _, _ in store_mod.TIERS)
                + f"  total={total}B")
            if t_lo is not None:
                lines.append(
                    f"  request counters cover {t_hi - t_lo:.0f}s;"
                    " req/s by role: "
                    + (", ".join(f"{role}={v:.2f}"
                                 for role, v in sorted(rates.items()))
                       or "n/a"))
            else:
                lines.append("  no request-counter history in spool")
            snap["spool"] = {
                "dir": spool_dir, "tiers": info, "total_bytes": total,
                "req_rates": rates,
                "covers_seconds": (t_hi - t_lo) if t_lo is not None
                else 0.0,
            }
        return "\n".join(lines)

    if once:
        body = frame()
        if "snapshot" in flags:
            import json as _json

            with open(flags["snapshot"], "w") as f:
                _json.dump(cache["snap"], f, indent=2, sort_keys=True,
                           default=str)
                f.write("\n")
            return body + f"\nsnapshot json written to {flags['snapshot']}"
        return body
    shown = 0
    try:
        while True:
            # clear + home, like top(1); endpoints come from the cached
            # discovery (refreshed only after a failed fetch). A transient
            # fetch failure (master restarting, network blip) renders as a
            # frame and the watch keeps going — only Ctrl-C (or -count)
            # ends it, like top(1).
            try:
                body = frame()
            except ShellError as e:
                body = f"cluster.top @ {env.master_url}: {e} (retrying)"
            print("\x1b[2J\x1b[H" + body, flush=True)
            shown += 1
            if count > 0 and shown >= count:
                break
            _time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return f"cluster.top stopped after {shown} frame(s)"


@command("cluster.heat",
         "[-n 10] [-include url,url] [-out path] — the cluster's thermal"
         " picture: top-K tenants from the bounded usage sketch (with its"
         " error bound), hottest/coldest volumes by heat score, collection"
         "/node rollups, per-node days-to-full forecasts")
def cmd_cluster_heat(env: CommandEnv, args: list[str]) -> str:
    """Who is using the cluster and where the heat is: every node serves
    its bounded-cardinality tenant sketch (/debug/usage) and heat/forecast
    view (/debug/heat); this fetches all of them concurrently, dedups
    endpoints sharing a process, sums tenant counts across processes
    (each process sketches its own traffic), and renders one report.
    Sketch counts are approximate above the exported error bound — the
    header says by how much."""
    flags = parse_flags(args)
    try:
        n = int(flags.get("n", 10))
        if n < 1:
            raise ValueError(n)
    except ValueError:
        raise ShellError(
            "usage: cluster.heat [-n k] [-include url,url] [-out path]")

    endpoints = _discover_endpoints(env, flags.get("include", ""))
    usage_res: dict[str, dict] = {}
    heat_res: dict[str, dict] = {}

    def fetch(ep: str) -> None:
        try:
            usage_res[ep] = env.get(f"{ep}/debug/usage", timeout=10)
        except Exception:
            return  # an unreachable node must not sink the view
        try:
            heat_res[ep] = env.get(f"{ep}/debug/heat", timeout=10)
        except Exception:
            pass

    _fetch_concurrently(endpoints, fetch)
    if not usage_res:
        raise ShellError("no /debug/usage endpoint reachable")

    dims = ("requests", "bytes_in", "bytes_out", "errors")
    tenants: dict[str, dict] = {}
    other = {d: 0.0 for d in dims}
    error_bound, k, evictions = 0.0, None, 0
    seen: set[str] = set()
    for ep in sorted(usage_res):
        out = usage_res[ep]
        token = out.get("proc") or ep
        if token in seen:
            continue
        seen.add(token)
        for row in out.get("tenants", []):
            t = tenants.setdefault(
                row.get("collection", "?"),
                {d: 0.0 for d in dims} | {d + "_err": 0.0 for d in dims})
            for d in dims:
                t[d] += float(row.get(d, 0) or 0)
                t[d + "_err"] += float(row.get(d + "_err", 0) or 0)
        for d, v in (out.get("other") or {}).items():
            if d in other:
                other[d] += float(v or 0)
        error_bound = max(error_bound, float(out.get("error_bound") or 0))
        evictions += int(out.get("evictions") or 0)
        k = out.get("k", k)

    vols: dict[tuple, dict] = {}
    forecast: dict[tuple, float] = {}
    coll_scores: dict[str, float] = {}
    node_scores: dict[str, float] = {}
    seen_heat: set[str] = set()
    for ep in sorted(heat_res):
        out = heat_res[ep]
        token = out.get("proc") or ep
        if token in seen_heat:
            continue
        seen_heat.add(token)
        for v in out.get("volumes", []):
            key = (v.get("server", "?"), str(v.get("volume", "?")))
            cur = vols.get(key)
            if cur is None or v.get("score", 0) > cur.get("score", 0):
                vols[key] = v
        for f in out.get("forecast", []):
            key = (f.get("node", "?"), f.get("dir", "?"))
            d = float(f.get("days_to_full", 0) or 0)
            forecast[key] = min(forecast.get(key, d), d)
        for c in out.get("collections", []):
            name = c.get("collection", "?")
            coll_scores[name] = max(coll_scores.get(name, 0.0),
                                    float(c.get("score", 0) or 0))
        for nd in out.get("nodes", []):
            name = nd.get("node", "?")
            node_scores[name] = max(node_scores.get(name, 0.0),
                                    float(nd.get("score", 0) or 0))

    lines = [
        f"cluster.heat @ {env.master_url}  {len(seen)} process(es),"
        f" {len(usage_res)} endpoint(s)"
        + (f"  sketch K={k}" if k is not None else "")
        + f"  error bound <= {error_bound:g}"
        + (f"  ({evictions} eviction(s) into _other)" if evictions else ""),
        f"tenants (top {n} by requests; counts approximate above the"
        f" error bound):",
        f"  {'collection':<20} {'requests':>12} {'bytes in':>12}"
        f" {'bytes out':>12} {'errors':>8}",
    ]
    top = sorted(tenants.items(), key=lambda kv: -kv[1]["requests"])[:n]
    for coll, t in top:
        err = t["requests_err"]
        req = f"{t['requests']:g}" + (f"±{err:g}" if err else "")
        lines.append(
            f"  {coll:<20} {req:>12} {t['bytes_in']:>12g}"
            f" {t['bytes_out']:>12g} {t['errors']:>8g}")
    if any(other.values()):
        lines.append(
            f"  {'_other':<20} {other['requests']:>12g}"
            f" {other['bytes_in']:>12g} {other['bytes_out']:>12g}"
            f" {other['errors']:>8g}")
    if not tenants:
        lines.append("  (no tenant traffic accounted yet)")

    if vols:
        ranked = sorted(vols.values(), key=lambda v: -v.get("score", 0))
        lines.append(f"hottest volumes (of {len(ranked)} scored):")
        for v in ranked[:n]:
            lines.append(
                f"  {v.get('server', '?')} v{v.get('volume', '?')}"
                f" score={v.get('score', 0):g}"
                + ("  HOT" if v.get("hot") else ""))
        coldest = [v for v in reversed(ranked)][:min(n, 3)]
        if len(ranked) > n:
            lines.append("coldest:")
            for v in coldest:
                lines.append(
                    f"  {v.get('server', '?')} v{v.get('volume', '?')}"
                    f" score={v.get('score', 0):g}")
    if coll_scores:
        lines.append("collection heat (master rollup, ops/s):")
        for name, score in sorted(coll_scores.items(),
                                  key=lambda kv: -kv[1])[:n]:
            lines.append(f"  {name:<20} {score:g}")
    if node_scores:
        lines.append("node heat (ops/s): " + "  ".join(
            f"{name}={score:g}" for name, score in sorted(
                node_scores.items(), key=lambda kv: -kv[1])[:n]))
    if forecast:
        lines.append("days-to-full (linear fit over the disk-usage ring):")
        for (node, d), days in sorted(forecast.items(),
                                      key=lambda kv: kv[1])[:n]:
            lines.append(f"  {node} {d}: {days:.1f}d")
    else:
        lines.append("days-to-full: no positive fill trend"
                     " (nothing filling up)")

    body = "\n".join(lines)
    if "out" in flags:
        with open(flags["out"], "w") as f:
            f.write(body + "\n")
        return lines[0] + f"\nreport written to {flags['out']}"
    return body


def _why_describe(ev: dict) -> str:
    """One flight-recorder event as a timeline row body."""
    parts = [ev["type"]]
    for k in ("task", "volume", "node"):
        if ev.get(k) is not None:
            parts.append(f"{k}={ev[k]}")
    for k, v in sorted((ev.get("attrs") or {}).items()):
        parts.append(f"{k}={v}")
    if ev.get("trace_id"):
        parts.append(f"trace={ev['trace_id']}")
    return " ".join(str(p) for p in parts)


@command("cluster.why",
         "<trace-id|volume-id|collection> [-window 600] [-limit 2048]"
         " [-include url,url] [-spool dir,dir] [-out file] — assemble one"
         " causally-ordered cross-node timeline from every node's flight"
         " recorder (/debug/events) + trace ring: request span, degraded"
         " read, injected fault, alert edges, repair task lifecycle, heal."
         " -spool folds in a dead process's on-disk journal; -out dumps"
         " the timeline as JSON for a bug report")
def cmd_cluster_why(env: CommandEnv, args: list[str]) -> str:
    """The question the disconnected counters never answered: WHY was
    this read degraded / WHAT healed this volume. Given a trace id, the
    verb pulls the trace's spans and trace-keyed events from every node,
    widens to the volumes those events name, and folds in each volume's
    fault/alert/task/heal events inside the window; given a volume id it
    renders that volume's whole incident timeline; anything else is a
    collection (tenant) name — events carrying that collection
    correlation key (degraded reads, scrub findings, repair lifecycle,
    usage-sketch overflow, qos_shed admission rejections) assemble into
    a per-tenant timeline, so "why is tenant X seeing 429s" reads as
    the shed events next to whatever else hit that tenant. Events
    are deduped by (process token, seq) — single-process test clusters
    expose one ring at every port.

    Post-mortem: `-spool <dir>` reads a telemetry spool's event journal
    straight off its segment files (stats/store.py), so the timeline of
    a process that is still DEAD — crashed, not restarted — assembles
    next to whatever the live nodes remember."""
    import math
    import re as _re

    flags = parse_flags(args)
    target = flags.get("", "").strip()
    if not target:
        raise ShellError(
            "usage: cluster.why <trace-id|volume-id|collection>"
            " [-window n] [-include url,url]")
    try:
        window = float(flags.get("window", 600.0))
        limit = int(flags.get("limit", 2048))
        if not math.isfinite(window) or window <= 0:
            raise ValueError(window)
    except ValueError:
        raise ShellError("bad -window/-limit")
    volume_id: int | None = None
    trace_id: str | None = None
    collection: str | None = None
    if target.isdigit():
        volume_id = int(target)
    elif _re.fullmatch(r"[0-9a-f]{1,32}", target):
        trace_id = target
    else:
        collection = target

    endpoints = _discover_endpoints(env, flags.get("include", ""))
    ev_res: dict[str, dict] = {}
    tr_res: dict[str, dict] = {}

    def fetch(ep: str) -> None:
        try:
            ev_res[ep] = env.get(
                f"{ep}/debug/events?limit={limit}", timeout=10)
        except Exception:
            return  # an unreachable node must not sink the timeline
        if trace_id is not None:
            try:
                tr_res[ep] = env.get(
                    f"{ep}/debug/traces?id={trace_id}", timeout=10)
            except Exception:
                pass

    spool_dirs = [d.strip() for d in flags.get("spool", "").split(",")
                  if d.strip()]
    _fetch_concurrently(endpoints, fetch)
    if not ev_res and not spool_dirs:
        raise ShellError("no /debug/events endpoint reachable")

    # dedup: one ring per process, exposed at every one of its ports
    events: list[dict] = []
    seen: set[tuple] = set()
    procs: set[str] = set()
    for ep in sorted(ev_res):
        out = ev_res[ep]
        token = out.get("proc") or ep
        for ev in out.get("events", []):
            key = (token, ev.get("seq"))
            if key in seen:
                continue
            seen.add(key)
            procs.add(token)
            events.append(ev)

    # post-mortem spools: the dead process has no /debug/events port, so
    # its journal comes straight off the segment files. A RESTARTED
    # process replays the same journal into its live ring — the
    # (ts, seq, type) key keeps those events from appearing twice (the
    # proc token changes across a restart, so the live dedup can't).
    if spool_dirs:
        live_keys = {(round(ev.get("ts", 0.0), 6), ev.get("seq"),
                      ev.get("type")) for ev in events}
        for d in spool_dirs:
            try:
                replayed = store_mod.read_events(d, limit=limit)
            except OSError as e:
                raise ShellError(f"spool {d}: {e}")
            fresh = 0
            for ev in replayed:
                key = (round(ev.get("ts", 0.0), 6), ev.get("seq"),
                       ev.get("type"))
                if key in live_keys:
                    continue
                live_keys.add(key)
                events.append(ev)
                fresh += 1
            if fresh:
                procs.add(f"spool:{d}")
    if not events and not ev_res:
        raise ShellError(
            "no events: every endpoint unreachable and the spool(s)"
            f" {spool_dirs} hold no journal records")

    spans: dict[str, dict] = {}
    for ep in sorted(tr_res):
        for sp in tr_res[ep].get("spans", []):
            spans.setdefault(sp["span_id"], sp)

    if trace_id is not None:
        direct = [ev for ev in events if ev.get("trace_id") == trace_id]
        anchor_ts = [sp["start"] for sp in spans.values()] \
            + [ev["ts"] for ev in direct]
        if not anchor_ts and not direct:
            raise ShellError(
                f"trace {trace_id}: no spans or events found on"
                f" {len(ev_res)} endpoint(s) (evicted, or wrong id?)")
        t0 = min(anchor_ts)
        # widen to the volumes the trace touched: their fault/alert/task
        # events ARE the causal context (a repair task has no trace id —
        # it is correlated by volume + time)
        vols = {ev["volume"] for ev in direct if ev.get("volume") is not None}
        for sp in spans.values():
            v = (sp.get("attrs") or {}).get("volume")
            if v is not None:
                try:
                    vols.add(int(v))
                except (TypeError, ValueError):
                    pass
        related = [
            ev for ev in events
            if ev.get("trace_id") != trace_id
            and ev.get("volume") in vols
            and t0 - 1.0 <= ev["ts"] <= t0 + window
        ]
        picked = direct + related
        head = (f"cluster.why trace {trace_id}: {len(spans)} span(s),"
                f" {len(direct)} direct + {len(related)} related event(s)"
                f" from {len(procs)} process(es)"
                + (f", volumes {sorted(vols)}" if vols else ""))
    else:
        if collection is not None:
            # per-tenant timeline: the collection correlation key rides
            # in attrs (degraded_read, scrub_finding, task_*,
            # tenant_overflow, heat edges on the tenant's volumes)
            picked = [ev for ev in events
                      if (ev.get("attrs") or {}).get("collection")
                      == collection]
            what = f"collection {collection!r}"
        else:
            picked = [ev for ev in events
                      if ev.get("volume") == volume_id]
            what = f"volume {volume_id}"
        if picked:
            t1 = max(ev["ts"] for ev in picked)
            picked = [ev for ev in picked if ev["ts"] >= t1 - window]
        if not picked:
            raise ShellError(
                f"{what}: no events found on {len(ev_res)} endpoint(s)"
                + (f" + {len(spool_dirs)} spool(s)" if spool_dirs else ""))
        # pull the request traces the volume's events name (the span side
        # of the story: which reads were degraded, how slow they were) —
        # ONE fan-out with all lookups batched per endpoint, so a single
        # unreachable node costs one timeout, not one per trace id
        tids = sorted({ev["trace_id"] for ev in picked
                       if ev.get("trace_id")})[:8]
        found: dict[str, list] = {}
        found_lock = __import__("threading").Lock()

        def fetch_traces(ep: str) -> None:
            for tid in tids:
                try:
                    out = env.get(f"{ep}/debug/traces?id={tid}", timeout=10)
                except Exception:
                    return  # unreachable: skip its remaining lookups too
                with found_lock:
                    found.setdefault(ep, []).extend(out.get("spans", []))

        if tids:
            _fetch_concurrently(ev_res, fetch_traces)
        for sps in found.values():
            for sp in sps:
                spans.setdefault(sp["span_id"], sp)
        head = (f"cluster.why {what}: {len(picked)} event(s),"
                f" {len(spans)} span(s) from {len(procs)} process(es)")

    # one causally-ordered timeline: spans (at their start time) + events
    rows: list[tuple[float, str]] = []
    for sp in spans.values():
        rows.append((
            sp["start"],
            f"span [{sp.get('role') or '-'}] {sp['name']}"
            f" {sp['duration_ms']}ms {sp['status']}"
            f" trace={sp['trace_id']}",
        ))
    for ev in picked:
        rows.append((ev["ts"], _why_describe(ev)))
    rows.sort(key=lambda r: r[0])
    t0 = rows[0][0] if rows else 0.0
    lines = [head]
    lines.extend(f"  +{ts - t0:8.3f}s  {body}" for ts, body in rows)
    if "out" in flags:
        # the bug-report artifact: the raw assembled timeline as JSON
        # (events + spans, pre-rendering), symmetric with cluster.heat
        # -out but machine-readable — attach it, don't screenshot it
        import json as _json

        doc = {
            "target": target,
            "kind": ("trace" if trace_id is not None
                     else "collection" if collection is not None
                     else "volume"),
            "window": window,
            "processes": sorted(procs),
            "spools": spool_dirs,
            "head": head,
            "events": sorted(picked, key=lambda e: e.get("ts", 0.0)),
            "spans": sorted(spans.values(), key=lambda s: s["start"]),
        }
        with open(flags["out"], "w") as f:
            _json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        return head + f"\ntimeline json written to {flags['out']}"
    return "\n".join(lines)


@command("cluster.faults",
         "[-list] | -arm <point> -mode <error|latency|torn|disk_full|"
         "partition|corrupt> [-rate r] [-ms n] [-frac f] [-count n] [-key id]"
         " | -disarm <point> | -disarmAll  [-node url] [-include url,url]"
         " — arm/disarm/list fault injection across discovered nodes")
def cmd_cluster_faults(env: CommandEnv, args: list[str]) -> str:
    """The cluster-wide switchboard for util/faults.py: every discovered
    /debug-capable endpoint (master, volume servers, filers, -include'd
    gateways) gets the POST; -node scopes to one endpoint. Single-process
    clusters share one registry — the listing dedups by fault state, and
    arming once is arming everywhere in-process (use -key to scope a
    seam to one server's identity there)."""
    flags = parse_flags(args)
    endpoints = _discover_endpoints(env, flags.get("include", ""))
    if "node" in flags:
        endpoints = {peer_url(flags["node"].rstrip("/"))}

    if "arm" in flags or "disarm" in flags or "disarmAll" in flags:
        if "arm" in flags:
            if "mode" not in flags:
                raise ShellError("cluster.faults -arm needs -mode")
            body = {"action": "arm", "point": flags["arm"],
                    "mode": flags["mode"]}
            try:
                for k in ("rate", "ms", "frac"):
                    if k in flags:
                        body[k] = float(flags[k])
                if "count" in flags:
                    body["count"] = int(flags["count"])
            except ValueError as e:
                raise ShellError(f"bad numeric flag: {e}")
            if "key" in flags:
                body["key"] = flags["key"]
            verb = f"armed {flags['arm']} ({flags['mode']})"
        elif "disarm" in flags:
            body = {"action": "disarm", "point": flags["disarm"]}
            verb = f"disarmed {flags['disarm']}"
        else:
            body = {"action": "disarm_all"}
            verb = "disarmed all"
        ok, failed = [], []
        for ep in sorted(endpoints):
            try:
                env.post(f"{ep}/debug/faults", body, timeout=10)
                ok.append(ep)
            except Exception as e:
                failed.append(f"{ep} ({e})")
        lines = [f"{verb} on {len(ok)}/{len(endpoints)} endpoint(s)"]
        lines.extend(f"  failed: {f}" for f in failed)
        if not ok:
            raise ShellError("\n".join(lines))
        return "\n".join(lines)

    # default: -list — aggregate state, deduped across shared processes
    seen: dict[tuple, set[str]] = {}
    reached = 0
    for ep in sorted(endpoints):
        try:
            out = env.get(f"{ep}/debug/faults", timeout=10)
        except Exception:
            continue
        reached += 1
        for p in out.get("points", []):
            armed = p.get("armed")
            key = (
                p["point"], p.get("fired", 0),
                tuple(sorted(armed.items())) if armed else None,
            )
            seen.setdefault(key, set()).add(ep)
    if not reached:
        raise ShellError("no /debug/faults endpoint reachable")
    lines = [f"fault points across {reached} endpoint(s):"]
    # sort key must not compare None with a tuple (a point armed on some
    # endpoints and disarmed on others yields both shapes)
    for (point, fired, armed), eps in sorted(
        seen.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2] or ())
    ):
        state = "disarmed" if armed is None else \
            " ".join(f"{k}={v}" for k, v in armed)
        lines.append(f"  {point}: {state}, fired={fired}"
                     f" [{len(eps)} endpoint(s)]")
    if len(seen) == 0:
        lines.append("  (no seams registered yet — servers not started?)")
    return "\n".join(lines)


@command("cluster.qos",
         "[-show] | [-limit 'coll=rps[:burst],…,*=rps'] [-default rps]"
         " [-queueDepth n] [-queueWait s] [-node url] [-include url,url]"
         " — show or set token-bucket admission limits across gateways")
def cmd_cluster_qos(env: CommandEnv, args: list[str]) -> str:
    """The admission-control switchboard (qos/admission.py): with no
    flags, fan out GET /debug/qos across every discovered endpoint and
    render armed state, per-collection limits, class gates and shed
    counters. With -limit/-default/-queueDepth/-queueWait, POST the new
    configuration to every gateway (filers and S3, plus -include'd
    endpoints) so the whole admission plane moves together. -node
    scopes either direction to one endpoint. Sheds show up in
    cluster.top's qos block and as qos_shed events in cluster.why."""
    flags = parse_flags(args)
    endpoints = _discover_endpoints(env, flags.get("include", ""))
    if "node" in flags:
        endpoints = {peer_url(flags["node"].rstrip("/"))}

    setters = {"limit", "default", "queueDepth", "queueWait"}
    if setters & flags.keys():
        body: dict = {}
        try:
            if "limit" in flags:
                body["spec"] = flags["limit"]
            if "default" in flags:
                body["default"] = float(flags["default"])
            if "queueDepth" in flags:
                body["queue_depth"] = int(flags["queueDepth"])
            if "queueWait" in flags:
                body["queue_wait"] = float(flags["queueWait"])
        except ValueError as e:
            raise ShellError(f"bad numeric flag: {e}")
        ok, failed = [], []
        armed_n = 0
        for ep in sorted(endpoints):
            try:
                out = env.post(f"{ep}/qos/limits", body, timeout=10)
                ok.append(ep)
                if out.get("armed"):
                    armed_n += 1
            except Exception as e:
                failed.append(f"{ep} ({e})")
        lines = [
            f"qos limits applied on {len(ok)}/{len(endpoints)}"
            f" endpoint(s), {armed_n} armed"
        ]
        lines.extend(f"  failed: {f}" for f in failed)
        if not ok:
            raise ShellError("\n".join(lines))
        return "\n".join(lines)

    # default: -show — per-endpoint admission state
    lines = []
    reached = 0
    for ep in sorted(endpoints):
        try:
            out = env.get(f"{ep}/debug/qos", timeout=10)
        except Exception:
            continue
        reached += 1
        armed = "armed" if out.get("armed") else "disarmed"
        role = out.get("role", "?")
        lines.append(f"  {ep} [{role}]: {armed}")
        limits = out.get("limits") or {}
        default = out.get("default")
        if limits or default is not None:
            parts = [
                f"{c}={v[0]:g}:{v[1]:g}" for c, v in sorted(limits.items())
            ]
            if default is not None:
                parts.append(f"*={default[0]:g}:{default[1]:g}")
            lines.append(f"    limits: {', '.join(parts)}")
        gates = out.get("gates") or {}
        tightened = {c: g for c, g in gates.items() if g < 1.0}
        if tightened:
            act = out.get("actuator") or {}
            lines.append(
                "    gates: " + ", ".join(
                    f"{c}={g:g}" for c, g in sorted(tightened.items()))
                + f" (actuator level {act.get('level', '?')},"
                  f" burn {act.get('burn', 0):.2f})"
            )
        # shed is {class: {"reason:collection": n}} — flatten for display
        flat = {
            f"{cls}/{key}": n
            for cls, by_key in (out.get("shed") or {}).items()
            for key, n in by_key.items()
        }
        if flat:
            top = sorted(flat.items(), key=lambda kv: -kv[1])[:4]
            lines.append(
                "    shed: " + ", ".join(f"{k}={int(v)}" for k, v in top))
    if not reached:
        raise ShellError("no /debug/qos endpoint reachable")
    return "\n".join(
        [f"qos admission state across {reached} endpoint(s):"] + lines)


@command("mount.configure",
         "-dir <mountpoint> [-quotaMB n] — inspect/adjust a RUNNING mount"
         " via its local admin socket")
def cmd_mount_configure(env: CommandEnv, args: list[str]) -> str:
    """`command_mount_configure.go`: talks to the mount's admin listener
    (deterministic unix socket derived from the mountpoint)."""
    from ..mount import admin_socket_path
    from ..server.httpd import get_json, post_json

    flags = parse_flags(args)
    mp = flags.get("dir")
    if not mp:
        raise ShellError("usage: mount.configure -dir <mountpoint>"
                         " [-quotaMB n]")
    base = "http+unix://" + urllib.parse.quote(admin_socket_path(mp), safe="")
    if "quotaMB" in flags:
        try:
            quota_mb = int(flags["quotaMB"])
        except ValueError:
            raise ShellError(f"invalid -quotaMB {flags['quotaMB']!r}")
        try:
            out = post_json(base + "/configure", {"quotaMB": quota_mb})
        except (IOError, OSError) as e:
            raise ShellError(f"no running mount at {mp!r}? ({e})")
        return f"quota set to {out['quota_bytes']} bytes"
    try:
        out = get_json(base + "/status")
    except (IOError, OSError) as e:
        raise ShellError(f"no running mount at {mp!r}? ({e})")
    return (f"mount {out['mountpoint']}: used {out['used_bytes']} /"
            f" quota {out['quota_bytes'] or 'unlimited'}"
            f"{' [read-only]' if out['read_only'] else ''}")


# --- mq.* (`weed/shell/command_mq_topic_list.go` etc.) -----------------------
def _broker_url(env) -> str:
    ps = env.get(f"{env.master_url}/cluster/ps")
    brokers = ps.get("brokers") or []
    if not brokers:
        raise ShellError("no live mq brokers registered")
    return brokers[0]["address"]


@command("mq.topic.list", "list message-queue topics")
def cmd_mq_topic_list(env: CommandEnv, args: list[str]) -> str:
    out = env.get(f"{_broker_url(env)}/topics/list")
    return json.dumps(out["topics"], indent=2)


@command("mq.topic.create",
         "-topic <name> [-namespace default] [-partitionCount 4]")
def cmd_mq_topic_create(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    out = env.post(f"{_broker_url(env)}/topics/create", {
        "namespace": flags.get("namespace", "default"),
        "topic": flags["topic"],
        "partition_count": int(flags.get("partitionCount", 4)),
    })
    return f"created topic {flags['topic']} ({out['partition_count']} partitions)"


@command("mq.topic.describe", "-topic <name> [-namespace default]")
def cmd_mq_topic_describe(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    ns = flags.get("namespace", "default")
    out = env.get(
        f"{_broker_url(env)}/topics/describe?namespace={ns}"
        f"&topic={flags['topic']}"
    )
    return json.dumps(out, indent=2)


@command("mq.balance", "rebalance topic partitions across live brokers")
def cmd_mq_balance(env: CommandEnv, args: list[str]) -> str:
    out = env.post(f"{_broker_url(env)}/balance", {})
    acts = out.get("actions", [])
    if not acts:
        return "already balanced"
    return "\n".join(
        f"moved {a['namespace']}/{a['topic']} p{a['partition']} "
        f"{a['from']} -> {a['to']}" for a in acts
    )


@command("mq.topic.configure",
         "-topic <name> -partitionCount <n> [-namespace default] — grow a"
         " live topic's partition count")
def cmd_mq_topic_configure(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    ns = flags.get("namespace", "default")
    try:
        out = env.post(f"{_broker_url(env)}/topics/configure", {
            "namespace": ns, "topic": flags["topic"],
            "partition_count": int(flags["partitionCount"]),
        })
    except KeyError:
        raise ShellError("usage: mq.topic.configure -topic <name>"
                         " -partitionCount <n>")
    except IOError as e:
        raise ShellError(str(e))
    return (f"topic {ns}/{flags['topic']} now has"
            f" {out['partition_count']} partitions")


@command("cluster.raft.ps", "show raft member status on the master(s)")
def cmd_cluster_raft_ps(env: CommandEnv, args: list[str]) -> str:
    out = env.get(f"{env.master_url}/raft/status")
    if not out.get("enabled"):
        return f"raft disabled (single master at {env.master_url})"
    lines = [f"{out['id']}  role={out['role']} term={out['term']} "
             f"commit={out['commit_index']}"]
    for p in out.get("peers", []):
        try:
            ps = env.get(f"{p}/raft/status")
            lines.append(f"{ps['id']}  role={ps['role']} term={ps['term']} "
                         f"commit={ps['commit_index']}")
        except Exception as e:
            lines.append(f"{p}  unreachable ({e})")
    return "\n".join(lines)


def _raft_member(env: CommandEnv, args: list[str], op: str) -> str:
    flags = parse_flags(args)
    addr = flags.get("address") or flags.get("id")
    if not addr:
        raise ShellError(f"usage: cluster.raft.{op} -address <master_url>")
    try:
        out = env.post(f"{env.master_url}/raft/{op}", {"peer": addr})
    except IOError as e:
        raise ShellError(str(e))
    done = "added" if op == "add" else "removed"
    return f"{done} {addr}; members: {', '.join(out.get('peers', []))}"


@command("cluster.raft.add",
         "-address <master_url> — add a master to the raft cluster"
         " (replicated membership change)")
def cmd_cluster_raft_add(env: CommandEnv, args: list[str]) -> str:
    return _raft_member(env, args, "add")


@command("cluster.raft.remove",
         "-address <master_url> — remove a master from the raft cluster")
def cmd_cluster_raft_remove(env: CommandEnv, args: list[str]) -> str:
    return _raft_member(env, args, "remove")
