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
Not ported: the file's other commands (`cluster.check`, `cluster.top`,
`cluster.trace`, `cluster.profile`, `cluster.why`, `cluster.heat`,
`cluster.qos` and the rest), which read routes the port does not serve.
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

from ..server.httpd import peer_url
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


def _discover_endpoints(env: CommandEnv, include: str = "") -> set[str]:
    """Every /debug-capable node the shell can see: the master, each
    volume server in the topology, registered filers, plus -include'd
    urls (s3 gateways don't register with the master)."""
    endpoints = {env.master_url}
    for extra in include.split(","):
        extra = extra.strip().rstrip("/")
        if extra:
            endpoints.add(peer_url(extra))
    try:
        for sv in env.servers():
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
