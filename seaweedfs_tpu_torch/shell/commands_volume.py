"""volume.* commands (reference `weed/shell/command_volume_balance.go`,
`command_volume_fix_replication.go:58`, `command_volume_move.go`,
`command_volume_fsck.go`, `command_volume_check_disk.go`,
`command_volume_server_evacuate.go`).

The port's copy of `seaweedfs_tpu/shell/commands_volume.py`, every verb,
the tier verbs (`volume.tier.{configure,upload,download,info,move}`, over
the volume servers' `/admin/backend/configure` and
`/admin/volume/tier_*`) included. `volume.scrub` raises ShellError naming the
server when a pass fails on its CRC kernel or codec (`codec_failed`),
where the JAX verb would note the failed pass and go on."""

from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

from ..server.httpd import http_request
from .env import CommandEnv, ServerView, ShellError
from .registry import command, dry_run_flag, parse_flags, render_plan


def _find_server(servers: list[ServerView], node_id: str) -> ServerView:
    for sv in servers:
        if sv.id == node_id or sv.url == node_id:
            return sv
    raise ShellError(f"volume server {node_id!r} not found")


def _move_volume(env: CommandEnv, vid: int, src: ServerView, dst: ServerView) -> None:
    """copy to dst, then delete from src (`command_volume_move.go` — live
    moves tail writes; we mark readonly during the copy like evacuate does)."""
    env.post(f"{src.http}/admin/volume/readonly", {"volume": vid, "readonly": True})
    try:
        # a live online-EC volume's copy also re-encodes full parity on
        # the receiver (rearm) before responding — budget like the other
        # whole-volume pulls, not the 300s default (a client timeout here
        # while the server-side copy completes would leave the volume
        # mounted on BOTH nodes)
        env.post(
            f"{dst.http}/admin/volume/copy",
            {"volume": vid, "source": src.http},
            timeout=3600,
        )
    except Exception:
        env.post(
            f"{src.http}/admin/volume/readonly", {"volume": vid, "readonly": False}
        )
        raise
    env.post(f"{src.http}/admin/delete_volume", {"volume": vid})
    env.post(f"{dst.http}/admin/volume/readonly", {"volume": vid, "readonly": False})


@command("volume.move", "-volumeId <n> -source <host:port> -target <host:port>",
         needs_lock=True)
def cmd_volume_move(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    servers = env.servers()
    src = _find_server(servers, flags["source"])
    dst = _find_server(servers, flags["target"])
    _move_volume(env, vid, src, dst)
    return f"moved volume {vid} from {src.id} to {dst.id}"


@command("volume.copy", "-volumeId <n> -source <host:port> -target <host:port>",
         needs_lock=True)
def cmd_volume_copy(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    servers = env.servers()
    src = _find_server(servers, flags["source"])
    dst = _find_server(servers, flags["target"])
    out = env.post(
        f"{dst.http}/admin/volume/copy", {"volume": vid, "source": src.http}
    )
    return f"copied volume {vid} to {dst.id} ({out['size']} bytes)"


@command("volume.delete", "-volumeId <n> -node <host:port>", needs_lock=True)
def cmd_volume_delete(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _find_server(env.servers(), flags["node"])
    env.post(f"{sv.http}/admin/delete_volume", {"volume": vid})
    return f"deleted volume {vid} on {sv.id}"


@command("volume.mark", "-volumeId <n> -node <host:port> [-writable|-readonly]")
def cmd_volume_mark(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _find_server(env.servers(), flags["node"])
    readonly = "writable" not in flags
    env.post(
        f"{sv.http}/admin/volume/readonly", {"volume": vid, "readonly": readonly}
    )
    return f"volume {vid} on {sv.id} marked {'readonly' if readonly else 'writable'}"


def plan_vacuum(
    env: CommandEnv, threshold: float = 0.3, volume_id: int | None = None
) -> list[dict]:
    """Replica holders whose garbage ratio crosses the threshold (or every
    holder of an explicitly named volume). Shared between the
    `volume.vacuum` verb and the maintenance daemon's vacuum executor."""
    actions = []
    for sv in env.servers():
        for v in sv.volumes.values():
            if volume_id is not None and v["id"] != volume_id:
                continue
            size = v.get("size", 0)
            ratio = v.get("garbage", 0) / max(size, 1)
            if volume_id is None and (size == 0 or ratio < threshold):
                continue
            actions.append({
                "volume": v["id"], "node": sv.id, "node_url": sv.http,
                "garbage_ratio": round(ratio, 4),
            })
    return actions


def describe_vacuum(actions: list[dict]) -> list[str]:
    """Display lines for a plan_vacuum plan — the ONE rendering both the
    verb's dry-run output and /debug/maintenance history use."""
    return [
        f"vacuum volume {a['volume']} on {a['node']}"
        f" (garbage {a['garbage_ratio']:.1%})" for a in actions
    ]


def apply_vacuum(env: CommandEnv, actions: list[dict]) -> list[str]:
    done = []
    for a in actions:
        env.post(f"{a['node_url']}/admin/vacuum", {"volume": a["volume"]})
        done.append(f"{a['volume']}@{a['node']}")
    return done


@command("volume.vacuum", "[-garbageThreshold 0.3] [-volumeId n]"
         " [-dryRun|-apply] — compact garbage")
def cmd_volume_vacuum(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"]) if "volumeId" in flags else None
    threshold = float(flags.get("garbageThreshold", 0.3))
    actions = plan_vacuum(env, threshold, vid)
    if dry_run_flag(flags):
        return render_plan("volume.vacuum", describe_vacuum(actions))
    done = apply_vacuum(env, actions)
    return "vacuumed: " + (", ".join(done) if done else "nothing to do")


@command("volume.scrub", "[-volumeId n] [-node host:port] [-dryRun|-apply]"
         " — run a throttled integrity-scrub pass (bulk-CRC needles,"
         " parity-check EC stripes, sweep rebuild tmp litter) and route"
         " each finding to its heal (re-copy needle / delete corrupt"
         " shard -> ec_rebuild / parity re-arm / replica re-sync)",
         needs_lock=True)
def cmd_volume_scrub(env: CommandEnv, args: list[str]) -> str:
    # imported here: the maintenance package's executors import this module
    from ..maintenance.scrub import (
        apply_scrub_repairs,
        describe_scrub_repairs,
        plan_scrub_repairs,
    )

    flags = parse_flags(args)
    vid = int(flags["volumeId"]) if "volumeId" in flags else None
    node = flags.get("node")
    dry = dry_run_flag(flags)
    findings: list[dict] = []
    lines: list[str] = []
    scanned = 0
    for sv in env.servers():
        if node and sv.id != node and sv.url != node:
            continue
        if vid is not None and vid not in sv.volumes \
                and vid not in sv.ec_shards:
            continue
        try:
            out = env.post(
                f"{sv.http}/admin/scrub/run",
                {} if vid is None else {"volume": vid}, timeout=3600,
            )
        except IOError as e:
            err = getattr(e, "data", {})
            if err.get("error") == "codec_failed":
                # the kernel or the codec failed the pass: never a
                # skipped server
                raise ShellError(
                    f"volume.scrub: codec_failed on {err.get('server') or sv.id}:"
                    f" {err.get('detail', '')}") from e
            lines.append(f"{sv.id}: scrub pass failed ({e})")
            continue
        scanned += 1
        fs = out.get("findings", [])
        st = out.get("stats", {})
        lines.append(
            f"{sv.id}: {st.get('needles_checked', 0)} needles,"
            f" {st.get('stripes_checked', 0)} stripe samples checked,"
            f" {len(fs)} finding(s)"
        )
        findings.extend(fs)
    if not scanned:
        raise ShellError("no volume server matched the scrub scope")
    if not findings:
        lines.append("scrub: clean — no silent damage found")
        return "\n".join(lines)
    actions = plan_scrub_repairs(env, findings)
    if dry:
        lines.append(render_plan("volume.scrub",
                                 describe_scrub_repairs(actions)))
        return "\n".join(lines)
    applied = apply_scrub_repairs(env, actions)
    lines.append(f"repaired {len(applied)} finding(s):")
    lines.extend(f"  {a}" for a in applied)
    skipped = [a for a in actions if a.get("skip")]
    lines.extend(
        f"  skipped volume {a['volume']} [{a['kind']}]: {a['skip']}"
        for a in skipped
    )
    return "\n".join(lines)


@command("volume.fsck", "[-volumeId n] — CRC-verify every needle on every volume")
def cmd_volume_fsck(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = flags.get("volumeId")
    lines = []
    bad = 0
    for sv in env.servers():
        for v in sv.volumes.values():
            if vid is not None and v["id"] != int(vid):
                continue
            out = env.get(f"{sv.http}/admin/fsck?volume={v['id']}", timeout=600)
            status = "ok" if out["ok"] else f"{len(out['errors'])} ERRORS"
            bad += len(out["errors"])
            lines.append(f"volume {v['id']}@{sv.id}: {out['checked']} needles {status}")
    lines.append("fsck: clean" if bad == 0 else f"fsck: {bad} corrupt needles")
    return "\n".join(lines)


@command("volume.check.disk", "sync needle differences between replicas "
         "(ref command_volume_check_disk.go)", needs_lock=True)
def cmd_volume_check_disk(env: CommandEnv, args: list[str]) -> str:
    lines = []
    for vid, holders in sorted(env.volume_replicas().items()):
        if len(holders) < 2:
            continue
        needle_sets = {}
        for sv in holders:
            out = env.get(f"{sv.http}/admin/volume/needles?volume={vid}", timeout=300)
            needle_sets[sv.id] = {n["id"]: n for n in out["needles"]}
        union: dict[int, tuple[ServerView, dict]] = {}
        for sv in holders:
            for nid, meta in needle_sets[sv.id].items():
                union.setdefault(nid, (sv, meta))
        for sv in holders:
            missing = [nid for nid in union if nid not in needle_sets[sv.id]]
            for nid in missing:
                src, meta = union[nid]
                blob_status, _, blob = http_request(
                    "GET",
                    f"{src.http}/admin/volume/needle_blob?volume={vid}"
                    f"&offset={meta['offset']}&size={meta['size']}", timeout=60)
                if blob_status != 200:
                    lines.append(f"volume {vid}: read {nid} from {src.id} failed")
                    continue
                st, _, _ = http_request(
                    "POST",
                    f"{sv.http}/admin/volume/write_needle_blob?volume={vid}"
                    f"&size={meta['size']}",
                    blob, timeout=60)
                if st < 300:
                    lines.append(f"volume {vid}: copied needle {nid} "
                                 f"{src.id} -> {sv.id}")
                else:
                    lines.append(f"volume {vid}: write {nid} to {sv.id} failed")
    return "\n".join(lines) if lines else "all replicas are in sync"


def plan_fix_replication(
    env: CommandEnv, volume_id: int | None = None
) -> list[dict]:
    """Planned replica copies for every under-replicated volume (or one
    named volume): rack-spreading target choice, one action per missing
    replica. Shared between the `volume.fix.replication` verb and the
    maintenance daemon's fix_replication executor — humans and the daemon
    repair through the same plan."""
    servers = env.servers()
    # replica map off the snapshot just fetched — env.volume_replicas()
    # would pay a second full /dir/status round-trip per plan (and the
    # daemon plans once per task)
    replicas: dict[int, list[ServerView]] = {}
    for sv in servers:
        for vid in sv.volumes:
            replicas.setdefault(vid, []).append(sv)
    actions = []
    for vid, holders in sorted(replicas.items()):
        if volume_id is not None and vid != volume_id:
            continue
        info = holders[0].volumes[vid]
        rp = info.get("replica_placement", 0)
        want = (rp // 100) + (rp // 10) % 10 + rp % 10 + 1
        if len(holders) >= want:
            continue
        holder_ids = {sv.id for sv in holders}
        holder_racks = {(sv.dc, sv.rack) for sv in holders}
        # prefer a different rack, then any server with free slots
        candidates = sorted(
            (sv for sv in servers if sv.id not in holder_ids and sv.free_slots() > 0),
            key=lambda sv: ((sv.dc, sv.rack) in holder_racks, -sv.free_slots()),
        )
        for _ in range(want - len(holders)):
            action = {"volume": vid, "have": len(holders), "want": want,
                      "source": holders[0].id, "source_url": holders[0].http}
            if not candidates:
                action.update(target=None, target_url=None)
                actions.append(action)
                break
            dst = candidates.pop(0)
            action.update(target=dst.id, target_url=dst.http)
            actions.append(action)
    return actions


def describe_fix_replication(actions: list[dict]) -> list[str]:
    """Display lines for a plan_fix_replication plan — shared by the
    verb's dry-run output and /debug/maintenance history."""
    return [
        f"volume {a['volume']} ({a['have']}/{a['want']} replicas): copy"
        f" {a['source']} -> {a['target'] or 'NO CANDIDATE'}"
        for a in actions
    ]


def apply_fix_replication(env: CommandEnv, actions: list[dict]) -> list[str]:
    lines = []
    for a in actions:
        if a.get("target") is None:
            lines.append(f"volume {a['volume']}: no candidate server")
            continue
        env.post(
            f"{a['target_url']}/admin/volume/copy",
            {"volume": a["volume"], "source": a["source_url"]},
        )
        lines.append(f"volume {a['volume']}: replicated to {a['target']}")
    return lines


@command("volume.fix.replication", "[-volumeId n] [-dryRun|-apply] —"
         " re-replicate under-replicated volumes"
         " (ref command_volume_fix_replication.go:58)", needs_lock=True)
def cmd_volume_fix_replication(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"]) if "volumeId" in flags else None
    actions = plan_fix_replication(env, vid)
    if dry_run_flag(flags):
        return render_plan("volume.fix.replication",
                           describe_fix_replication(actions))
    lines = apply_fix_replication(env, actions)
    return "\n".join(lines) if lines else "all volumes sufficiently replicated"


def plan_balance(
    env: CommandEnv, collection: str | None = None,
    servers: list[ServerView] | None = None,
) -> list[dict]:
    """The move list `volume.balance` would perform, computed by running
    the convergence loop against a local copy of the topology snapshot —
    no mutations. Shared with the maintenance balance executor. Pass
    `servers` to reuse an already-fetched snapshot.

    Collection affinity: when the target node
    already hosts volumes of some collection, prefer moving one of THOSE
    onto it — a collection placed together (online-EC collections
    especially, whose sealed shards and repair traffic stay rack-local)
    must not scatter one volume per rebalance tick across every node
    that happens to be lightest. Ties still break by smallest size."""
    servers = env.servers() if servers is None else servers
    if len(servers) < 2:
        return []
    # simulated state: per-node eligible volumes + full membership (a move
    # must not land a volume on a node already holding a replica of it).
    # LIVE online-EC volumes are movable too: the receiver's
    # /admin/volume/copy re-arms the striper off the pulled .vif policy
    # and re-encodes parity from the durable .dat — the source's
    # parity/journal dying with it does not strand the volume
    # unprotected.
    vols = {
        sv.id: {
            vid: v for vid, v in sv.volumes.items()
            if (collection is None or v.get("collection", "") == collection)
        }
        for sv in servers
    }
    membership = {sv.id: set(sv.volumes) for sv in servers}
    urls = {sv.id: sv.http for sv in servers}
    # live per-node collection counts for the affinity rank, over the
    # FULL volume set (filtered collections still anchor their
    # collection to a node) and tracking the simulated moves
    colls = {
        sv.id: Counter(
            v.get("collection", "") for v in sv.volumes.values()
        )
        for sv in servers
    }
    actions = []
    for _ in range(100):  # converge
        order = sorted(servers, key=lambda sv: len(vols[sv.id]))
        low, high = order[0], order[-1]
        if len(vols[high.id]) - len(vols[low.id]) <= 1:
            break
        movable = [
            v for vid, v in vols[high.id].items()
            if vid not in membership[low.id]
        ]
        if not movable:
            break
        pick = min(
            movable,
            key=lambda v: (
                colls[low.id][v.get("collection", "")] == 0,
                v["size"],
            ),
        )
        vid = pick["id"]
        actions.append({
            "volume": vid, "source": high.id, "source_url": urls[high.id],
            "target": low.id, "target_url": urls[low.id],
        })
        del vols[high.id][vid]
        membership[high.id].discard(vid)
        vols[low.id][vid] = pick
        membership[low.id].add(vid)
        coll = pick.get("collection", "")
        colls[low.id][coll] += 1
        colls[high.id][coll] -= 1
    return actions


def describe_balance(actions: list[dict]) -> list[str]:
    """Display lines for a plan_balance plan — shared by the verb's
    dry-run output and /debug/maintenance history."""
    return [
        f"move volume {a['volume']}: {a['source']} -> {a['target']}"
        for a in actions
    ]


def apply_balance(env: CommandEnv, actions: list[dict]) -> list[str]:
    moved = []
    for a in actions:
        _move_volume(
            env, a["volume"],
            SimpleNamespace(http=a["source_url"]),
            SimpleNamespace(http=a["target_url"]),
        )
        moved.append(f"{a['volume']}: {a['source']} -> {a['target']}")
    return moved


@command("volume.balance", "[-collection c] [-dryRun|-apply] — even out"
         " volume counts across servers (ref command_volume_balance.go)",
         needs_lock=True)
def cmd_volume_balance(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    servers = env.servers()  # one snapshot: shared with the plan
    if len(servers) < 2:
        return "nothing to balance (fewer than 2 servers)"
    actions = plan_balance(env, flags.get("collection"), servers=servers)
    if dry_run_flag(flags):
        return render_plan("volume.balance", describe_balance(actions))
    moved = apply_balance(env, actions)
    return "\n".join(moved) if moved else "already balanced"


@command("volume.server.evacuate", "-node <host:port> — move all volumes off a "
         "server (ref command_volume_server_evacuate.go)", needs_lock=True)
def cmd_volume_server_evacuate(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    servers = env.servers()
    src = _find_server(servers, flags["node"])
    targets = [sv for sv in servers if sv.id != src.id and sv.free_slots() > 0]
    if not targets:
        raise ShellError("no target servers with free slots")
    moved = []
    for i, vid in enumerate(sorted(src.volumes)):
        # round-robin over targets, skipping ones already holding a replica
        ranked = sorted(
            (sv for sv in targets if vid not in sv.volumes),
            key=lambda sv: -sv.free_slots(),
        )
        if not ranked:
            moved.append(f"{vid}: NO TARGET")
            continue
        dst = ranked[i % len(ranked)]
        _move_volume(env, vid, src, dst)
        dst.volumes[vid] = src.volumes[vid]  # keep local view fresh
        moved.append(f"{vid} -> {dst.id}")
    return "\n".join(moved) if moved else "server holds no volumes"


@command("volume.configure.replication",
         "-volumeId <n> -replication <xyz> [-node host:port] — rewrite the "
         "volume superblock's replica placement", needs_lock=True)
def cmd_volume_configure_replication(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    applied = []
    for sv in env.servers():
        if flags.get("node") and sv.id != flags["node"] and sv.url != flags["node"]:
            continue
        if vid not in sv.volumes:
            continue
        env.post(f"{sv.http}/admin/volume/configure_replication",
                 {"volume": vid, "replication": flags["replication"]})
        applied.append(sv.id)
    if not applied:
        raise ShellError(f"no server holds volume {vid}")
    return f"volume {vid} replication={flags['replication']} on: " + \
        ", ".join(applied)


@command("volume.delete.empty", "[-force] — delete volumes holding no live "
         "files on every server", needs_lock=True)
def cmd_volume_delete_empty(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    deleted = []
    for sv in env.servers():
        for vid, info in list(sv.volumes.items()):
            if info.get("file_count", 0) - info.get("delete_count", 0) > 0:
                continue
            if info.get("size", 0) > 8 and flags.get("force") != "true":
                continue  # has (deleted) data; demand -force
            env.post(f"{sv.http}/admin/delete_volume", {"volume": vid})
            deleted.append(f"{vid}@{sv.id}")
    return "deleted: " + (", ".join(deleted) if deleted else "(none)")


@command("volume.mount", "-volumeId <n> -node <host:port>", needs_lock=True)
def cmd_volume_mount(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _find_server(env.servers(), flags["node"])
    env.post(f"{sv.http}/admin/volume/mount", {"volume": vid})
    return f"mounted volume {vid} on {sv.id}"


@command("volume.unmount", "-volumeId <n> -node <host:port>", needs_lock=True)
def cmd_volume_unmount(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _find_server(env.servers(), flags["node"])
    env.post(f"{sv.http}/admin/volume/unmount", {"volume": vid})
    return f"unmounted volume {vid} on {sv.id}"


@command("volume.server.leave", "-node <host:port> — stop the server's "
         "heartbeats so the master drops it", needs_lock=True)
def cmd_volume_server_leave(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    sv = _find_server(env.servers(), flags["node"])
    env.post(f"{sv.http}/admin/leave")
    return f"{sv.id} left the cluster (heartbeats stopped)"


@command("volume.vacuum.disable", "suspend the master's automatic vacuum",
         needs_lock=True)
def cmd_volume_vacuum_disable(env: CommandEnv, args: list[str]) -> str:
    env.post(f"{env.master_url}/vol/vacuum/disable")
    return "automatic vacuum disabled"


@command("volume.vacuum.enable", "resume the master's automatic vacuum",
         needs_lock=True)
def cmd_volume_vacuum_enable(env: CommandEnv, args: list[str]) -> str:
    env.post(f"{env.master_url}/vol/vacuum/enable")
    return "automatic vacuum enabled"


# --- tiering (`weed/shell/command_volume_tier_upload.go`, `_download.go`,
# `_move.go`) -----------------------------------------------------------------
def _server_holding(env: CommandEnv, vid: int, node: str | None) -> ServerView:
    servers = env.servers()
    if node:
        return _find_server(servers, node)
    for sv in servers:
        if vid in sv.volumes:
            return sv
    raise ShellError(f"no server holds volume {vid}")


@command("volume.tier.configure",
         "-backend <id> -kind local|s3 [-root dir] [-bucket b] — register a "
         "tier backend on every volume server", needs_lock=True)
def cmd_volume_tier_configure(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    backend = flags["backend"]
    kind = flags.get("kind", "local")
    options = {}
    for k in ("root", "bucket", "region", "endpoint"):
        if k in flags:
            options[k] = flags[k]
    done = []
    for sv in env.servers():
        env.post(f"{sv.http}/admin/backend/configure",
                 {"id": backend, "kind": kind, "options": options})
        done.append(sv.id)
    return f"backend {backend!r} ({kind}) configured on: " + ", ".join(done)


@command("volume.tier.upload",
         "-volumeId <n> -dest <backend-id> [-node host:port] [-keepLocal] — "
         "move a readonly volume's .dat into an object backend",
         needs_lock=True)
def cmd_volume_tier_upload(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _server_holding(env, vid, flags.get("node"))
    env.post(f"{sv.http}/admin/volume/readonly", {"volume": vid, "readonly": True})
    out = env.post(
        f"{sv.http}/admin/volume/tier_upload",
        {"volume": vid, "backend": flags["dest"],
         "keepLocal": flags.get("keepLocal") == "true"},
    )
    return f"volume {vid} tiered to {flags['dest']} ({out['size']} bytes)"


@command("volume.tier.download",
         "-volumeId <n> [-node host:port] — bring a tiered volume's .dat "
         "back to local disk", needs_lock=True)
def cmd_volume_tier_download(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _server_holding(env, vid, flags.get("node"))
    env.post(f"{sv.http}/admin/volume/tier_download", {"volume": vid})
    return f"volume {vid} downloaded back to {sv.id}"


@command("volume.tier.info", "-volumeId <n> [-node host:port]")
def cmd_volume_tier_info(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    sv = _server_holding(env, vid, flags.get("node"))
    out = env.get(f"{sv.http}/admin/volume/tier_info?volume={vid}")
    return json.dumps(out, indent=2)


@command("volume.tier.move",
         "-volumeId <n> -dest <backend-id> [-keepLocal] — alias of "
         "tier.upload after marking readonly", needs_lock=True)
def cmd_volume_tier_move(env: CommandEnv, args: list[str]) -> str:
    return cmd_volume_tier_upload(env, args)
