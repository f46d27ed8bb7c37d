"""Maintenance executors: the "heal" leg of detect → plan → heal.

The port's copy of `seaweedfs_tpu/maintenance/executors.py`. Each
executor drives the SAME plan/apply helpers the port's admin-shell
repair verbs use (`volume.fix.replication`, `ec.rebuild`,
`volume.vacuum`, `volume.balance`, `volume.scrub` —
shell/commands_volume.py, shell/commands_ec.py, scrub.py), so humans and
the daemon repair through one code path and one -dryRun/-apply
convention. An executor returns {"planned": [...]} in dry-run mode and
{"planned": [...], "applied": [...]} after a real repair; raising marks
the task failed (the scheduler arms backoff).

The executors are host code. The kernels of a heal run on the volume
servers they drive: `ec_rebuild` runs `gf256_matmul` on the rebuilder or
on each hop of a pipelined chain, the online re-arm re-encodes parity
through it, and `scrub` repairs act on findings the servers' scrub
passes made through `crc32c_batch`. A codec or kernel failure on a
server comes back as an error, which fails the task. `execute` runs each
task under a `maintenance.<type>` span.
"""

from __future__ import annotations

from ..shell.commands_ec import run_rebuild
from ..shell.commands_volume import (
    apply_balance,
    apply_fix_replication,
    apply_vacuum,
    describe_balance,
    describe_fix_replication,
    describe_vacuum,
    plan_balance,
    plan_fix_replication,
    plan_vacuum,
)

from ..stats import trace
from . import scrub as scrub_mod
from .detectors import RepairTask


def _exec_fix_replication(task: RepairTask, env, dry_run: bool) -> dict:
    actions = plan_fix_replication(env, task.volume_id)
    planned = describe_fix_replication(actions)
    if dry_run:
        return {"planned": planned}
    if actions and all(a.get("target") is None for a in actions):
        raise RuntimeError(
            f"volume {task.volume_id}: no candidate server for a new replica"
        )
    return {"planned": planned,
            "applied": apply_fix_replication(env, actions)}


def _exec_ec_rebuild(task: RepairTask, env, dry_run: bool,
                     scheduler=None, rebuild_mode: str = "auto") -> dict:
    """Rebuild missing shards, choosing pipelined partial-sum chains vs
    classic whole-shard pulls per task: an explicit task/daemon mode
    wins, else `auto` decides from the surviving-holder count and the
    scheduler's live pressure (token bucket + in-flight caps). The whole
    choose + apply + typed-fallback path is run_rebuild — shared with
    the ec.rebuild verb so both entry points repair identically and
    feed the same fallbacks/restarts metric series."""
    if task.params.get("online"):
        return _exec_ec_rebuild_online(task, env, dry_run)
    pressure = None
    if scheduler is not None:
        pressure = scheduler.pressure()
        # discount THIS task: the scheduler already counted it in flight
        # (and against its node's limit) when it dispatched us, so the
        # raw reading would report a busy node/cluster even when this
        # repair is the only thing running — making the 2-hop
        # idle-cluster -> classic branch unreachable
        pressure["in_flight"] = max(0, pressure["in_flight"] - 1)
        if task.node and pressure["node_inflight"].get(task.node, 0) > 0:
            pressure["node_inflight"][task.node] -= 1
    mode = task.params.get("mode") or rebuild_mode or "auto"
    out = run_rebuild(
        env, task.volume_id, task.collection, mode=mode,
        pressure=pressure, dry_run=dry_run,
    )
    if out.get("healed"):  # healed between detection and dispatch
        return {"planned": out["planned"], "applied": []}
    if out.get("dry_run"):
        return {"planned": out["planned"]}
    stats = out.get("stats")
    if stats is not None:
        applied = (
            f"rebuilt shards {out['rebuilt']} on {out['rebuilder']}"
            f" (pipelined, {stats['hops']} hops,"
            f" {stats['bytes_on_wire_rebuilder']} B at rebuilder,"
            f" {stats['restarts']} chain restart(s))"
        )
    else:
        applied = (
            f"rebuilt shards {out['rebuilt']} on {out['rebuilder']}"
            f" (classic)"
        )
    return {"planned": out["planned"], "applied": [applied]}


def _exec_ec_rebuild_online(task: RepairTask, env, dry_run: bool) -> dict:
    """A LIVE online-EC volume lost/tore a parity shard: the holder
    re-arms its striper and re-encodes from the durable .dat
    (/admin/ec/online/rebuild) — no shard pulls, the .dat IS the source."""
    vid = task.volume_id
    holder = next(
        (sv for sv in env.servers() if vid in sv.volumes), None
    )
    if holder is None:  # holder gone entirely: classic repair owns it now
        return {"planned": [], "applied": []}
    planned = [
        f"volume {vid}: re-arm online striper on {holder.id},"
        f" re-encode parity from the durable .dat"
    ]
    if dry_run:
        return {"planned": planned}
    out = env.post(
        f"{holder.http}/admin/ec/online/rebuild", {"volume": vid},
        timeout=3600,
    )
    return {"planned": planned,
            "applied": [f"volume {vid}: parity re-encoded to watermark"
                        f" {out.get('watermark')} on {holder.id}"]}


def _exec_scrub(task: RepairTask, env, dry_run: bool) -> dict:
    """Route a volume's scrub findings to their heals through the shared
    plan/apply helpers (scrub.py): corrupt needle -> re-copy from a
    verified-good holder, corrupt shard -> delete (the missing-shard
    detector's ec_rebuild re-derives it), online
    parity mismatch -> striper re-arm, replica divergence -> needle-level
    re-sync from the digest-majority holder."""
    actions = scrub_mod.plan_scrub_repairs(
        env, task.params.get("findings", [])
    )
    planned = scrub_mod.describe_scrub_repairs(actions)
    if dry_run:
        return {"planned": planned}
    return {"planned": planned,
            "applied": scrub_mod.apply_scrub_repairs(env, actions)}


def _exec_vacuum(task: RepairTask, env, dry_run: bool) -> dict:
    actions = plan_vacuum(env, volume_id=task.volume_id)
    planned = describe_vacuum(actions)
    if dry_run:
        return {"planned": planned}
    return {"planned": planned, "applied": apply_vacuum(env, actions)}


def _exec_balance(task: RepairTask, env, dry_run: bool) -> dict:
    actions = plan_balance(env)
    planned = describe_balance(actions)
    if dry_run:
        return {"planned": planned}
    return {"planned": planned, "applied": apply_balance(env, actions)}


def _plan_evacuate(env, node_id: str) -> list[dict]:
    """Copy actions moving the stale node's replicas onto healthy nodes,
    sourcing from SURVIVING holders (the stale node is presumed
    unreachable — `command_volume_server_evacuate.go`, degraded variant).
    Volumes with no other holder are reported, not silently skipped.

    EC shards get a pre-copy plan too: a shard has no
    second holder to source from, so the plan pulls from the DRAINING
    node itself — stale-heartbeat nodes are often alive-but-slow, and a
    successful pull beats waiting for expiry + a full ec_rebuild. If the
    node is truly dead the copy fails, the task backs off, and the
    missing-shard detector takes over after expiry."""
    servers = env.servers()
    stale = next((sv for sv in servers if sv.id == node_id), None)
    if stale is None:
        return []  # already expired: fix_replication owns it now
    healthy = [sv for sv in servers if sv.id != node_id]
    actions = []
    for vid in sorted(stale.volumes):
        others = [sv for sv in healthy if vid in sv.volumes]
        if others:
            src = others[0]
        elif stale.volumes[vid].get("ec_online"):
            # a LIVE online-EC volume is single-holder BY DESIGN (its
            # redundancy is the streamed parity, which cannot be copied
            # usefully) — pull the .dat/.idx/.vif from the draining node
            # itself, exactly like the EC-shard pre-copy below: stale
            # nodes are often alive-but-slow, and the receiver's
            # /admin/volume/copy re-arms the striper + re-encodes parity
            # from byte 0 on arrival. A truly dead source fails the
            # copy into backoff; nothing is lost by trying.
            src = stale
        else:
            actions.append({"volume": vid, "source": None, "target": None})
            continue
        ranked = sorted(
            (sv for sv in healthy
             if vid not in sv.volumes and sv.free_slots() > 0),
            key=lambda sv: -sv.free_slots(),
        )
        if not ranked:
            actions.append({"volume": vid, "source": src.id,
                            "target": None})
            continue
        dst = ranked[0]
        actions.append({"volume": vid, "source": src.id,
                        "source_url": src.http,
                        "target": dst.id, "target_url": dst.http})
        dst.volumes[vid] = stale.volumes[vid]  # keep the local view fresh
    for vid in sorted(stale.ec_shards):
        shards = sorted(stale.ec_shards[vid])
        # shards another node ALREADY holds need no copy (balance moves
        # in flight); only this node's unique shards are at risk
        elsewhere = {
            s for sv in healthy for s in sv.ec_shards.get(vid, [])
        }
        at_risk = [s for s in shards if s not in elsewhere]
        if not at_risk:
            continue
        # ANTI-AFFINITY: spread the at-risk shards across targets —
        # piling 5 shards of one volume onto a single node would turn
        # the NEXT single-node loss into >4 missing shards (RS(10,4)
        # unrecoverable). Per shard, prefer the node holding the fewest
        # of this volume's shards, then the most free slots.
        per_target: dict[str, list[int]] = {}
        for s in at_risk:
            ranked = sorted(
                (sv for sv in healthy if sv.free_slots() > 0),
                key=lambda sv: (len(sv.ec_shards.get(vid, [])),
                                -sv.free_slots()),
            )
            if not ranked:
                actions.append({"ec_volume": vid, "shards": [s],
                                "source": stale.id, "target": None})
                continue
            dst = ranked[0]
            per_target.setdefault(dst.id, []).append(s)
            dst.ec_shards.setdefault(vid, []).append(s)
        for dst_id, batch in per_target.items():
            dst = next(sv for sv in healthy if sv.id == dst_id)
            actions.append({
                "ec_volume": vid, "shards": batch,
                "collection": stale.ec_collections.get(vid, ""),
                "source": stale.id, "source_url": stale.http,
                "target": dst.id, "target_url": dst.http,
            })
    return actions


def _exec_evacuate(task: RepairTask, env, dry_run: bool) -> dict:
    actions = _plan_evacuate(env, task.node)
    planned = []
    for a in actions:
        if a.get("ec_volume") is not None:
            if a.get("target") is None:
                planned.append(
                    f"ec volume {a['ec_volume']} shards {a['shards']}:"
                    f" no candidate target"
                )
            else:
                planned.append(
                    f"ec volume {a['ec_volume']}: copy shards"
                    f" {a['shards']} {a['source']} -> {a['target']}"
                )
        elif a.get("target") is None:
            planned.append(
                f"volume {a['volume']}: "
                + ("no surviving replica to copy from"
                   if a.get("source") is None else "no candidate target")
            )
        else:
            planned.append(
                f"volume {a['volume']}: copy {a['source']} -> {a['target']}"
            )
    if dry_run:
        return {"planned": planned}
    applied = []
    for a in actions:
        if a.get("target") is None or a.get("source") is None:
            continue
        # explicit deadline budgets (the bare-call-site audit): shard and
        # volume pulls can be multi-GB (the receiver's ranged GETs retry
        # under the unified RetryPolicy), mounts are quick metadata ops
        if a.get("ec_volume") is not None:
            vid = a["ec_volume"]
            env.post(
                f"{a['target_url']}/admin/ec/copy",
                {"volume": vid, "collection": a.get("collection", ""),
                 "shards": a["shards"], "source": a["source_url"]},
                timeout=3600,
            )
            env.post(
                f"{a['target_url']}/admin/ec/mount",
                {"volume": vid, "collection": a.get("collection", "")},
                timeout=60,
            )
            applied.append(
                f"ec volume {vid}: copied shards {a['shards']}"
                f" {a['source']} -> {a['target']}"
            )
            continue
        env.post(
            f"{a['target_url']}/admin/volume/copy",
            {"volume": a["volume"], "source": a["source_url"]},
            timeout=3600,
        )
        applied.append(
            f"volume {a['volume']}: copied {a['source']} -> {a['target']}"
        )
    return {"planned": planned, "applied": applied}


EXECUTORS = {
    "fix_replication": _exec_fix_replication,
    "ec_rebuild": _exec_ec_rebuild,
    "scrub": _exec_scrub,
    "vacuum": _exec_vacuum,
    "balance": _exec_balance,
    "evacuate": _exec_evacuate,
}


def execute(task: RepairTask, env, dry_run: bool = False,
            scheduler=None, rebuild_mode: str = "auto") -> dict:
    """Run one task's executor; every repair is traced as a
    `maintenance.<type>` span so /debug/traces and cluster.trace show
    healing next to the foreground traffic it must not starve.
    `scheduler`/`rebuild_mode` feed the ec_rebuild mode choice (live
    dispatch pressure + the daemon's configured default)."""
    fn = EXECUTORS[task.type]
    kwargs = {}
    if task.type == "ec_rebuild":
        kwargs = {"scheduler": scheduler, "rebuild_mode": rebuild_mode}
    with trace.span(
        f"maintenance.{task.type}", role="master",
        volume=task.volume_id, node=task.node, dry_run=dry_run,
    ):
        return fn(task, env, dry_run, **kwargs)
