"""ec.* commands — the north-star workload's operational surface
(reference `weed/shell/command_ec_encode.go:58-300`, `command_ec_rebuild.go:99`,
`command_ec_decode.go:77`, `command_ec_balance.go`).

The port's copy of `seaweedfs_tpu/shell/commands_ec.py`: `ec.encode`,
`ec.decode`, `ec.rebuild` and `ec.balance`, with the rebuild plan shared by
the verb. The GF(2^8) work runs on the volume servers' device:
`/admin/ec/generate`, `/admin/ec/rebuild` and `/admin/ec/to_volume` with
data shards missing launch `gf256_matmul` there.

`ec.rebuild` repairs by the **classic** plan: every needed shard is pulled
to one rebuilder, which decodes locally. `-mode auto` and `-mode classic`
both run it. The JAX package's **pipelined** mode (each holder scales its
own shards by the decode coefficients and forwards one partial sum hop to
hop) needs the partial and streaming rebuild plane, which is not ported:
`-mode pipelined` raises `ShellError`. The rebuilt shards are the same
bytes under either mode. Repair metrics, traces and events are not
ported."""

from __future__ import annotations

from .env import CommandEnv, ServerView, ShellError
from .registry import command, dry_run_flag, parse_flags, render_plan

TOTAL_SHARDS = 14
DATA_SHARDS = 10
REBUILD_MODES = ("auto", "classic", "pipelined")


def _spread_plan(
    servers: list[ServerView], source: ServerView
) -> dict[str, list[int]]:
    """Assign the 14 shards across servers, rack-aware round-robin
    (`command_ec_encode.go spreadEcShards` via pickNEcShardsToMove)."""
    # order servers: spread racks first, most free slots first
    by_rack: dict[tuple, list[ServerView]] = {}
    for sv in servers:
        by_rack.setdefault((sv.dc, sv.rack), []).append(sv)
    for group in by_rack.values():
        group.sort(key=lambda s: -s.free_slots())
    rotation: list[ServerView] = []
    while any(by_rack.values()):
        for key in sorted(by_rack, key=lambda k: -sum(s.free_slots() for s in by_rack[k])):
            if by_rack[key]:
                rotation.append(by_rack[key].pop(0))
    if not rotation:
        rotation = [source]
    plan: dict[str, list[int]] = {}
    for shard in range(TOTAL_SHARDS):
        sv = rotation[shard % len(rotation)]
        plan.setdefault(sv.id, []).append(shard)
    return plan


def _collect_ec_volume_ids(env: CommandEnv, flags: dict) -> list[tuple[int, str]]:
    if "volumeId" in flags:
        vid = int(flags["volumeId"])
        for sv in env.servers():
            if vid in sv.volumes:
                return [(vid, sv.volumes[vid].get("collection", ""))]
        raise ShellError(f"volume {vid} not found")
    # -collection mode: every volume of the collection (quiet-volume detection
    # — fullness/quiet filters — are master-side in the reference; size filter here)
    collection = flags.get("collection", "")
    out = []
    seen = set()
    for sv in env.servers():
        for v in sv.volumes.values():
            if v.get("collection", "") == collection and v["id"] not in seen:
                seen.add(v["id"])
                out.append((v["id"], collection))
    return out


@command("ec.encode", "-volumeId <n> | -collection <name> — erasure-code volumes "
         "(RS(10,4) on the GPU path)", needs_lock=True)
def cmd_ec_encode(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    lines = []
    for vid, collection in _collect_ec_volume_ids(env, flags):
        lines.append(_ec_encode_one(env, vid, collection))
    return "\n".join(lines) if lines else "no volumes to encode"


def _ec_encode_one(env: CommandEnv, vid: int, collection: str) -> str:
    servers = env.servers()
    holders = [sv for sv in servers if vid in sv.volumes]
    if not holders:
        raise ShellError(f"volume {vid} not found")
    source = holders[0]
    # 1. freeze all replicas (`doEcEncode` marks readonly first)
    for sv in holders:
        env.post(f"{sv.http}/admin/volume/readonly",
                 {"volume": vid, "readonly": True})
    # 2. generate 14 shards + .ecx + .vif on the source server
    env.post(f"{source.http}/admin/ec/generate",
             {"volume": vid, "collection": collection}, timeout=3600)
    # 3. spread shards rack-aware; receivers pull from the source
    plan = _spread_plan(servers, source)
    for sv_id, shards in plan.items():
        sv = next(s for s in servers if s.id == sv_id)
        if sv.id != source.id:
            env.post(
                f"{sv.http}/admin/ec/copy",
                {"volume": vid, "collection": collection, "shards": shards,
                 "source": source.http},
                timeout=3600,
            )
    # 4. delete source shards that now live elsewhere, then mount everywhere
    keep = plan.get(source.id, [])
    drop = [s for s in range(TOTAL_SHARDS) if s not in keep]
    if drop:
        env.post(
            f"{source.http}/admin/ec/delete_shards",
            {"volume": vid, "collection": collection, "shards": drop},
        )
    for sv_id in plan:
        sv = next(s for s in servers if s.id == sv_id)
        env.post(f"{sv.http}/admin/ec/mount",
                 {"volume": vid, "collection": collection})
    # 5. drop the original volume replicas (`doEcEncode` final step)
    for sv in holders:
        env.post(f"{sv.http}/admin/ec/delete_volume", {"volume": vid})
    placed = ", ".join(f"{k}:{v}" for k, v in sorted(plan.items()))
    return f"ec.encode volume {vid}: shards spread {placed}"


@command("ec.decode", "-volumeId <n> [-collection name] — reconstruct the "
         "normal volume from EC shards", needs_lock=True)
def cmd_ec_decode(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    collection = flags.get("collection", "")
    servers = env.servers()
    holders = [sv for sv in servers if vid in sv.ec_shards]
    if not holders:
        raise ShellError(f"no EC shards for volume {vid}")
    # collect every shard onto one server (`command_ec_decode.go:77`)
    target = max(holders, key=lambda sv: len(sv.ec_shards[vid]))
    have = set(target.ec_shards[vid])
    for sv in holders:
        if sv.id == target.id:
            continue
        missing = [s for s in sv.ec_shards[vid] if s not in have]
        if missing:
            env.post(
                f"{target.http}/admin/ec/copy",
                {"volume": vid, "collection": collection, "shards": missing,
                 "source": sv.http},
                timeout=3600,
            )
            have.update(missing)
    if len([s for s in have if s < DATA_SHARDS]) < DATA_SHARDS and len(have) < DATA_SHARDS:
        raise ShellError(f"only {len(have)} shards available, need {DATA_SHARDS}")
    env.post(
        f"{target.http}/admin/ec/to_volume",
        {"volume": vid, "collection": collection}, timeout=3600,
    )
    # unmount EC + delete shards everywhere
    for sv in holders:
        env.post(f"{sv.http}/admin/ec/unmount", {"volume": vid})
        env.post(
            f"{sv.http}/admin/ec/delete_shards",
            {"volume": vid, "collection": collection,
             "shards": list(range(TOTAL_SHARDS)), "delete_index": True},
        )
    return f"ec.decode volume {vid}: reconstructed on {target.id}"


def plan_rebuild(env: CommandEnv, vid: int, collection: str = "") -> dict | None:
    """The rebuild plan for one EC volume: which holder rebuilds, which
    shards it pulls from whom, which shards are missing. None when all 14
    shards are present; raises when fewer than 10 survive."""
    servers = env.servers()
    holders = [sv for sv in servers if vid in sv.ec_shards]
    present = sorted({s for sv in holders for s in sv.ec_shards[vid]})
    missing = [s for s in range(TOTAL_SHARDS) if s not in present]
    if not missing:
        return None
    if len(present) < DATA_SHARDS:
        raise ShellError(
            f"volume {vid}: only {len(present)} shards left, cannot rebuild"
        )
    # rebuilder = holder with the most local shards and enough free slots
    rebuilder = max(holders, key=lambda sv: (len(sv.ec_shards[vid]), sv.free_slots()))
    local = set(rebuilder.ec_shards[vid])
    pulls = []
    for sv in holders:
        if sv.id == rebuilder.id:
            continue
        pull = [s for s in sv.ec_shards[vid] if s not in local]
        if pull:
            pulls.append({"source": sv.id, "source_url": sv.http,
                          "shards": pull})
            local.update(pull)
    return {
        "volume": vid, "collection": collection,
        "rebuilder": rebuilder.id, "rebuilder_url": rebuilder.http,
        "missing": missing, "present": present, "pulls": pulls,
        "own": sorted(rebuilder.ec_shards[vid]),
    }


def describe_rebuild(plan: dict) -> list[str]:
    """Display lines for a plan_rebuild plan: the verb's dry-run output."""
    steps = [
        f"pull shards {p['shards']} from {p['source']} to"
        f" {plan['rebuilder']}" for p in plan["pulls"]
    ]
    steps.append(f"rebuild shards {plan['missing']} on {plan['rebuilder']}")
    return steps


def apply_rebuild(env: CommandEnv, plan: dict) -> list[int]:
    """Execute a plan_rebuild plan: pull inputs, rebuild on the rebuilder's
    device (gf256_matmul on the card), drop pulled-only inputs, re-mount."""
    vid, collection = plan["volume"], plan["collection"]
    rb = plan["rebuilder_url"]
    for p in plan["pulls"]:
        env.post(
            f"{rb}/admin/ec/copy",
            {"volume": vid, "collection": collection,
             "shards": p["shards"], "source": p["source_url"]},
            timeout=3600,
        )
    out = env.post(
        f"{rb}/admin/ec/rebuild",
        {"volume": vid, "collection": collection}, timeout=3600,
    )
    # drop shards the rebuilder only pulled as rebuild inputs, keep its own +
    # the rebuilt ones, then re-mount to refresh its shard list
    pulled = [s for p in plan["pulls"] for s in p["shards"]]
    keep = set(plan["own"]) | set(out.get("rebuilt", []))
    drop = [s for s in pulled if s not in keep]
    if drop:
        env.post(
            f"{rb}/admin/ec/delete_shards",
            {"volume": vid, "collection": collection, "shards": drop},
        )
    env.post(f"{rb}/admin/ec/mount",
             {"volume": vid, "collection": collection})
    return out.get("rebuilt", plan["missing"])


def run_rebuild(
    env: CommandEnv, vid: int, collection: str = "", mode: str = "auto",
    dry_run: bool = False,
) -> dict:
    """Choose the mode, plan and apply. Returns a dict:
    {healed} | {dry_run, mode, planned} | {mode, planned, rebuilt, rebuilder}.
    `auto` and `classic` run the classic plan; `pipelined` raises, since
    its plane is not ported."""
    if mode not in REBUILD_MODES:
        raise ShellError(f"mode must be auto|classic|pipelined, got {mode}")
    if mode == "pipelined":
        raise ShellError(
            "ec.rebuild -mode pipelined: the pipelined partial-sum rebuild "
            "plane is not ported; use -mode classic or -mode auto"
        )
    plan = plan_rebuild(env, vid, collection)
    if plan is None:
        return {"healed": True, "planned": [], "mode": mode}
    planned = describe_rebuild(plan)
    if dry_run:
        return {"dry_run": True, "mode": "classic", "planned": planned}
    rebuilt = apply_rebuild(env, plan)
    return {"mode": "classic", "planned": planned, "rebuilt": rebuilt,
            "rebuilder": plan["rebuilder"]}


@command("ec.rebuild", "-volumeId <n> [-collection name]"
         " [-mode classic|auto|pipelined] [-dryRun|-apply] — rebuild missing"
         " shards: every needed shard pulled to one rebuilder, decoded on its"
         " device (the pipelined mode is not ported)",
         needs_lock=True)
def cmd_ec_rebuild(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    out = run_rebuild(
        env, vid, flags.get("collection", ""),
        mode=flags.get("mode", "auto"), dry_run=dry_run_flag(flags),
    )
    if out.get("healed"):
        return f"volume {vid}: all {TOTAL_SHARDS} shards present"
    if out.get("dry_run"):
        return render_plan(f"ec.rebuild [{out['mode']}]", out["planned"])
    return f"volume {vid}: rebuilt shards {out['rebuilt']} on" \
        f" {out['rebuilder']} (classic)"


@command("ec.balance", "spread EC shards evenly across servers "
         "(ref command_ec_balance.go)", needs_lock=True)
def cmd_ec_balance(env: CommandEnv, args: list[str]) -> str:
    servers = env.servers()
    moves = []
    # per EC volume: if one server holds more than ceil(14/N) shards, move extras
    vids = sorted({vid for sv in servers for vid in sv.ec_shards})
    for vid in vids:
        holders = [sv for sv in servers if vid in sv.ec_shards]
        collection = ""
        all_servers = sorted(servers, key=lambda sv: len(sv.ec_shards.get(vid, [])))
        cap = -(-TOTAL_SHARDS // max(len(servers), 1))  # ceil
        for sv in holders:
            extra = len(sv.ec_shards[vid]) - cap
            while extra > 0:
                shard = sv.ec_shards[vid][-1]
                # move to the server with fewest shards of this volume
                dst = all_servers[0]
                if dst.id == sv.id:
                    break
                env.post(
                    f"{dst.http}/admin/ec/copy",
                    {"volume": vid, "collection": collection, "shards": [shard],
                     "source": sv.http},
                    timeout=3600,
                )
                env.post(f"{dst.http}/admin/ec/mount",
                         {"volume": vid, "collection": collection})
                env.post(
                    f"{sv.http}/admin/ec/delete_shards",
                    {"volume": vid, "collection": collection, "shards": [shard]},
                )
                sv.ec_shards[vid].remove(shard)
                dst.ec_shards.setdefault(vid, []).append(shard)
                moves.append(f"volume {vid} shard {shard}: {sv.id} -> {dst.id}")
                extra -= 1
                all_servers.sort(key=lambda s: len(s.ec_shards.get(vid, [])))
    return "\n".join(moves) if moves else "EC shards already balanced"
