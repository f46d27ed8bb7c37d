"""ec.* commands — the north-star workload's operational surface
(reference `weed/shell/command_ec_encode.go:58-300`, `command_ec_rebuild.go:99`,
`command_ec_decode.go:77`, `command_ec_balance.go`).

The port's copy of `seaweedfs_tpu/shell/commands_ec.py`: `ec.encode`,
`ec.decode`, `ec.rebuild` and `ec.balance`. The GF(2^8) work runs on the
volume servers' device: `/admin/ec/generate`, `/admin/ec/rebuild`,
`/admin/ec/to_volume` with data shards missing, and every hop of a
pipelined rebuild launch `gf256_matmul` there.

`ec.rebuild` runs in two modes. **classic** pulls every needed shard to
one rebuilder, which decodes locally. **pipelined** has each surviving
holder scale its own shards by the decode coefficients and XOR-forward one
partial sum hop to hop, the rebuilder (last hop) writing the accumulated
sum: no node receives more than ~targets x shard-size. **auto** picks per
repair from the chain's hop count (and the repair scheduler's pressure,
which the verb does not pass). The rebuilt shards are the same bytes under
either mode.

One difference from the JAX package: a hop whose codec fails answers
`codec_failed`, and the orchestrator raises `ShellError` naming the hop
instead of restarting the chain or falling back to classic, so a kernel
fault never turns into a quiet classic repair.

Observability, as in the JAX package: a rebuild runs inside an
`ec.rebuild` span, so every hop's POST joins its trace; the plane counts
into `decoder.REPAIR` (which feeds the repair metric families) and times
each stage into `SeaweedFS_volume_ec_repair_seconds{mode,stage}`; a
fallback journals `fallback_repair`, and a chain restart journals
`chain_restart` beside a warning on this module's logger. The restart
event carries the failed hop's whole `detail` (the exception's type and
text and the forward's elapsed ms), where the JAX event cuts it to 200
characters, so the journal names the cause of a hop stall."""

from __future__ import annotations

import json
import logging
import time
import urllib.parse
import uuid

from ..server.httpd import http_request
from ..stats import events as events_mod
from ..stats import trace as trace_mod
from ..storage.erasure_coding import decoder as ec_decoder
from ..storage.erasure_coding.ec_volume import TRANSPORT_ERRORS
from .env import CommandEnv, ServerView, ShellError
from .registry import command, dry_run_flag, parse_flags, render_plan

log = logging.getLogger(__name__)

TOTAL_SHARDS = 14
DATA_SHARDS = 10

# partial chunk ceiling: ranges per chain pass. Big enough to amortize
# the hop HTTP overhead, small enough that a mid-chain death retries
# cheaply.
PARTIAL_CHUNK = 4 * 1024 * 1024
# auto chunk sizing (chunk=None): aim for ~STREAM_TARGET_CHUNKS chunks
# per shard so the hop-parallel overlap engages on any shard size
PARTIAL_CHUNK_MIN = 4096
STREAM_TARGET_CHUNKS = 16

# streaming sessions: per-hop in-flight chunk window (the bounded queue
# each hop parks computed chunks on while its forwarder ships them)
STREAM_WINDOW = 4


def auto_chunk(shard_size: int) -> int:
    """The chunk size apply_rebuild_pipelined uses when none is forced:
    ~1/16th of the shard, clamped to [PARTIAL_CHUNK_MIN, PARTIAL_CHUNK]."""
    want = -(-max(shard_size, 1) // STREAM_TARGET_CHUNKS)
    return min(PARTIAL_CHUNK, max(PARTIAL_CHUNK_MIN, want))


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
    device (gf256_matmul on the card), drop pulled-only inputs, re-mount.
    The whole-shard pulls are flagged `repair` so the rebuilder counts
    them into bytes_on_wire["classic"]."""
    _, mseconds, _, _ = ec_decoder.repair_metrics()
    vid, collection = plan["volume"], plan["collection"]
    rb = plan["rebuilder_url"]
    t0 = time.perf_counter()
    for p in plan["pulls"]:
        env.post(
            f"{rb}/admin/ec/copy",
            {"volume": vid, "collection": collection,
             "shards": p["shards"], "source": p["source_url"],
             "repair": True},
            timeout=3600,
        )
    mseconds.labels("classic", "pull").observe(time.perf_counter() - t0)
    t1 = time.perf_counter()
    out = env.post(
        f"{rb}/admin/ec/rebuild",
        {"volume": vid, "collection": collection}, timeout=3600,
    )
    mseconds.labels("classic", "decode").observe(time.perf_counter() - t1)
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


class PipelinedRebuildError(ShellError):
    """A pipelined rebuild could not complete; `reason` is one of
    decoder.REPAIR_FALLBACK_REASONS and the caller falls back to classic."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(f"pipelined rebuild failed ({reason}): {detail}")
        self.reason = reason
        self.detail = detail


def plan_rebuild_pipelined(
    env: CommandEnv, vid: int, collection: str = "",
    exclude: tuple[str, ...] = (),
    prefer_rebuilder: str | None = None,
) -> dict | None:
    """The partial-sum chain plan: decode coefficients per holder, hops
    ordered with the rebuilder LAST (it lands the accumulated sum in its
    /admin/ec/partial/start state). `exclude` drops dead hops on a chain
    restart. `prefer_rebuilder` pins the writer on restarts: the
    committed frontier lives in the old rebuilder's partial state, so a
    still-usable preferred holder always wins over the (shard-count,
    free_slots) ranking. None when nothing is missing; ShellError when the
    surviving (non-excluded) shards drop below 10."""
    servers = env.servers()
    all_holders = [sv for sv in servers if vid in sv.ec_shards]
    holders = [sv for sv in all_holders if sv.id not in exclude]
    # targets = shards missing from the WHOLE cluster; a dead hop's
    # shards are unavailable as chain inputs but not lost
    present_all = sorted(
        {s for sv in all_holders for s in sv.ec_shards[vid]})
    missing = [s for s in range(TOTAL_SHARDS) if s not in present_all]
    if not missing:
        return None
    usable = sorted({s for sv in holders for s in sv.ec_shards[vid]})
    if len(usable) < DATA_SHARDS:
        raise ShellError(
            f"volume {vid}: only {len(usable)} usable shards"
            f" (excluding {list(exclude)}), cannot rebuild"
        )
    use, matrix = ec_decoder.repair_coefficients(usable, missing)
    rebuilder = next(
        (sv for sv in holders if sv.id == prefer_rebuilder), None
    ) or max(
        holders, key=lambda sv: (len(sv.ec_shards[vid]), sv.free_slots())
    )
    # each `use` shard contributes from exactly one hop; hops ordered
    # non-rebuilders first (stable by id), rebuilder last as the writer
    assigned: set[int] = set()
    chain: list[dict] = []
    others = sorted(
        (sv for sv in holders if sv.id != rebuilder.id),
        key=lambda sv: sv.id,
    )
    for sv in others + [rebuilder]:
        own = [
            s for s in sorted(sv.ec_shards[vid])
            if s in use and s not in assigned
        ]
        assigned.update(own)
        if not own and sv.id != rebuilder.id:
            continue  # nothing to contribute, not the writer: skip the hop
        chain.append({
            "server": sv.id, "url": sv.http, "shards": own,
            "coefs": {
                str(s): [int(matrix[t, use.index(s)])
                         for t in range(len(missing))]
                for s in own
            },
            "write": sv.id == rebuilder.id,
        })
    return {
        "volume": vid, "collection": collection, "mode": "pipelined",
        "rebuilder": rebuilder.id, "rebuilder_url": rebuilder.http,
        "missing": missing, "present": present_all, "use": use,
        "chain": chain,
    }


def describe_rebuild_pipelined(plan: dict) -> list[str]:
    """Display lines for a plan_rebuild_pipelined plan."""
    steps = []
    for hop in plan["chain"]:
        if hop["write"]:
            steps.append(
                f"{hop['server']}: add shards {hop['shards']}, write"
                f" rebuilt {plan['missing']} (chain terminal)"
            )
        else:
            steps.append(
                f"{hop['server']}: scale shards {hop['shards']},"
                f" XOR-forward one partial"
            )
    steps.append(
        f"bytes-on-wire at rebuilder ~{len(plan['missing'])}x shard-size"
        f" (classic: {DATA_SHARDS}x)"
    )
    return steps


def choose_rebuild_mode(pplan: dict | None, pressure: dict | None = None
                        ) -> tuple[str, str]:
    """auto-mode policy: a chain needs >= 3 contributing nodes before
    hop-forwarding beats one pull burst; a 2-node chain is still worth it
    when the repair scheduler is under pressure (token bucket drained or
    in-flight near the global or per-node cap); single-holder volumes
    rebuild locally either way, so classic's simpler ladder wins."""
    if pplan is None:
        return "classic", "no pipelined plan"
    hops = len(pplan["chain"])
    if hops >= 3:
        return "pipelined", f"{hops}-hop chain cuts rebuilder fan-in" \
            f" {DATA_SHARDS}x -> {len(pplan['missing'])}x"
    if hops == 2 and pressure is not None:
        node_hot = any(
            n >= pressure.get("per_node_limit", 1)
            for n in pressure.get("node_inflight", {}).values()
        )
        if (
            pressure.get("tokens", 2.0) < 1.0
            or pressure.get("in_flight", 0)
            >= max(1, pressure.get("global_limit", 4) - 1)
            or node_hot
        ):
            return "pipelined", "2-hop chain under repair-scheduler pressure"
    return "classic", "too_few_holders"


def apply_rebuild_pipelined(
    env: CommandEnv, plan: dict, chunk: int | None = None,
    stream: bool | None = None, window: int = STREAM_WINDOW,
    stall_timeout: float | None = None,
) -> tuple[list[int], dict]:
    """Execute a pipelined plan with the retry ladder: a dead hop
    restarts the chain minus that hop (re-planned coefficients) while
    the survivors still cover 10 shards; a CRC mismatch or stream stall
    restarts the SAME chain once and escalates to the typed fallback on
    a repeat; exhausted restarts raise PipelinedRebuildError so the
    caller falls back to classic. A hop's `codec_failed` raises
    ShellError at once: no restart, no exclusion, no fallback.

    Restarts RESUME: the rebuilder's partial-write state survives a
    failed chain (chunks land in order, so its committed frontier is
    exact) and the re-planned chain re-sends only the uncommitted
    suffix. The state is aborted on any terminal failure.

    `stream=None` auto-picks: multi-hop, multi-chunk repairs use the
    streaming session mode; True/False forces. `chunk=None` sizes chunks
    via auto_chunk() off the real shard size. Returns (rebuilt shard ids,
    wire stats)."""
    excluded: list[str] = []
    restarts = 0
    strikes = {r: 0 for r in ("crc_mismatch", "chunk_crc", "stream_stall")}
    rb_url = plan["rebuilder_url"]
    try:
        while True:
            try:
                return _run_chain(env, plan, chunk, restarts, stream=stream,
                                  window=window, stall_timeout=stall_timeout)
            except _HopFailed as e:
                reason = e.reason \
                    if e.reason in ec_decoder.REPAIR_RESTART_REASONS \
                    else "hop_failed"
                ec_decoder.REPAIR.inc("restarts", reason)
                # the hop's whole detail: the journal, not only the log,
                # must name what failed (type, text, elapsed ms)
                events_mod.emit(
                    "chain_restart", volume=plan["volume"],
                    node=e.server, reason=reason, detail=e.detail,
                    **({"chunk": e.chunk} if e.chunk is not None else {}),
                )
                log.warning("ec.rebuild volume %s: chain restart (%s) at node %r,"
                            " chunk %s: %s", plan["volume"], reason, e.server,
                            e.chunk, e.detail)
                restarts += 1
                if reason in strikes:
                    strikes[reason] += 1
                    if strikes[reason] >= 2:  # twice: stop pretending
                        raise PipelinedRebuildError(reason, e.detail)
                elif e.server:
                    excluded.append(e.server)
                elif restarts > 1:
                    # a hop failed twice without ever being attributable
                    # (pure transport noise): classic is honest fallback
                    raise PipelinedRebuildError("hop_failed", e.detail)
                try:
                    new_plan = plan_rebuild_pipelined(
                        env, plan["volume"], plan["collection"],
                        exclude=tuple(excluded),
                        prefer_rebuilder=plan["rebuilder"],
                    )
                except ShellError as err:
                    raise PipelinedRebuildError(
                        "insufficient_shards", str(err))
                if new_plan is None:  # healed underneath us
                    return [], {"bytes_on_wire_total": 0,
                                "bytes_on_wire_rebuilder": 0,
                                "hops": 0, "restarts": restarts}
                if new_plan["rebuilder_url"] != rb_url:
                    # the committed frontier lives on the OLD rebuilder:
                    # drop its state, the new writer starts from byte 0
                    _abort(env, rb_url, plan["volume"])
                    rb_url = new_plan["rebuilder_url"]
                plan = new_plan
    except BaseException:
        # terminal exit (typed fallback, codec failure or unexpected): the
        # partial state will not be resumed; abort it so no .tmp remains
        _abort(env, rb_url, plan["volume"])
        raise


def _abort(env: CommandEnv, rb_url: str, vid: int) -> None:
    try:
        env.post(f"{rb_url}/admin/ec/partial/abort", {"volume": vid},
                 timeout=30)
    except TRANSPORT_ERRORS:
        pass  # best effort: the state dies with its server anyway


class _HopFailed(Exception):
    def __init__(self, server: str, reason: str, detail: str = "",
                 chunk: int | None = None) -> None:
        super().__init__(f"chain hop {server or '?'} failed: {reason}")
        self.server = server
        self.reason = reason
        self.detail = detail
        self.chunk = chunk


def _json_or_empty(out: bytes) -> dict:
    try:
        return json.loads(out) if out else {}
    except ValueError:
        return {}


def _reason_of(resp: dict) -> str:
    err = resp.get("error", "")
    return err if err in ec_decoder.REPAIR_RESTART_REASONS else "hop_failed"


def _hop_failed(resp: dict, server: str, chunk: int | None = None) -> Exception:
    """The exception for a hop's failed answer: ShellError on the codec's
    own failure (never a restart or a fallback), else _HopFailed for the
    retry ladder."""
    server = resp.get("failed_hop_server") or server
    if resp.get("error") == "codec_failed":
        return ShellError(
            f"pipelined rebuild: codec_failed on hop {server}:"
            f" {resp.get('detail', '')}")
    # the detail first and whole: it names the cause (a timeout, a refusal
    # or a reset) and the forward's elapsed ms; the rest of the answer after
    rest = {k: v for k, v in resp.items() if k != "detail"}
    return _HopFailed(server, _reason_of(resp), f"{resp.get('detail', '')} {rest}",
                      chunk=resp.get("chunk", chunk))


def _run_chain(env, plan, chunk, restarts, stream=None,
               window=STREAM_WINDOW,
               stall_timeout=None) -> tuple[list[int], dict]:
    mseconds = ec_decoder.repair_metrics()[1]
    vid, collection = plan["volume"], plan["collection"]
    rb = plan["rebuilder_url"]
    chain = plan["chain"]
    targets = plan["missing"]
    t0 = time.perf_counter()
    try:
        start = env.post(
            f"{rb}/admin/ec/partial/start",
            {"volume": vid, "collection": collection, "targets": targets,
             "resume": True},
            timeout=60,
        )
    except Exception as e:
        raise PipelinedRebuildError("start_failed", str(e)[:200])
    shard_size = int(start["shard_size"])
    committed = int(start.get("committed", 0))
    if chunk is None:
        chunk = auto_chunk(shard_size)
    mseconds.labels("pipelined", "start").observe(time.perf_counter() - t0)
    saved = 0
    if committed and len(chain) > 1:
        # bytes a from-scratch restart would have re-sent: the committed
        # prefix, stacked per target, over every hop link (a 1-hop chain
        # moves no partial-sum bytes at all)
        saved = committed * len(targets) * (len(chain) - 1)
        ec_decoder.REPAIR.add_resumed(saved)
    use_stream = stream if stream is not None else (
        len(chain) > 1 and shard_size - committed > chunk)
    t1 = time.perf_counter()
    if use_stream:
        received, read_bytes = _stream_chunks(
            plan, chunk, window, shard_size, committed,
            stall_timeout=stall_timeout)
    else:
        received, read_bytes = _serial_chunks(
            plan, chunk, shard_size, committed)
    mseconds.labels("pipelined", "chain").observe(time.perf_counter() - t1)
    t2 = time.perf_counter()
    out = env.post(
        f"{rb}/admin/ec/partial/commit",
        {"volume": vid, "collection": collection}, timeout=60,
    )
    mseconds.labels("pipelined", "commit").observe(time.perf_counter() - t2)
    stats = {
        "bytes_on_wire_total": sum(received),
        "bytes_on_wire_rebuilder": received[-1] if received else 0,
        "shard_size": shard_size,
        "hops": len(chain),
        "restarts": restarts,
        "per_hop_received": received,
        "survivor_bytes_read": sum(read_bytes),
        "per_hop_read": read_bytes,
        "resumed_bytes_saved": saved,
        "streamed": bool(use_stream),
        "targets": len(targets),
    }
    return out.get("rebuilt", targets), stats


def _chunk_spans(shard_size: int, committed: int, chunk: int):
    for off in range(committed, max(shard_size, 1), chunk):
        size = min(chunk, shard_size - off)
        if size <= 0:
            return
        yield off, size


def _serial_chunks(plan, chunk, shard_size, committed):
    """One nested chain pass per chunk: single-chunk repairs, 1-hop
    chains, and the forced comparison with the streaming mode."""
    vid, collection = plan["volume"], plan["collection"]
    chain = plan["chain"]
    targets_q = ",".join(str(t) for t in plan["missing"])
    received = [0] * len(chain)
    read_bytes = [0] * len(chain)
    for off, size in _chunk_spans(shard_size, committed, chunk):
        url = (
            chain[0]["url"] + f"/admin/ec/partial?volume={vid}"
            f"&collection={urllib.parse.quote(collection)}"
            f"&offset={off}&size={size}&targets={targets_q}"
            f"&chain={urllib.parse.quote(json.dumps(chain))}"
        )
        try:
            status, _, out = http_request("POST", url, b"", timeout=120)
        except (IOError, OSError) as e:
            raise _HopFailed(chain[0]["server"], "hop_failed",
                             str(e)[:200])
        resp = _json_or_empty(out)
        if status != 200:
            raise _hop_failed(resp, chain[0]["server"])
        for i, n in enumerate(resp.get("received", [])[-len(chain):]):
            received[i] += int(n)
        for i, n in enumerate(resp.get("read", [])[-len(chain):]):
            read_bytes[i] += int(n)
    return received, read_bytes


def _stream_chunks(plan, chunk, window, shard_size, committed,
                   stall_timeout=None):
    """The hop-parallel dataflow: open a session along the chain once,
    then fire chunk POSTs that each hop ACKs after local compute +
    enqueue — chunk k rides the forwarder threads downstream while every
    hop computes chunk k+1, so the pass costs ~(hops + chunks)
    chunk-times instead of hops x chunks. close() flushes, cascades, and
    reports per-hop wire/read accounting + the writer's committed
    frontier (the resume point when anything failed)."""
    vid, collection = plan["volume"], plan["collection"]
    chain = plan["chain"]
    head = chain[0]
    session = uuid.uuid4().hex
    open_payload = {
        "session": session, "volume": vid, "collection": collection,
        "targets": plan["missing"], "chain": chain, "window": window,
    }
    if stall_timeout is not None:
        open_payload["stall_timeout"] = stall_timeout
    try:
        status, _, out = http_request(
            "POST", head["url"] + "/admin/ec/partial/stream/open",
            json.dumps(open_payload).encode(),
            headers={"Content-Type": "application/json"}, timeout=120,
        )
    except (IOError, OSError) as e:
        raise _HopFailed(head["server"], "hop_failed", str(e)[:200])
    if status != 200:
        raise _hop_failed(_json_or_empty(out), head["server"])
    close_url = (head["url"]
                 + f"/admin/ec/partial/stream/close?session={session}")
    try:
        for seq, (off, size) in enumerate(
                _chunk_spans(shard_size, committed, chunk)):
            url = (
                head["url"] + "/admin/ec/partial/stream/chunk"
                f"?session={session}&seq={seq}&offset={off}&size={size}"
            )
            try:
                status, _, out = http_request("POST", url, b"", timeout=120)
            except (IOError, OSError) as e:
                raise _HopFailed(head["server"], "hop_failed",
                                 str(e)[:200], chunk=seq)
            if status != 200:
                raise _hop_failed(_json_or_empty(out), head["server"], seq)
    except (_HopFailed, ShellError):
        try:  # tear the session down chain-wide; the ladder resumes
            http_request("POST", close_url, b"", timeout=60)
        except Exception:
            pass
        raise
    try:
        status, _, out = http_request("POST", close_url, b"", timeout=240)
    except (IOError, OSError) as e:
        raise _HopFailed(head["server"], "hop_failed", str(e)[:200])
    close = _json_or_empty(out)
    if status != 200 or not close.get("ok"):
        raise _hop_failed(close, head["server"])
    landed = close.get("committed")
    if landed is not None and int(landed) < shard_size:
        raise _HopFailed(
            "", "hop_failed",
            f"stream closed at {landed}/{shard_size} committed")
    received = [int(n) for n in close.get("received", [])]
    read_bytes = [int(n) for n in close.get("read", [])]
    received += [0] * (len(chain) - len(received))
    read_bytes += [0] * (len(chain) - len(read_bytes))
    return received, read_bytes


def run_rebuild(
    env: CommandEnv, vid: int, collection: str = "", mode: str = "auto",
    pressure: dict | None = None, dry_run: bool = False,
    stream: bool | None = None,
) -> dict:
    """Choose the mode, plan and apply, with the typed fallback to
    classic. Returns a dict: {healed} | {dry_run, mode, planned} |
    {mode, planned, rebuilt, rebuilder, stats?}.

    The whole repair runs inside an `ec.rebuild` span: every hop POST
    inherits its trace id, so `cluster.trace` shows the start -> partial
    hops -> commit chain as one cross-node trace (under the maintenance
    task's span from the daemon; the root from the shell)."""
    with trace_mod.span("ec.rebuild", volume=vid, mode=mode):
        return _run_rebuild(env, vid, collection, mode, pressure, dry_run,
                            stream)


def _run_rebuild(
    env: CommandEnv, vid: int, collection: str, mode: str,
    pressure: dict | None, dry_run: bool, stream: bool | None = None,
) -> dict:
    if mode not in ("auto",) + ec_decoder.REPAIR_MODES:
        raise ShellError(f"mode must be auto|classic|pipelined, got {mode}")
    plan = plan_rebuild(env, vid, collection)
    if plan is None:
        return {"healed": True, "planned": [], "mode": mode}
    pplan = None
    if mode != "classic":
        try:
            pplan = plan_rebuild_pipelined(env, vid, collection)
        except (ShellError, IOError, OSError):
            pplan = None  # no usable chain (or a transient topology
            #               fetch failure): classic still repairs
    if mode == "auto":
        mode, _why = choose_rebuild_mode(pplan, pressure)
        if mode == "classic" and pplan is not None:
            ec_decoder.REPAIR.inc("fallbacks", "too_few_holders")
            events_mod.emit("fallback_repair", volume=vid,
                            reason="too_few_holders")
    if mode == "pipelined" and pplan is None:
        ec_decoder.REPAIR.inc("fallbacks", "insufficient_shards")
        events_mod.emit("fallback_repair", volume=vid,
                        reason="insufficient_shards")
        mode = "classic"
    if dry_run:
        planned = describe_rebuild_pipelined(pplan) if mode == "pipelined" \
            else describe_rebuild(plan)
        return {"dry_run": True, "mode": mode, "planned": planned}
    if mode == "pipelined":
        planned = describe_rebuild_pipelined(pplan)
        try:
            rebuilt, stats = apply_rebuild_pipelined(env, pplan,
                                                     stream=stream)
            return {"mode": "pipelined", "planned": planned,
                    "rebuilt": rebuilt, "rebuilder": pplan["rebuilder"],
                    "stats": stats}
        except PipelinedRebuildError as e:
            ec_decoder.REPAIR.inc("fallbacks", e.reason)
            events_mod.emit("fallback_repair", volume=vid, reason=e.reason,
                            detail=e.detail[:200])
            # classic stays the fallback: re-plan (the partial state was
            # aborted server-side)
            plan = plan_rebuild(env, vid, collection)
            if plan is None:
                return {"healed": True, "planned": planned, "mode": mode}
    planned = describe_rebuild(plan)
    rebuilt = apply_rebuild(env, plan)
    return {"mode": "classic", "planned": planned, "rebuilt": rebuilt,
            "rebuilder": plan["rebuilder"]}


@command("ec.rebuild", "-volumeId <n> [-collection name]"
         " [-mode pipelined|classic|auto] [-stream true|false]"
         " [-dryRun|-apply] — rebuild missing shards; pipelined streams"
         " GF partial sums hop to hop (~1x shard-size at the rebuilder"
         " vs 10x classic), chunks pipelined hop-parallel by default",
         needs_lock=True)
def cmd_ec_rebuild(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    stream = None
    if "stream" in flags:
        stream = flags["stream"] not in ("false", "0", "no")
    out = run_rebuild(
        env, vid, flags.get("collection", ""),
        mode=flags.get("mode", "auto"), dry_run=dry_run_flag(flags),
        stream=stream,
    )
    if out.get("healed"):
        return f"volume {vid}: all {TOTAL_SHARDS} shards present"
    if out.get("dry_run"):
        return render_plan(f"ec.rebuild [{out['mode']}]", out["planned"])
    stats = out.get("stats")
    if stats is not None:
        return (
            f"volume {vid}: rebuilt shards {out['rebuilt']} on"
            f" {out['rebuilder']} (pipelined"
            f"{', streamed' if stats.get('streamed') else ''},"
            f" {stats['hops']} hops,"
            f" {stats['bytes_on_wire_rebuilder']} B at rebuilder,"
            f" {stats['bytes_on_wire_total']} B total on wire)"
        )
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
