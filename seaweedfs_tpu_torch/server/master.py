"""Master server: assign/lookup HTTP API, heartbeat ingest, growth and vacuum.

The port's copy of the core of `seaweedfs_tpu/server/master.py` (after
`weed/server/master_server.go`, `master_server_handlers.go:36,110`,
`master_grpc_server.go:62`, `topology_vacuum.go:216`): the topology, the
file-key sequencer, the default replication, the `-ec.online` collections,
volume growth with optimistic registration, a pulse loop that expires dead
nodes and asks volume servers to compact volumes whose garbage crosses
`garbage_threshold` (unless `/vol/vacuum/disable` turned it off), and the
routes `POST /heartbeat`, `/dir/assign`, `/dir/lookup`, `GET
/dir/ec_lookup`, `/dir/status`, `/cluster/status`, `/cluster/ps`, `POST
/cluster/register`, `GET /cluster/leader`, `POST /cluster/lock`,
`/cluster/unlock`, `GET /col/list`, `POST /col/delete`,
`GET /vol/vacuum`, `POST /vol/vacuum/{enable,disable}` and `GET
/vol/status`.

The maintenance daemon (`maintenance/daemon.py`): `maintenance=True`
starts it at boot (`maintenance_dry_run` plans without executing;
`maintenance_interval` is its scan period, `repair_lazy_window` its
ec_rebuild lazy window), `POST /maintenance/enable` starts or reconfigures
it at runtime (`dryRun`, `rebuildMode`, `lazyWindow`), `POST
/maintenance/disable` pauses it, `POST /maintenance/scan` forces a scan,
and `GET /debug/maintenance` serves its status. While it is enabled,
dry-run included, it owns vacuum and the pulse's vacuum round is skipped.

The master and the daemon are host code and hold no device.

Raft HA (`raft/`, after `weed/server/raft_server.go`): `peers=` (the
`-peers` flag: every master's url, this one's included or not) starts a
`RaftNode` at `start()`, its state under `raft_dir`; `enable_raft(urls)`
starts one on a running service. The replicated state machine is the
volume-id counter (the topology's `vid_allocator` proposes
`next_volume_id`) and the file-id sequence ceiling: the leader hands out
ids only below a committed ceiling, and after any term change it commits a
barrier and fast-forwards its sequencer to the ceiling first, so no fid is
handed out twice across a failover. Log compaction snapshots both.
`/heartbeat`, `/dir/assign` and `/dir/lookup` are leader-only: a follower
answers 409 `raft.not.leader` naming the leader, which the volume servers'
heartbeats and `WeedClient` follow. `/raft/{request_vote,append_entries,
install_snapshot}` carry the raft RPCs, `GET /raft/status` shows this node,
and `POST /raft/{add,remove}` change the membership through the log
(leader-only; `cluster.raft.add`, `cluster.raft.remove`). The JAX master's
demote hook clears the native fastlane's assign profiles; the port has no
fastlane, so its raft node gets no demote hook.

Security (`security/`): with `security.write_key` set, `/dir/assign`
answers with `auth`, a write token bound to the fid that the volume
servers demand; `security.white_list` puts a `Guard` on the service.

Filers and brokers announce themselves through `/cluster/register` (the
member registry `_members`, first-seen order deciding each group's
leader); `/cluster/ps` lists the live ones and `/cluster/leader` names a
group's leader. The answer names the member's ordinal among its live group;
the filer that shards its fid leases by it comes with the native fastlane.

`faults_spec` is the `-faults` flag: "" opts the process into runtime
fault arming (`POST /debug/faults`), a spec string also arms it
(`faults.arm_from_spec`). `/dir/assign` and `/dir/lookup` pass the
`master.assign` and `master.lookup` fault points.

Observability (`stats/`): the service is metered as role "master"
(`slow_ms` is its `-slowMs` span threshold); a scrape-time collector
exports the heartbeat-fed topology gauges (`MASTER_METRIC_FAMILIES`) and
journals `heartbeat_stale`/`heartbeat_rejoin` edges; growth and the vacuum
check record spans; `/ui` is the status page.

Telemetry (`stats/{heat,aggregate,store}.py`): a `HeatRollup` turns the
heartbeats' per-volume op counters into collection and node rates (the
counters come from the native fastlane engine, so without it every rate
of the rollup reads 0), and a `TelemetryAggregator` merges the frames that ride
heartbeats, `/cluster/register` payloads and `POST /cluster/telemetry`
(leader-only) with the master's own frame, fed on the pulse. `GET
/debug/cluster/telemetry` serves the merged view in one fetch.
`telemetry_dir` (`-telemetry.dir`) turns on the process's durable spool,
`telemetry_retention_mb` its size.

Not ported: the native fastlane front door (ROADMAP 10a-3).
"""

from __future__ import annotations

import threading
import time

from ..raft import NotLeader, RaftNode
from ..security import Guard, SecurityConfig
from ..security.jwt import gen_write_jwt
from ..stats import aggregate as agg_mod
from ..stats import default_registry
from ..stats import events as events_mod
from ..stats import heat as heat_mod
from ..stats import profiler as prof_mod
from ..stats import store as store_mod
from ..stats import trace
from ..stats.metrics import _fmt_labels
from ..storage.types import TTL, ReplicaPlacement
from ..topology import Topology
from ..topology.node import VolumeInfo
from ..topology.sequence import MemorySequencer
from ..topology.volume_layout import NoWritableVolume
from ..util import faults
from .httpd import HTTPService, Request, Response, peer_url, post_json

_FP_ASSIGN = faults.register("master.assign")
_FP_LOOKUP = faults.register("master.lookup")


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30 * 1024,
        pulse_seconds: int = 5,
        default_replication: str = "000",
        meta_dir: str | None = None,
        ec_online: str = "",
        ec_online_block: int | None = None,
        garbage_threshold: float = 0.3,
        maintenance: bool = False,
        maintenance_dry_run: bool = False,
        maintenance_interval: float | None = None,
        repair_lazy_window: float = 0.0,
        faults_spec: str | None = None,
        security: SecurityConfig | None = None,
        peers: list[str] | None = None,
        raft_dir: str | None = None,
        slow_ms: float | None = None,
        telemetry_dir: str | None = None,
        telemetry_retention_mb: float | None = None,
    ) -> None:
        faults.opt_in(faults_spec)  # the -faults flag
        seq = MemorySequencer(f"{meta_dir}/sequence.json" if meta_dir else None)
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds,
            sequencer=seq,
        )
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.vacuum_enabled = True
        # -ec.online policy: collections whose volumes stream-encode
        # RS(10,4) parity on ingest instead of replica fan-out
        # (comma-separated names; "*" = every collection incl. default)
        self.ec_online_collections = {
            c.strip() for c in ec_online.split(",") if c.strip()
        }
        self.ec_online_block = ec_online_block
        self.security = security or SecurityConfig()
        self.service = HTTPService(host, port)
        if self.security.white_list:
            self.service.guard = Guard(self.security.white_list)
        self.service.enable_metrics("master")
        # -telemetry.dir: durable spool — replay the pre-crash tail into
        # the history/event rings, then flush them to disk continuously
        if telemetry_dir:
            store_mod.enable(telemetry_dir, telemetry_retention_mb)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="master")
        self._metrics_collector = None
        self.heat_rollup: heat_mod.HeatRollup | None = None
        self._heat_collector = None
        self.telemetry: agg_mod.TelemetryAggregator | None = None
        self._telemetry_collector = None
        self._telemetry_self_ts = 0.0
        self._stale_nodes: set = set()
        # raft HA: created at start() once the listen port is known (or by
        # enable_raft); None = single-master mode
        self.raft: RaftNode | None = None
        self._peer_config = list(peers or [])
        self._raft_dir = raft_dir
        self._seq_ceiling = 0
        # the raft term the sequencer lease was last synced in: any term
        # change (any possible leadership handoff, even one this node never
        # saw through a request) forces a re-sync against the replicated
        # ceiling before ids are handed out
        self._seq_synced_term = -1
        self._grow_lock = threading.Lock()
        self._stop = threading.Event()
        self._pulse: threading.Thread | None = None
        # the admin shell's exclusive lock
        self._admin_lock: tuple[str, float] | None = None  # (holder, expiry)
        # filers and brokers by address, from /cluster/register
        self._members: dict[str, dict] = {}
        # autonomous maintenance: off by default; `maintenance` starts the
        # detect->plan->heal daemon at boot, `maintenance_dry_run` plans
        # without executing
        self.maintenance = None
        self._maintenance_flag = maintenance
        self._maintenance_dry_run = maintenance_dry_run
        self._maintenance_interval = maintenance_interval
        # defer single-shard ec_rebuild dispatch up to this many seconds
        # so co-stripe losses fold into one multi-target chain pass
        self._repair_lazy_window = float(repair_lazy_window)
        self._maintenance_lock = threading.Lock()
        self._routes()

    # --- lifecycle -------------------------------------------------------------
    MASTER_METRIC_FAMILIES = (
        "SeaweedFS_master_volume_size_bytes",
        "SeaweedFS_master_volume_file_count",
        "SeaweedFS_master_volume_deleted_bytes",
        "SeaweedFS_master_volume_readonly",
        "SeaweedFS_master_volume_size_limit_bytes",
        "SeaweedFS_master_free_slots",
        "SeaweedFS_master_heartbeat_age_seconds",
        "SeaweedFS_master_stale_heartbeats",
        "SeaweedFS_master_ec_shard_count",
        "SeaweedFS_master_volumes_underreplicated",
        "SeaweedFS_master_ec_missing_shards",
    )

    def _metrics_lines(self) -> list[str]:
        lines: list[str] = []
        # disambiguates multiple masters sharing one process registry
        # (raft test clusters) — same role the volume collector's `server`
        # label plays; without it their series would collide. Advertise the
        # public port (the engine front when present, not the loopback
        # backend the Python service binds behind it; the port has none)
        me = f"{self.service.host}:{self.service.port}"

        def sample(family: str, labels: dict, value) -> None:
            labels = {"master": me, **labels}
            # integers render exactly: '{:g}' would clip volume sizes to 6
            # significant digits, skewing cluster.check's capacity math
            v = str(int(value)) if float(value).is_integer() else f"{value:g}"
            lines.append(
                f"{family}"
                f"{_fmt_labels(tuple(labels), tuple(labels.values()))}"
                f" {v}"
            )

        for fam in self.MASTER_METRIC_FAMILIES:
            lines.append(f"# TYPE {fam} gauge")
        sample("SeaweedFS_master_volume_size_limit_bytes", {},
               self.topo.volume_size_limit)
        now = time.time()
        # 3x pulse: late enough that a GIL-starved heartbeat thread does
        # not flap the gauge, early enough to flag well before the 5x-pulse
        # node expiry removes the node (and its gauges) entirely
        stale_after = 3 * max(self.topo.pulse_seconds, 1)
        # flight-recorder edges: staleness is computed right here, so the
        # journal events ride the same scrape that flips the gauge (a
        # racing double-render could at worst duplicate an edge — the
        # journal tolerates that; missing one it would not)
        prev_stale = self._stale_nodes
        # a stale node that EXPIRED out of the topology never rejoined —
        # drop it without an edge, so the set can't leak and a later
        # fresh re-registration can't fabricate a spurious rejoin
        live_ids = {n.id for n in self.topo.all_nodes()}
        prev_stale &= live_ids
        for node in self.topo.all_nodes():
            where = {"dc": node.dc_name(), "rack": node.rack_name(),
                     "node": node.id}
            sample("SeaweedFS_master_free_slots", where, node.free_slots())
            age = max(0.0, now - node.last_seen)
            stale = age > stale_after
            if stale and node.id not in prev_stale:
                prev_stale.add(node.id)
                events_mod.emit("heartbeat_stale", node=node.id,
                                age_s=round(age, 2))
            elif not stale and node.id in prev_stale:
                prev_stale.discard(node.id)
                events_mod.emit("heartbeat_rejoin", node=node.id,
                                age_s=round(age, 2))
            sample("SeaweedFS_master_heartbeat_age_seconds", where, age)
            sample("SeaweedFS_master_stale_heartbeats", where,
                   1 if stale else 0)
            sample("SeaweedFS_master_ec_shard_count", where,
                   sum(len(s.shard_ids()) for s in node.ec_shards.values()))
            for vid, v in sorted(node.volumes.items()):
                vl = {"volume": vid, "collection": v.collection,
                      "node": node.id}
                sample("SeaweedFS_master_volume_size_bytes", vl, v.size)
                sample("SeaweedFS_master_volume_file_count", vl, v.file_count)
                sample("SeaweedFS_master_volume_deleted_bytes", vl,
                       v.deleted_byte_count)
                sample("SeaweedFS_master_volume_readonly", vl,
                       1 if v.read_only else 0)
        for coll, vid, have, want in self.topo.under_replicated_volumes():
            sample("SeaweedFS_master_volumes_underreplicated",
                   {"volume": vid, "collection": coll, "have": have,
                    "want": want}, want - have)
        for vid, missing in sorted(self.topo.ec_missing_shards().items()):
            sample("SeaweedFS_master_ec_missing_shards", {"volume": vid},
                   missing)
        return lines

    def start(self) -> None:
        self.service.start()
        self._metrics_collector = default_registry().register_collector(
            self._metrics_lines, names=self.MASTER_METRIC_FAMILIES,
        )
        # cluster heat rollup: heartbeat-fed per-collection/per-node
        # access rates only the master can assemble
        self.heat_rollup = heat_mod.HeatRollup()
        heat_mod.register_rollup(self.heat_rollup)
        self._heat_collector = default_registry().register_collector(
            self.heat_rollup.lines, names=heat_mod.ROLLUP_FAMILIES,
        )
        # cluster telemetry plane: frames ride heartbeats / register
        # payloads / POST /cluster/telemetry into the leader's aggregator;
        # one GET /debug/cluster/telemetry serves the merged view
        self.telemetry = agg_mod.TelemetryAggregator()
        self._telemetry_collector = default_registry().register_collector(
            self.telemetry.lines, names=agg_mod.CLUSTER_FAMILIES,
        )
        if self._peer_config:
            self.enable_raft(
                [p.rstrip("/") for p in self._peer_config
                 if p.rstrip("/") != self.url]
            )
        self._pulse = threading.Thread(
            target=self._pulse_loop, name="master-pulse", daemon=True
        )
        self._pulse.start()
        if self._maintenance_flag:
            self._ensure_maintenance(dry_run=self._maintenance_dry_run)

    def _ensure_maintenance(self, dry_run: bool | None = False,
                            rebuild_mode: str | None = None,
                            lazy_window: float | None = None):
        """Create (or reconfigure) and start the maintenance daemon — the
        `maintenance` option at boot, or `cluster.maintenance -enable` at
        runtime. dry_run=None preserves the daemon's current mode: a bare
        re-enable must not silently flip a dry-run daemon into mutating
        mode (rebuild_mode=None and lazy_window=None likewise). Locked:
        two racing /maintenance/enable requests must not each start (and
        one leak) a daemon, and an enable racing stop() must not start a
        daemon that outlives the master."""
        with self._maintenance_lock:
            if self._stop.is_set():
                raise RuntimeError("master is stopping")
            if self.maintenance is None:
                from ..maintenance import MaintenanceDaemon

                daemon = MaintenanceDaemon(
                    self, interval=self._maintenance_interval,
                    dry_run=bool(dry_run),
                    rebuild_mode=rebuild_mode or "auto",
                    lazy_window=(
                        self._repair_lazy_window if lazy_window is None
                        else float(lazy_window)
                    ),
                )
                daemon.start()
                self.maintenance = daemon
            else:
                if dry_run is not None:
                    self.maintenance.dry_run = bool(dry_run)
                if rebuild_mode is not None:
                    self.maintenance.rebuild_mode = rebuild_mode
                if lazy_window is not None:
                    self.maintenance.scheduler.lazy_window = \
                        float(lazy_window)
                self.maintenance.enabled = True
            return self.maintenance

    def stop(self) -> None:  # idempotent: fixtures may stop twice
        self._stop.set()
        # under the same lock as _ensure_maintenance: an in-flight enable
        # must either finish first (and be stopped here) or observe _stop
        with self._maintenance_lock:
            if self.maintenance is not None:
                self.maintenance.stop()
                self.maintenance = None
        if self._pulse is not None:
            self._pulse.join()
            self._pulse = None
        if self._metrics_collector is not None:
            default_registry().unregister_collector(self._metrics_collector)
            self._metrics_collector = None
        if self._heat_collector is not None:
            default_registry().unregister_collector(self._heat_collector)
            self._heat_collector = None
            heat_mod.unregister_rollup(self.heat_rollup)
            self.heat_rollup = None
        if self._telemetry_collector is not None:
            default_registry().unregister_collector(self._telemetry_collector)
            self._telemetry_collector = None
            self.telemetry = None
        if self.raft is not None:
            self.raft.stop()
        self.service.stop()

    @property
    def url(self) -> str:
        return self.service.url

    def _pulse_loop(self) -> None:
        while not self._stop.wait(self.topo.pulse_seconds):
            self.topo.expire_dead_nodes()
            self._telemetry_self_feed()
            try:
                self._vacuum_check()
            except Exception:
                pass

    def _ingest_frame(self, frame) -> None:
        """A frame that rode a heartbeat or a registration."""
        tele = self.telemetry
        if frame and tele is not None:
            tele.ingest(frame)

    def _telemetry_self_feed(self) -> None:
        """The master is a telemetry sender too — its own frame (role
        'master') enters the aggregator on the pulse cadence, so the
        cluster view covers the control plane without a network hop.
        Rate-limited: the debug handler also calls this on demand."""
        tele = self.telemetry
        if tele is None:
            return
        now = time.time()
        interval = max(float(self.topo.pulse_seconds), 1.0)
        if now - self._telemetry_self_ts < interval:
            return
        self._telemetry_self_ts = now
        try:
            tele.ingest(agg_mod.build_frame(
                "master", f"{self.service.host}:{self.service.port}",
                interval=interval,
            ), now=now)
        except Exception:
            pass

    # --- vacuum ----------------------------------------------------------------
    def _vacuum_check(self) -> None:
        """Ask volume servers to compact garbage-heavy volumes
        (`topology_vacuum.go:216`)."""
        if not self.vacuum_enabled:
            return
        # the maintenance daemon owns vacuum while it is on (dry-run
        # included: the pulse mutating would break "plans with zero
        # mutations")
        if self.maintenance is not None and self.maintenance.enabled:
            return
        with trace.span("master.vacuum_check", role="master"):
            self._vacuum_round()

    def _vacuum_round(self) -> None:
        for node, vid, _ in self.topo.vacuum_candidates(self.garbage_threshold):
            try:
                post_json(
                    peer_url(node.url) + "/admin/vacuum",
                    {"volume": vid},
                    timeout=120,
                )
            except Exception:
                pass

    # --- raft HA ------------------------------------------------------------------
    def enable_raft(self, peer_urls: list[str]) -> None:
        self.raft = RaftNode(
            self.url, peer_urls, self._raft_apply, state_dir=self._raft_dir,
            snapshot_fn=self._raft_snapshot, restore_fn=self._raft_restore,
        )
        self.topo.vid_allocator = lambda: self.raft.propose(
            {"type": "next_volume_id"}
        )
        self.raft.start()

    def _raft_snapshot(self) -> dict:
        """Applied master state for log compaction."""
        return {
            "max_volume_id": self.topo._max_volume_id,
            "seq_ceiling": self._seq_ceiling,
        }

    def _raft_restore(self, state: dict) -> None:
        self.topo._max_volume_id = max(
            self.topo._max_volume_id, int(state.get("max_volume_id", 0))
        )
        self._seq_ceiling = max(
            self._seq_ceiling, int(state.get("seq_ceiling", 0))
        )

    def _raft_apply(self, command: dict):
        """Replicated master state machine: volume-id counter + file-id
        sequence ceiling (the two pieces the reference raft-persists)."""
        kind = command.get("type")
        if kind == "next_volume_id":
            return self.topo._next_volume_id_raw()
        if kind == "sequence_ceiling":
            self._seq_ceiling = max(self._seq_ceiling, int(command["value"]))
            return self._seq_ceiling
        return None

    def _is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader()

    def leader_url(self) -> str:
        if self.raft is None or self.raft.is_leader():
            return self.url
        return self.raft.leader() or self.url

    def _not_leader_response(self) -> Response:
        return Response(
            {"error": "raft.not.leader", "leader": self.leader_url()}, 409
        )

    def _ensure_sequence_lease(self, count: int) -> None:
        """Leader-side sequence lease (`sequence raft SetMax`): ids are only
        handed out below the committed ceiling; whenever the raft term moved
        since the last sync, the counter is fast-forwarded to the replicated
        ceiling first so ids never repeat across failover."""
        if self.raft is None:
            return
        seq = self.topo.sequencer
        term = self.raft.term()
        if self._seq_synced_term != term:
            # a no-op barrier first: committing it applies every ceiling
            # entry of earlier terms on this node, so the set_max below sees
            # grants the old leader made that were still unapplied here
            self.raft.propose({"type": "sequence_ceiling", "value": 0})
            seq.set_max(self._seq_ceiling)
            self._seq_synced_term = term
        while seq.peek() + count >= self._seq_ceiling:
            self.raft.propose({
                "type": "sequence_ceiling",
                "value": seq.peek() + count + 10000,
            })

    # --- growth ----------------------------------------------------------------
    def _is_ec_online(self, collection: str) -> bool:
        return (
            "*" in self.ec_online_collections
            or collection in self.ec_online_collections
        )

    def _grow_volumes(
        self, collection: str, rp: ReplicaPlacement, ttl_u32: int, dc: str
    ) -> None:
        """Pick servers then instruct them to allocate (`volume_growth.go:243`)."""
        with self._grow_lock, trace.span(
            "master.grow", role="master", collection=collection,
        ):
            lo = self.topo.layout(collection, rp, ttl_u32)
            if lo.active_volume_count(dc) > 0:
                return  # another request already grew (in this DC if pinned)
            ec_online = self._is_ec_online(collection)
            # parity-only durability wants ONE holder while the volume
            # streams, so slot-finding places a single copy; the volume's
            # superblock still records the REQUESTED placement
            rp_slots = ReplicaPlacement.parse("000") if ec_online else rp
            grown = self.topo.grow(collection, rp_slots, ttl_u32, dc)
            ttl_s = str(TTL.from_u32(ttl_u32))
            for vid, nodes in grown:
                ok_nodes = []
                for node in nodes:
                    try:
                        body = {
                            "volume": vid,
                            "collection": collection,
                            "replication": str(rp),
                            "ttl": ttl_s,
                        }
                        if ec_online:
                            body["ecOnline"] = True
                            if self.ec_online_block:
                                body["ecOnlineBlock"] = self.ec_online_block
                        post_json(
                            peer_url(node.url) + "/admin/allocate_volume",
                            body,
                            timeout=10,
                        )
                        ok_nodes.append(node)
                    except Exception:
                        continue
                # registration happens via the servers' next heartbeat; to make
                # assign usable immediately, register optimistically
                want_nodes = 1 if ec_online else rp.copy_count()
                if len(ok_nodes) == want_nodes:
                    for node in ok_nodes:
                        info = VolumeInfo(
                            id=vid,
                            collection=collection,
                            replica_placement=rp.to_byte(),
                            ttl=ttl_u32,
                            ec_online=ec_online,
                        )
                        node.volumes[vid] = info
                        self.topo._register_volume(info, node)

    # --- routes ----------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service

        @svc.route("POST", r"/heartbeat")
        def heartbeat(req: Request) -> Response:
            # periodic chatter: recorded only when the volume server's
            # (sampled) heartbeat span linked us into its trace
            trace.annotate(noise=True)
            if not self._is_leader():
                # volume servers re-target to the leader (KeepConnected
                # redirect semantics, `master_grpc_server.go`)
                return self._not_leader_response()
            hb = req.json()
            self.topo.sync_heartbeat(hb)
            rollup = self.heat_rollup
            if rollup is not None:
                rollup.feed(
                    f"{hb.get('ip', '')}:{hb.get('port', '')}",
                    hb.get("volumes") or (),
                )
            self._ingest_frame(hb.get("telemetry"))
            return Response(
                {
                    "volume_size_limit": self.topo.volume_size_limit,
                    "leader": self.leader_url(),
                }
            )

        # --- raft plane (`weed/server/raft_server.go` transport) ---
        @svc.route("POST", r"/raft/request_vote")
        def raft_request_vote(req: Request) -> Response:
            if self.raft is None:
                return Response({"error": "raft disabled"}, 503)
            return Response(self.raft.handle_request_vote(req.json()))

        @svc.route("POST", r"/raft/append_entries")
        def raft_append_entries(req: Request) -> Response:
            if self.raft is None:
                return Response({"error": "raft disabled"}, 503)
            return Response(self.raft.handle_append_entries(req.json()))

        @svc.route("POST", r"/raft/install_snapshot")
        def raft_install_snapshot(req: Request) -> Response:
            if self.raft is None:
                return Response({"error": "raft disabled"}, 503)
            return Response(self.raft.handle_install_snapshot(req.json()))

        @svc.route("GET", r"/raft/status")
        def raft_status(req: Request) -> Response:
            if self.raft is None:
                return Response({"enabled": False, "leader": self.url})
            out = self.raft.status()
            out["enabled"] = True
            return Response(out)

        def raft_member(req: Request, change: str) -> Response:
            # `cluster.raft.add/remove` (command_cluster_raft_add.go): a
            # replicated membership change; leader-only like every admin
            # mutation
            if self.raft is None:
                return Response({"error": "raft not enabled"}, 400)
            if not self._is_leader():
                return self._not_leader_response()
            peer = (req.json().get("peer") or "").rstrip("/")
            if not peer:
                return Response({"error": "missing peer url"}, 400)
            return Response(getattr(self.raft, change)(peer))

        @svc.route("POST", r"/raft/add")
        def raft_add(req: Request) -> Response:
            return raft_member(req, "add_peer")

        @svc.route("POST", r"/raft/remove")
        def raft_remove(req: Request) -> Response:
            return raft_member(req, "remove_peer")

        def do_assign(req: Request) -> Response:
            _FP_ASSIGN.hit()  # injected error -> 500 via _dispatch; the
            # writer's retry/fresh-assignment path is what's under test
            if not self._is_leader():
                return self._not_leader_response()
            count = int(req.query.get("count", 1))
            replication = req.query.get("replication") or self.default_replication
            collection = req.query.get("collection", "")
            ttl = req.query.get("ttl", "")
            dc = req.query.get("dataCenter", "")
            # ?shard=i:n — gateway lease-pool vid-space sharding: prefer
            # vids where vid % n == i (soft: falls back to the whole
            # space when the slice has no writables)
            shard = None
            shard_s = req.query.get("shard", "")
            if shard_s:
                try:
                    i_s, _, n_s = shard_s.partition(":")
                    shard = (int(i_s), int(n_s))
                    if shard[1] < 1 or not 0 <= shard[0] < shard[1]:
                        raise ValueError(shard_s)
                except ValueError:
                    return Response(
                        {"error": f"bad shard {shard_s!r} (want i:n)"}, 400)
            rp = ReplicaPlacement.parse(replication)
            ttl_u32 = TTL.parse(ttl).to_u32()
            lo = self.topo.layout(collection, rp, ttl_u32)
            if lo.active_volume_count(dc) == 0:
                try:
                    self._grow_volumes(collection, rp, ttl_u32, dc)
                except NotLeader:
                    return self._not_leader_response()
                except Exception as e:
                    return Response({"error": f"cannot grow volumes: {e}"}, 500)
            try:
                self._ensure_sequence_lease(count)
                fid, cnt, nodes = self.topo.pick_for_write(
                    count, replication, ttl, collection, dc, shard=shard
                )
            except NotLeader:
                return self._not_leader_response()
            except NoWritableVolume:
                # raced with a full/readonly transition: grow then retry once
                try:
                    self._grow_volumes(collection, rp, ttl_u32, dc)
                    fid, cnt, nodes = self.topo.pick_for_write(
                        count, replication, ttl, collection, dc, shard=shard
                    )
                except NotLeader:
                    return self._not_leader_response()
                except Exception as e:
                    return Response({"error": str(e)}, 404)
            main = nodes[0]
            out = {
                "fid": fid,
                "url": main.id,
                "publicUrl": main.url,
                "count": cnt,
                "replicas": [
                    {"url": n.id, "publicUrl": n.url} for n in nodes[1:]
                ],
            }
            if self.security.write_key:
                # per-fileId write token the volume server will demand
                # (`weed/security/jwt.go GenJwtForVolumeServer`)
                out["auth"] = gen_write_jwt(
                    self.security.write_key, fid, self.security.write_expires_sec
                )
            return Response(out)

        svc.route("GET", r"/dir/assign")(do_assign)
        svc.route("POST", r"/dir/assign")(do_assign)

        def do_lookup(req: Request) -> Response:
            _FP_LOOKUP.hit()
            if not self._is_leader():
                # followers have empty topologies (heartbeats are
                # leader-only): redirect instead of a misleading 404
                return self._not_leader_response()
            vid_s = req.query.get("volumeId", "")
            if "," in vid_s:
                vid_s = vid_s.split(",")[0]
            try:
                vid = int(vid_s)
            except ValueError:
                return Response({"error": f"unknown volumeId {vid_s}"}, 400)
            nodes = self.topo.lookup(vid, req.query.get("collection", ""))
            if not nodes:
                return Response(
                    {"volumeOrFileId": vid_s, "error": "volume id not found"}, 404
                )
            return Response(
                {
                    "volumeOrFileId": vid_s,
                    "locations": [
                        {"url": n.id, "publicUrl": n.url} for n in nodes
                    ],
                }
            )

        svc.route("GET", r"/dir/lookup")(do_lookup)
        svc.route("POST", r"/dir/lookup")(do_lookup)

        @svc.route("GET", r"/dir/ec_lookup")
        def ec_lookup(req: Request) -> Response:
            vid = int(req.query.get("volumeId", 0))
            shard_map = self.topo.lookup_ec_shards(vid)
            if shard_map is None:
                return Response({"error": "ec volume not found"}, 404)
            return Response(
                {
                    "volumeId": vid,
                    "shards": {
                        str(sid): [n.url for n in nodes]
                        for sid, nodes in shard_map.items()
                    },
                }
            )

        @svc.route("GET", r"/ui")
        def ui(req: Request) -> Response:
            # minimal HTML status page (`weed/server/master_ui/`)
            rows = []
            for node in self.topo.all_nodes():
                rows.append(
                    f"<tr><td>{node.id}</td><td>{node.dc_name()}</td>"
                    f"<td>{node.rack_name()}</td>"
                    f"<td>{len(node.volumes)}</td></tr>"
                )
            html = (
                "<html><head><title>seaweedfs-tpu master</title></head><body>"
                f"<h1>Master {self.url}</h1>"
                f"<p>leader: {self.leader_url()} | max volume id: "
                f"{self.topo._max_volume_id}</p>"
                "<table border=1><tr><th>volume server</th><th>DC</th>"
                "<th>rack</th><th>volumes</th></tr>"
                + "".join(rows) + "</table>"
                "<p><a href='/dir/status'>topology json</a> | "
                "<a href='/cluster/ps'>cluster ps</a> | "
                "<a href='/metrics'>metrics</a></p>"
                "</body></html>"
            ).encode()
            return Response(html, content_type="text/html")

        @svc.route("GET", r"/dir/status")
        def dir_status(req: Request) -> Response:
            return Response(
                {"Topology": self.topo.to_dict(), "Version": "seaweedfs-tpu-torch"}
            )

        @svc.route("GET", r"/cluster/status")
        def cluster_status(req: Request) -> Response:
            return Response(
                {"IsLeader": self._is_leader(), "Leader": self.leader_url(),
                 "MaxVolumeId": self.topo._max_volume_id}
            )

        @svc.route("POST", r"/cluster/register")
        def cluster_register(req: Request) -> Response:
            """Filers/brokers announce themselves (the reference rides this on
            the KeepConnected stream, `weed/cluster/cluster.go`)."""
            trace.annotate(noise=True)  # periodic re-registration chatter
            p = req.json()
            prev = self._members.get(p["address"])
            self._members[p["address"]] = {
                "type": p.get("type", "filer"),
                "address": p["address"],
                "last_seen": time.time(),
                # first-seen decides group leadership (`cluster.go` — the
                # longest-lived member leads its group)
                "created_ts": prev["created_ts"] if prev else time.time(),
            }
            self._ingest_frame(p.get("telemetry"))
            # answer with the member's position among its live peer group
            # (ordered by first-seen, like group leadership)
            now = time.time()
            ptype = p.get("type", "filer")
            peers = sorted(
                (m for m in self._members.values()
                 if m["type"] == ptype and now - m["last_seen"] < 30),
                key=lambda m: (m["created_ts"], m["address"]),
            )
            addrs = [m["address"] for m in peers]
            out = {"ok": True, "leader": self.url, "gateways": len(addrs)}
            if p["address"] in addrs:
                out["ordinal"] = addrs.index(p["address"])
            return Response(out)

        @svc.route("POST", r"/cluster/telemetry")
        def cluster_telemetry_push(req: Request) -> Response:
            """Telemetry frames from roles with no other master link (S3,
            WebDAV, tests). Leader-only like the heartbeat — the response
            names the leader so pushers re-target."""
            trace.annotate(noise=True)  # periodic push chatter
            if not self._is_leader():
                return self._not_leader_response()
            tele = self.telemetry
            if tele is None:
                return Response({"error": "telemetry not started"}, 503)
            if not tele.ingest(req.json()):
                return Response(
                    {"error": "malformed or replayed frame",
                     "leader": self.leader_url()}, 400)
            return Response({"ok": True, "leader": self.leader_url()})

        @svc.route("GET", r"/debug/cluster/telemetry")
        def cluster_telemetry_get(req: Request) -> Response:
            """The one-fetch cluster state: merged tenants + error bound,
            per-role rates, cluster SLO burn, per-sender staleness."""
            tele = self.telemetry
            if tele is None:
                return Response({"error": "telemetry not started"}, 503)
            self._telemetry_self_feed()
            n = req.query.get("n")
            try:
                n = int(n) if n else None
            except ValueError:
                return Response({"error": "bad n"}, 400)
            out = tele.snapshot(n=n)
            out["leader"] = self.leader_url()
            out["proc"] = prof_mod.PROCESS_TOKEN
            return Response(out)

        @svc.route("GET", r"/cluster/leader")
        def cluster_leader(req: Request) -> Response:
            kind = req.query.get("type", "filer")
            now = time.time()
            live = [
                m for m in self._members.values()
                if m["type"] == kind
                and now - m["last_seen"] < 3 * max(self.topo.pulse_seconds, 5)
            ]
            if not live:
                return Response({"error": f"no live {kind} members"}, 404)
            leader = min(live, key=lambda m: (m["created_ts"], m["address"]))
            return Response({"leader": leader["address"], "type": kind})

        @svc.route("GET", r"/cluster/ps")
        def cluster_ps(req: Request) -> Response:
            now = time.time()
            members = [
                m for m in self._members.values()
                if now - m["last_seen"] < 3 * max(self.topo.pulse_seconds, 5)
            ]
            return Response(
                {
                    "masters": [{"address": self.url, "isLeader": True}],
                    "volumeServers": [
                        {"address": n.url, "dataCenter": n.dc_name(),
                         "rack": n.rack_name()}
                        for n in self.topo.all_nodes()
                    ],
                    "filers": [m for m in members if m["type"] == "filer"],
                    "brokers": [m for m in members if m["type"] == "broker"],
                }
            )

        @svc.route("POST", r"/cluster/lock")
        def cluster_lock(req: Request) -> Response:
            """Exclusive admin-shell lease (`weed/shell` lock/unlock via master
            lease). Re-entrant for the same holder; expires after ttl."""
            p = req.json()
            holder = p.get("holder", "shell")
            ttl = float(p.get("ttl", 30))
            now = time.time()
            if self._admin_lock and self._admin_lock[1] > now and \
                    self._admin_lock[0] != holder:
                return Response(
                    {"error": f"locked by {self._admin_lock[0]}"}, 409
                )
            self._admin_lock = (holder, now + ttl)
            return Response({"ok": True, "holder": holder, "ttl": ttl})

        @svc.route("POST", r"/cluster/unlock")
        def cluster_unlock(req: Request) -> Response:
            holder = req.json().get("holder", "shell")
            if self._admin_lock and self._admin_lock[0] != holder:
                return Response(
                    {"error": f"locked by {self._admin_lock[0]}"}, 409
                )
            self._admin_lock = None
            return Response({"ok": True})

        @svc.route("GET", r"/col/list")
        def col_list(req: Request) -> Response:
            cols: dict[str, int] = {}
            for node in self.topo.all_nodes():
                for v in node.volumes.values():
                    cols[v.collection] = cols.get(v.collection, 0) + 1
            return Response(
                {"collections": [
                    {"name": k, "volumeCount": c} for k, c in sorted(cols.items())
                ]}
            )

        @svc.route("POST", r"/col/delete")
        def col_delete(req: Request) -> Response:
            """Drop every volume of a collection on every server
            (`master_server_handlers_admin.go collectionDeleteHandler`)."""
            name = req.query.get("collection", "")
            if not name:
                try:
                    name = req.json().get("collection", "")
                except ValueError:
                    pass
            if not name:
                # an empty name would match every default-collection volume —
                # refuse, like the reference's 'collection not found'
                return Response({"error": "collection name required"}, 400)
            deleted = 0
            for node in self.topo.all_nodes():
                for vid, v in list(node.volumes.items()):
                    if v.collection == name:
                        try:
                            post_json(
                                peer_url(node.url) + "/admin/delete_volume",
                                {"volume": vid}, timeout=30,
                            )
                            deleted += 1
                        except Exception:
                            pass
            return Response({"ok": True, "deleted": deleted})

        @svc.route("GET", r"/vol/status")
        def vol_status(req: Request) -> Response:
            out = {}
            for node in self.topo.all_nodes():
                out[node.id] = {
                    str(vid): {
                        "size": v.size,
                        "file_count": v.file_count,
                        "delete_count": v.delete_count,
                        "garbage": v.deleted_byte_count,
                    }
                    for vid, v in node.volumes.items()
                }
            return Response({"Volumes": out})

        # --- autonomous maintenance plane (maintenance/daemon.py) ---
        @svc.route("GET", r"/debug/maintenance")
        def debug_maintenance(req: Request) -> Response:
            if self.maintenance is None:
                return Response({"configured": False, "enabled": False})
            out = self.maintenance.status()
            out["configured"] = True
            return Response(out)

        @svc.route("POST", r"/maintenance/enable")
        def maintenance_enable(req: Request) -> Response:
            try:
                p = req.json()
            except ValueError:
                p = {}
            # an absent dryRun key preserves the running daemon's mode —
            # only an explicit true/false flips it (a bare re-enable must
            # not silently turn a plan-only daemon into a mutating one)
            dry = p.get("dryRun")
            mode = p.get("rebuildMode")
            if mode is not None and mode not in ("auto", "classic",
                                                 "pipelined"):
                return Response(
                    {"error": f"rebuildMode {mode!r} not"
                     f" auto|classic|pipelined"}, 400)
            lazy = p.get("lazyWindow")
            if lazy is not None:
                try:
                    lazy = float(lazy)
                except (TypeError, ValueError):
                    return Response(
                        {"error": f"lazyWindow {lazy!r} not a number"},
                        400)
                if not (0.0 <= lazy < 3600.0) or lazy != lazy:
                    return Response(
                        {"error": f"lazyWindow {lazy} not in [0, 3600)"},
                        400)
            d = self._ensure_maintenance(
                dry_run=None if dry is None else bool(dry),
                rebuild_mode=mode, lazy_window=lazy,
            )
            return Response({
                "ok": True, "enabled": True, "dry_run": d.dry_run,
                "interval": d.interval, "rebuild_mode": d.rebuild_mode,
                "lazy_window": d.scheduler.lazy_window,
            })

        @svc.route("POST", r"/maintenance/disable")
        def maintenance_disable(req: Request) -> Response:
            if self.maintenance is not None:
                self.maintenance.enabled = False
            return Response({"ok": True, "enabled": False})

        @svc.route("POST", r"/maintenance/scan")
        def maintenance_scan(req: Request) -> Response:
            """Force a scan now (`cluster.maintenance -now [task]`)."""
            if self.maintenance is None:
                return Response({"error": "maintenance not configured"}, 400)
            try:
                p = req.json()
            except ValueError:
                p = {}
            task = p.get("task")
            if task is not None:
                from ..maintenance import TASK_TYPES

                if task not in TASK_TYPES:
                    return Response(
                        {"error": f"unknown task type {task!r}"
                         f" (known: {sorted(TASK_TYPES)})"}, 400)
            offered = self.maintenance.scan_now(
                None if task is None else (task,)
            )
            return Response({"ok": True, "offered": offered})

        @svc.route("POST", r"/vol/vacuum/disable")
        def vacuum_disable(req: Request) -> Response:
            self.vacuum_enabled = False
            return Response({"ok": True, "vacuum": "disabled"})

        @svc.route("POST", r"/vol/vacuum/enable")
        def vacuum_enable(req: Request) -> Response:
            self.vacuum_enabled = True
            return Response({"ok": True, "vacuum": "enabled"})

        @svc.route("GET", r"/vol/vacuum")
        def vol_vacuum(req: Request) -> Response:
            threshold = float(req.query.get("garbageThreshold", self.garbage_threshold))
            old = self.garbage_threshold
            self.garbage_threshold = threshold
            try:
                self._vacuum_check()
            finally:
                self.garbage_threshold = old
            return Response({"ok": True})
