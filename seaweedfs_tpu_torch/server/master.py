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
/cluster/lock`, `/cluster/unlock`, `GET /col/list`, `POST /col/delete`,
`GET /vol/vacuum` and `POST /vol/vacuum/{enable,disable}`.

The master is host code and holds no device. One master is the leader:
there is no raft, so the sequence lease is not needed.

Not ported: raft HA and the `/raft/*` routes, the native fastlane front
door, JWT (`security`), the maintenance daemon (so only the
`vacuum_enabled` gate decides the pulse's vacuum), telemetry, metrics,
heat, `/ui`, `/cluster/register` and `/cluster/telemetry`.
"""

from __future__ import annotations

import threading
import time

from ..storage.types import TTL, ReplicaPlacement
from ..topology import Topology
from ..topology.node import VolumeInfo
from ..topology.sequence import MemorySequencer
from ..topology.volume_layout import NoWritableVolume
from .httpd import HTTPService, Request, Response, peer_url, post_json


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
    ) -> None:
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
        self.service = HTTPService(host, port)
        self._grow_lock = threading.Lock()
        self._stop = threading.Event()
        self._pulse: threading.Thread | None = None
        # the admin shell's exclusive lock
        self._admin_lock: tuple[str, float] | None = None  # (holder, expiry)
        self._routes()

    # --- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        self.service.start()
        self._pulse = threading.Thread(
            target=self._pulse_loop, name="master-pulse", daemon=True
        )
        self._pulse.start()

    def stop(self) -> None:  # idempotent: fixtures may stop twice
        self._stop.set()
        if self._pulse is not None:
            self._pulse.join()
            self._pulse = None
        self.service.stop()

    @property
    def url(self) -> str:
        return self.service.url

    def _pulse_loop(self) -> None:
        while not self._stop.wait(self.topo.pulse_seconds):
            self.topo.expire_dead_nodes()
            try:
                self._vacuum_check()
            except Exception:
                pass

    # --- vacuum ----------------------------------------------------------------
    def _vacuum_check(self) -> None:
        """Ask volume servers to compact garbage-heavy volumes
        (`topology_vacuum.go:216`)."""
        if not self.vacuum_enabled:
            return
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

    def _is_leader(self) -> bool:
        return True  # one master, no raft

    def leader_url(self) -> str:
        return self.url

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
        with self._grow_lock:
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
            self.topo.sync_heartbeat(req.json())
            return Response(
                {
                    "volume_size_limit": self.topo.volume_size_limit,
                    "leader": self.leader_url(),
                }
            )

        def do_assign(req: Request) -> Response:
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
                except Exception as e:
                    return Response({"error": f"cannot grow volumes: {e}"}, 500)
            try:
                fid, cnt, nodes = self.topo.pick_for_write(
                    count, replication, ttl, collection, dc, shard=shard
                )
            except NoWritableVolume:
                # raced with a full/readonly transition: grow then retry once
                try:
                    self._grow_volumes(collection, rp, ttl_u32, dc)
                    fid, cnt, nodes = self.topo.pick_for_write(
                        count, replication, ttl, collection, dc, shard=shard
                    )
                except Exception as e:
                    return Response({"error": str(e)}, 404)
            main = nodes[0]
            return Response(
                {
                    "fid": fid,
                    "url": main.id,
                    "publicUrl": main.url,
                    "count": cnt,
                    "replicas": [
                        {"url": n.id, "publicUrl": n.url} for n in nodes[1:]
                    ],
                }
            )

        svc.route("GET", r"/dir/assign")(do_assign)
        svc.route("POST", r"/dir/assign")(do_assign)

        def do_lookup(req: Request) -> Response:
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

        @svc.route("GET", r"/cluster/ps")
        def cluster_ps(req: Request) -> Response:
            # filers and brokers announce themselves through
            # /cluster/register, which is not ported: none is listed
            return Response(
                {
                    "masters": [{"address": self.url, "isLeader": True}],
                    "volumeServers": [
                        {"address": n.url, "dataCenter": n.dc_name(),
                         "rack": n.rack_name()}
                        for n in self.topo.all_nodes()
                    ],
                    "filers": [],
                    "brokers": [],
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
