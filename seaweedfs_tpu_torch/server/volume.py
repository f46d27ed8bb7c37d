"""Volume server: HTTP data plane, admin plane, integrity scrub plane and
heartbeat loop — the port's copy of `seaweedfs_tpu/server/volume.py`.

Reference: `weed/server/volume_server_handlers_read.go:45` /
`_write.go:18` (GET/POST/DELETE /<vid>,<fid>), `store_replicate.go:26`
(synchronous replica fan-out), `volume_grpc_erasure_coding.go` (EC verbs —
JSON admin endpoints here), `volume_grpc_client_to_master.go:50`
(heartbeat).

Routes: the needle routes (GET/HEAD/POST/PUT/DELETE on `FID_RE`; a write
or delete to a volume whose placement asks for replicas fans out to the
other holders the master's `/dir/lookup` names, all or nothing, before it
is acknowledged), `/status`, `/admin/allocate_volume` (with `ecOnline` and
`ecOnlineBlock`), `/admin/delete_volume`, `/admin/vacuum`,
`/admin/volume/{readonly,configure_replication,files,raw,copy,mount,
unmount,needle_blob,write_needle_blob,needles}`, `/admin/fsck`,
`/admin/leave`, the scrub plane `/admin/scrub/{status,run,resolve,needle,
repair_needle,sync}` over a `VolumeScrubber` on the server's device, and
the EC verbs `/admin/ec/{generate,mount,unmount,rebuild,online/rebuild,
delete_volume,to_volume,shard,copy,delete_shards}` that the shell's
`ec.*` commands drive. Every mounted EC volume gets a remote shard
fetcher: the master's `/dir/ec_lookup` (cached 10 s), then
`/admin/ec/shard` range reads off the other holders, so a read of a
shard this server lacks goes remote before it reconstructs; and a partial
fetcher, which reconstructs a lost interval from one GF-scaled partial
per remote holder (`/admin/ec/partial` with bare `coefs`) plus this
server's own share. Writes and deletes on an online-EC volume pump its
stripe writer, and a pulse loop pumps every `pulse_seconds` so the timed
trickle flush fires between writes, sweeps idle streaming sessions, and
posts the heartbeat when a `master_url` is given (with none, nothing is
posted).

The pipelined partial-sum rebuild plane: `/admin/ec/partial/{start,
commit,abort}` hold a rebuild's tmp shard files on the chain's writer,
`/admin/ec/partial` runs one hop of a nested chain pass (or serves a bare
ranged partial), and `/admin/ec/partial/stream/{open,chunk,close}` run
the hop-parallel session mode, each hop's forwarder thread shipping
chunk k downstream while its handler scales chunk k+1. Every hop scales
its own shards on the mounted `EcVolume`'s codec; a codec failure is a
500 `codec_failed`, never a transport error.

The server has one device, `cuda` unless the caller passes `device="cpu"`
(with neither nor CUDA, construction raises): the online writers'
parity, degraded reads, every hop's partial sum, `/admin/ec/rebuild` and
the scrubber's bulk CRCs and parity checks run there. `scrub_interval`
(`-scrub.interval`, 0 = no loop) and `scrub_rate_mb` (`-scrub.rateMB`, 0 =
unthrottled) pace the scrubber; a kernel or codec failure in a pass is a
500 `codec_failed` from `/admin/scrub/run` and is kept on
`/admin/scrub/status`.

JPEG uploads are rewritten upright when their EXIF orientation is not
1, and `GET ?width=&height=&mode=` resizes images (`images/`, Pillow on
the host).

Tiering: `/admin/backend/configure` registers an object backend
(`storage/backend.py`), `/admin/volume/tier_upload` moves a readonly
volume's .dat into it (reads then proxy through the backend),
`/admin/volume/tier_download` brings it back and
`/admin/volume/tier_info` shows the `.vif`'s remote record.
`/admin/tail?volume=&since_ns=` serves the .dat bytes of the needles
appended after `since_ns` (the incremental `backup`), and `POST /query`
filters one needle's JSON or CSV content (`query/`). The heartbeat passes
the `volume.heartbeat.send` fault point (an injected error or partition
drops the beat); `faults_spec` is the `-faults` flag
(`util/faults.opt_in`).

Security (`security/`, `volume_server_handlers.go:33-75`): with
`security.write_key` set, POST, PUT and DELETE of a needle answer 401
unless the request carries a token (`Authorization: BEARER`, else `?jwt=`)
signed with that key whose fid claim is the request's fid (its `_N` and
`.ext` stripped) or empty (a wildcard); with `security.read_key` set, GET,
HEAD and `/query` demand a read token the same way. A replicated write or
delete passes the client's `Authorization` on to the other holders, which
verify the same token. `security.white_list` puts a `Guard` on the
service.

Observability (`stats/`): the service is metered as role "volume"
(`slow_ms` is its `-slowMs` span threshold); a scrape-time collector
exports each data directory's used and free bytes under the server's
`server` label; every twelfth heartbeat (the first included) is a
`volume.heartbeat` span, so the master's handler joins its trace; the
partial-rebuild routes annotate their spans with the hop; `/ui` is the
status page. `telemetry_dir` (`-telemetry.dir`) turns on the process's
durable spool (`stats/store.py`), and a telemetry frame
(`stats/aggregate.build_frame`) rides the heartbeat at most once a pulse.

Not ported: the native fastlane (and with it the fastlane metric
families and the per-volume op counters of the beat, which feed the
master's heat rollup) and the retry policy of the copy stream (a failed
range fails the copy).
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
import urllib.parse

import numpy as np

from ..maintenance.scrub import ScrubCodecFailed, VolumeScrubber
from ..ops.rs_kernel import RSCodec, resolve_device
from ..query import query_csv, query_json_lines
from ..security import Guard, SecurityConfig
from ..security.jwt import token_from_request, verify_file_jwt
from ..stats import aggregate as agg_mod
from ..stats import default_registry
from ..stats import store as store_mod
from ..stats import trace
from ..stats.metrics import _fmt_labels
from ..storage import crc as crc_mod
from ..storage.backend import BackendError, configure_backend
from ..storage.erasure_coding import decoder as ec_decoder
from ..storage.erasure_coding import encoder as ec_encoder
from ..storage.erasure_coding import geometry
from ..storage.erasure_coding.ec_volume import (
    PartialCodecFailed,
    PartialDeclined,
    ec_shard_file_name,
)
from ..storage.file_id import parse_key_hash_with_delta
from ..storage.needle import Needle
from ..storage.store import Store, _attach_online_ec
from ..storage.super_block import SUPER_BLOCK_SIZE
from ..storage.types import TTL, ReplicaPlacement
from ..storage.volume import NotFound, VolumeError, volume_file_name
from ..util import faults
from ..util.compression import decompress_data
from ..util.retry import READ_POLICY
from .httpd import HTTPService, Request, Response, get_json, http_request, peer_url

FID_RE = r"/(\d+),([0-9a-fA-F_]+)(?:\.[^/]*)?"
_SAFE_EXT_RE = re.compile(r"\.(dat|idx|vif|ecx|ecj|ec\d\d)")

_FP_HEARTBEAT = faults.register("volume.heartbeat.send")
# the fan-out seam fails replica pushes (the client's write is not acked
# and it retries with a fresh assignment); scoped by the server's identity
_FP_REPLICATE = faults.register("volume.replicate.fanout")
# pipelined-rebuild hop seam: an `error` here kills one node's partial-sum
# stage mid-chain — the orchestrator's retry ladder must restart the chain
# minus this hop or fall back to classic whole-shard pulls
_FP_PARTIAL = faults.register("repair.partial_fetch")

# streaming rebuild sessions: bounded in-flight window per hop (chunks
# parked on the forward queue) and the stall budget after which a hop
# declares its downstream wedged (the orchestrator's ladder restarts)
STREAM_WINDOW = 4
STREAM_STALL_TIMEOUT = 30.0
STREAM_SESSION_MAX_AGE = 600.0


class _PartialError(Exception):
    """A partial-sum hop step failed; `payload` is the attribution dict
    the orchestrator's retry ladder reads (error, failed_hop_server)."""

    def __init__(self, payload: dict, status: int) -> None:
        super().__init__(payload.get("error", "partial step failed"))
        self.payload = payload
        self.status = status


def _error_of(body: bytes) -> dict:
    try:
        out = json.loads(body) if body else {}
    except ValueError:
        return {}
    return out if isinstance(out, dict) else {}


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        master_url: str = "",
        host: str = "127.0.0.1",
        port: int = 0,
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        pulse_seconds: float = 5,
        max_volume_count: int = 100,
        scrub_interval: float = 0.0,
        scrub_rate_mb: float = 8.0,
        device=None,
        faults_spec: str | None = None,
        security: SecurityConfig | None = None,
        slow_ms: float | None = None,
        telemetry_dir: str | None = None,
        telemetry_retention_mb: float | None = None,
    ) -> None:
        self.device = resolve_device(device)
        faults.opt_in(faults_spec)  # the -faults flag
        self.security = security or SecurityConfig()
        # -mserver may list several masters; heartbeats follow the raft
        # leader hint (`volume_grpc_client_to_master.go` re-dial on redirect)
        self.master_urls = [
            peer_url(u).rstrip("/") for u in master_url.split(",") if u
        ]
        self.master_url = self.master_urls[0] if self.master_urls else ""
        self.service = HTTPService(host, port)
        if self.security.white_list:
            self.service.guard = Guard(self.security.white_list)
        self.service.enable_metrics("volume")
        # -telemetry.dir: durable spool — pre-crash history/events replay
        # into the rings before traffic starts, so /debug/metrics/history
        # and /debug/events survive a kill -9
        if telemetry_dir:
            store_mod.enable(telemetry_dir, telemetry_retention_mb)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="volume")
        self._metrics_collector = None
        self._hb_count = 0
        self._telemetry_ts = 0.0
        self.store: Store | None = None
        self._dirs = directories
        self._host = host
        self._public_url = public_url
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.max_volume_count = max_volume_count
        self.volume_size_limit = 30 * 1024 * 1024 * 1024
        self._stop = threading.Event()
        self._pulse: threading.Thread | None = None
        # one heartbeat at a time, collected and posted together: a
        # handler's beat after a change is never overtaken by the pulse's
        # beat collected before it
        self._hb_lock = threading.Lock()
        # in-flight pipelined rebuilds: vid -> {writers, targets, ...}.
        # The orchestrator drives start -> partial chunks -> commit; a
        # replaced/aborted state discards its tmp files (never a
        # half-written file under a valid shard name).
        self._partial_rebuilds: dict[int, dict] = {}
        self._partial_lock = threading.Lock()
        # streaming rebuild sessions: session id -> per-hop state. Each hop
        # ACKs a chunk after scaling its local shards and parking the XOR'd
        # sum on a bounded forward queue; a forwarder thread ships it
        # downstream while the hop computes the next one, so an H-hop,
        # N-chunk rebuild costs ~(H + N) chunk-times instead of H x N.
        self._partial_streams: dict[str, dict] = {}
        self._stream_lock = threading.Lock()
        # background integrity scrubber (maintenance/scrub.py), built at
        # start on this server's device: -scrub.interval 0 disables the
        # loop; /admin/scrub/run still works
        self.scrubber: VolumeScrubber | None = None
        self.scrub_interval = float(scrub_interval)
        self.scrub_rate_mb = float(scrub_rate_mb)
        self._scrub_thread: threading.Thread | None = None
        self._leaving = False  # volume.server.leave: up, but no heartbeats
        self._routes()

    def start(self) -> None:
        self.service.start()
        self.store = Store(
            self._dirs,
            ip=self._host,
            port=self.service.port,
            public_url=self._public_url,
            device=self.device,
        )
        for loc in self.store.locations:
            loc.max_volume_count = self.max_volume_count
            for ev in loc.ec_volumes.values():
                self._attach_shard_fetcher(ev)
        self._metrics_collector = default_registry().register_collector(
            self._metrics_lines, names=self.METRIC_FAMILIES,
        )
        self.scrubber = VolumeScrubber(
            self.store, node_id=self.node_id, rate_mb=self.scrub_rate_mb,
            active_tmp_paths=self._active_rebuild_tmps,
        )
        if self.scrub_interval > 0:
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="volume-scrub", daemon=True)
            self._scrub_thread.start()
        self.heartbeat_once()
        self._pulse = threading.Thread(
            target=self._pulse_loop, name="volume-pulse", daemon=True
        )
        self._pulse.start()

    def stop(self) -> None:  # idempotent: fixtures may stop twice
        self._stop.set()
        if self._metrics_collector is not None:
            default_registry().unregister_collector(self._metrics_collector)
            self._metrics_collector = None
        self.service.stop()
        if self._pulse is not None:
            self._pulse.join()
            self._pulse = None
        if self._scrub_thread is not None:
            self._scrub_thread.join()
            self._scrub_thread = None
        with self._partial_lock:  # orphaned rebuild tmp files die with us
            for state in self._partial_rebuilds.values():
                state["writers"].abort()
            self._partial_rebuilds.clear()
        with self._stream_lock:  # wake forwarder threads so they exit
            streams, self._partial_streams = (
                list(self._partial_streams.values()), {})
        for st in streams:
            self._teardown_stream(st)
        if self.store:
            self.store.close()
            self.store = None

    @property
    def url(self) -> str:
        return self.service.url

    @property
    def node_id(self) -> str:
        """host:port, as the master's topology and the rebuild chain name
        this server (and as a fault spec's `key` scopes it)."""
        return f"{self._host}:{self.service.port}"

    def _codec(self) -> RSCodec:
        return RSCodec(device=self.device)

    # --- pulse: online-EC pumps and heartbeats ------------------------------------
    def _pump_online_ec(self) -> None:
        """The aging backstop of the online-EC stripe writers: writes pump
        inline, and this pump lets a partial row's timed trickle flush
        fire when no write follows."""
        if self.store is None:
            return
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                w = v.online_ec
                if w is not None and w.active and not w.sealed:
                    w.pump()

    def _pulse_loop(self) -> None:
        while not self._stop.wait(self.pulse_seconds):
            try:
                self._pump_online_ec()
            except Exception:
                pass
            # age out streaming sessions a dead orchestrator never closed:
            # each holds a forwarder thread and up to a window of chunks
            with self._stream_lock:
                swept = self._sweep_streams_locked()
            for st in swept:
                self._teardown_stream(st)
            if self._leaving:
                continue  # volume.server.leave: stay up, stop heartbeating
            self.heartbeat_once()

    def _scrub_loop(self) -> None:
        while not self._stop.wait(self.scrub_interval):
            try:
                found = self.scrubber.scrub_pass()
            except ScrubCodecFailed:
                continue  # kept on the scrubber: /admin/scrub/status shows it
            if found:
                # the master learns about fresh damage on the next beat
                # anyway; beating now shortens time-to-heal
                self.heartbeat_once()

    def _active_rebuild_tmps(self) -> set[str]:
        """Tmp shard paths belonging to IN-FLIGHT pipelined rebuilds —
        the scrubber's tmp-litter GC must never sweep these, any age."""
        with self._partial_lock:
            return {
                p
                for state in self._partial_rebuilds.values()
                for p in state["writers"].tmp_paths.values()
            }

    # --- metrics collector ------------------------------------------------------
    # the JAX server's FL_FAMILIES less the fastlane's (ROADMAP 10a-3)
    METRIC_FAMILIES = (
        "SeaweedFS_volume_disk_used_bytes",
        "SeaweedFS_volume_disk_free_bytes",
    )

    def _metrics_lines(self) -> list[str]:
        """Scrape-time per-directory disk gauges. The `server` label tells
        apart servers sharing one process registry (test clusters)."""
        server = self.node_id
        lines: list[str] = []

        def sample(family: str, labels: dict, value) -> None:
            # integers render exactly: '{:g}' would clip large byte counts
            v = str(int(value)) if float(value).is_integer() else f"{value:g}"
            lines.append(
                f"{family}{_fmt_labels(tuple(labels), tuple(labels.values()))}"
                f" {v}"
            )

        store = self.store
        if store is not None:
            lines.append("# TYPE SeaweedFS_volume_disk_used_bytes gauge")
            lines.append("# TYPE SeaweedFS_volume_disk_free_bytes gauge")
            for loc in store.locations:
                try:
                    sv = os.statvfs(loc.directory)
                except OSError:
                    continue
                sample("SeaweedFS_volume_disk_used_bytes",
                       {"server": server, "dir": loc.directory},
                       (sv.f_blocks - sv.f_bfree) * sv.f_frsize)
                sample("SeaweedFS_volume_disk_free_bytes",
                       {"server": server, "dir": loc.directory},
                       sv.f_bavail * sv.f_frsize)
        return lines

    def heartbeat_once(self) -> None:
        """One heartbeat POST to the master (none without a master_url).
        Sampled tracing (the first beat, then every 12th): a root span makes
        the master's handler span join its trace, while a span every beat
        would flood the bounded ring and evict request traces."""
        if not self.master_urls or self.store is None:
            return
        with self._hb_lock:
            n, self._hb_count = self._hb_count, self._hb_count + 1
            if n % 12:
                self._heartbeat_locked()
                return
            with trace.span("volume.heartbeat", role="volume"):
                self._heartbeat_locked()

    def _heartbeat_locked(self) -> None:
        try:
            _FP_HEARTBEAT.hit(key=self.node_id)
        except (faults.FaultInjected, ConnectionError, OSError):
            return  # partitioned from the master: the beat just vanishes
        hb = self.store.collect_heartbeat()
        hb["data_center"] = self.data_center
        hb["rack"] = self.rack
        hb["max_volume_count"] = self.max_volume_count
        if self.scrubber is not None:
            # unresolved scrub findings ride the beat (capped: repairs
            # resolve findings as they land, the rest ride later beats),
            # and the volumes a pass holds, so the master's vacuum waits
            hb["scrub_findings"] = self.scrubber.unresolved()[:64]
            hb["scrub_active"] = self.scrubber.active_volumes()
        tele = self._telemetry_frame()
        if tele is not None:
            hb["telemetry"] = tele
        body = json.dumps(hb).encode()
        rotation = [u for u in self.master_urls if u != self.master_url]
        for _ in range(len(self.master_urls) + 1):
            try:
                status, _, out = http_request(
                    "POST", f"{self.master_url}/heartbeat", body=body,
                    headers={"Content-Type": "application/json"}, timeout=10,
                )
                data = json.loads(out) if out else {}
            except Exception:
                if rotation:
                    self.master_url = rotation.pop(0)
                    continue
                return
            if status == 200:
                self.volume_size_limit = int(
                    data.get("volume_size_limit", self.volume_size_limit)
                )
                return
            leader = data.get("leader")
            if data.get("error") == "raft.not.leader" and leader:
                self.master_url = peer_url(leader).rstrip("/")
                continue
            if rotation:
                self.master_url = rotation.pop(0)
                continue
            return

    def _telemetry_frame(self):
        """The cluster telemetry frame riding the heartbeat body.
        Rate-limited to the pulse: heartbeat_once also fires on state
        changes (mounts, vacuum, rebuilds), and a churn burst must not pay
        sketch serialization per event."""
        now = time.time()
        interval = max(float(self.pulse_seconds), 2.0)
        if now - self._telemetry_ts < interval:
            return None
        self._telemetry_ts = now
        try:
            return agg_mod.build_frame(
                "volume", self.node_id, interval=interval, now=now,
            )
        except Exception:
            return None

    def _attach_shard_fetcher(self, ev) -> None:
        """Give an EcVolume remote shard sourcing: master ec_lookup for
        locations, then /admin/ec/shard range reads off sibling servers
        (`store_ec.go:281` readRemoteEcShardInterval) — plus the
        repair-bandwidth-optimal partial fan-in: one coefficient-scaled
        range per HOLDER (not per shard) for interval reconstruction."""
        me = self.node_id
        state = {"expires": 0.0, "shards": {}}

        def shard_map() -> dict:
            now = time.time()
            if now > state["expires"]:
                info = get_json(
                    f"{self.master_url}/dir/ec_lookup?volumeId={ev.volume_id}",
                    timeout=5,
                )
                state["shards"] = info.get("shards", {})
                state["expires"] = now + 10
            return state["shards"]

        def fetch(shard_id: int, off: int, size: int) -> bytes | None:
            for target in shard_map().get(str(shard_id), []):
                if target == me:
                    continue
                status, _, body = http_request(
                    "GET",
                    peer_url(target) + f"/admin/ec/shard?volume={ev.volume_id}"
                    f"&shard={shard_id}&offset={off}&size={size}",
                    timeout=30,
                )
                if status == 200 and len(body) == size:
                    return body
            return None

        def fetch_partials(missing: int, off: int, size: int) -> bytes:
            """Reconstruct shard `missing`'s [off, off+size) moving one
            partial per remote holder over the wire instead of one full
            range per shard. Declines (PartialDeclined, with its reason)
            when a `use` shard has no live holder, a holder refuses, or an
            answer's length or CRC is wrong; a holder's codec failure
            raises PartialCodecFailed; transport errors propagate."""
            smap = shard_map()
            local = set(ev.shards)
            present = sorted(
                ({int(s) for s, holders in smap.items() if holders} | local)
                - {missing}
            )
            if len(present) < geometry.DATA_SHARDS_COUNT:
                raise PartialDeclined("insufficient_shards")
            use, matrix = ec_decoder.repair_coefficients(present, [missing])
            groups: dict[str, list[int]] = {}
            local_use: list[int] = []
            for sid in use:
                if sid in local:
                    local_use.append(sid)
                    continue
                holders = [t for t in smap.get(str(sid), []) if t != me]
                if not holders:
                    raise PartialDeclined("no_holder")
                groups.setdefault(holders[0], []).append(sid)
            acc = None
            if local_use:
                rows = []
                for sid in local_use:
                    data = ev._pread_shard(sid, off, size)
                    if data is None:
                        raise PartialDeclined("local_short")
                    rows.append(np.frombuffer(data, dtype=np.uint8))
                cols = [use.index(s) for s in local_use]
                acc = ec_decoder.partial_contribution(
                    matrix[:, cols], np.stack(rows), ev.codec)
            for target, sids in groups.items():
                coefs = {
                    str(s): [int(matrix[0, use.index(s)])] for s in sids
                }
                url = (
                    peer_url(target) + f"/admin/ec/partial"
                    f"?volume={ev.volume_id}"
                    f"&collection={urllib.parse.quote(ev.collection)}"
                    f"&offset={off}&size={size}&targets={missing}"
                    f"&coefs={urllib.parse.quote(json.dumps(coefs))}"
                )
                status, hdrs, body = http_request(
                    "POST", url, b"", timeout=READ_POLICY.deadline)
                if status != 200:
                    err = _error_of(body)
                    if err.get("error") == "codec_failed":
                        raise PartialCodecFailed(
                            f"holder {target} codec failed: {err.get('detail', '')}")
                    raise PartialDeclined("holder_refused")
                if len(body) != size:
                    raise PartialDeclined("length")
                want = hdrs.get("X-Repair-Crc")
                if want is not None and int(want) != crc_mod.crc32c(body):
                    raise PartialDeclined("crc")
                acc = ec_decoder.xor_partials(
                    acc, np.frombuffer(body, dtype=np.uint8).reshape(1, size)
                )
            return np.ascontiguousarray(acc[0]).tobytes()

        ev.shard_fetcher = fetch
        ev.partial_fetcher = fetch_partials

    # --- streaming rebuild sessions ------------------------------------------
    def _scale_local_shards(
        self, vid: int, coefs: dict[int, list[int]], targets: list[int],
        offset: int, size: int, me: str,
    ) -> tuple[np.ndarray | None, int]:
        """One hop's locally-computed share of the repair sum for
        [offset, offset+size): scale this node's `use` shards by their
        coefficient columns on the mounted EcVolume's codec (the server's
        device). Returns (contribution or None when the hop owns nothing,
        bytes read from local shards); raises _PartialError with
        orchestrator-readable attribution, `codec_failed` (500) when the
        codec itself fails."""
        if not coefs:
            return None, 0
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            raise _PartialError(
                {"error": "ec volume not mounted", "failed_hop_server": me},
                409)
        sids = sorted(coefs)
        rows = []
        read = 0
        for sid in sids:
            if len(coefs[sid]) != len(targets):
                raise _PartialError(
                    {"error": f"coefs for shard {sid} != targets",
                     "failed_hop_server": me}, 400)
            data = ev._pread_shard(sid, offset, size)
            if data is None:
                raise _PartialError(
                    {"error": "shard_unavailable", "shard": sid,
                     "failed_hop_server": me}, 409)
            read += len(data)
            rows.append(np.frombuffer(data, dtype=np.uint8))
        m = np.array([coefs[s] for s in sids], dtype=np.uint8).T
        try:
            contrib = ec_decoder.partial_contribution(m, np.stack(rows), ev.codec)
        except Exception as e:  # the kernel or its copies, not transport
            raise _PartialError(
                {"error": "codec_failed", "failed_hop_server": me,
                 "detail": str(e)[:200]}, 500) from e
        return contrib, read

    def _stream_forwarder(self, state: dict) -> None:
        """Per-session forwarder thread on a mid-chain hop: ship queued
        chunks downstream IN ORDER while the HTTP handler computes the
        next one. A downstream failure is recorded on the session
        (attributed, with the chunk index) and the queue keeps draining so
        upstream enqueues never block behind a dead hop."""
        nxt = state["downstream"][0]
        url_base = (
            nxt["url"] + "/admin/ec/partial/stream/chunk"
            f"?session={state['session']}"
        )
        while True:
            item = state["queue"].get()
            if item is None:
                return
            try:
                self._forward_one(state, nxt, url_base, item)
            finally:
                state["drained"] += 1  # progress the close's drain wait reads

    def _forward_one(self, state: dict, nxt: dict, url_base: str,
                     item: tuple) -> None:
        """Ship one queued chunk downstream, or record why it failed."""
        seq, offset, size, payload = item
        if state["error"] is not None:
            return  # drain-and-discard: the session already failed
        url = url_base + f"&seq={seq}&offset={offset}&size={size}"

        def fwd():
            return http_request(
                "POST", url, payload,
                headers={"X-Repair-Crc": str(crc_mod.crc32c(payload))},
                timeout=READ_POLICY.deadline,
            )

        t0 = time.perf_counter()
        try:
            status, _, out = READ_POLICY.call(fwd)
        except Exception as e:
            # never die with chunks enqueued; the detail keeps the whole
            # cause (timeout, refusal or reset) and how long the forward ran
            state["error"] = {
                "error": "hop_unreachable" if isinstance(e, OSError) else "hop_failed",
                "failed_hop_server": nxt.get("server", ""),
                "chunk": seq,
                "detail": f"{type(e).__name__}: {e} after"
                          f" {(time.perf_counter() - t0) * 1e3:.1f} ms",
            }
            return
        if status != 200:
            downstream = _error_of(out)
            downstream.setdefault("error", f"hop -> {status}")
            downstream.setdefault(
                "failed_hop_server", nxt.get("server", ""))
            downstream.setdefault("chunk", seq)
            state["error"] = downstream
            return
        state["forwarded"] += 1
        ec_decoder.REPAIR.inc("stream_chunks", "forwarded")

    def _teardown_stream(self, state: dict) -> None:
        """Stop a session's forwarder (sentinel + join). Caller already
        removed it from _partial_streams.

        The join waits for the queue to drain for as long as the forwarder
        keeps shipping: each chunk gets the stall budget, the same bound a
        handler's enqueue has. A slow but healthy downstream therefore
        finishes its chunks before the close cascades past this hop. A
        forwarder that ships nothing for a whole budget marks the session
        failed (stream_stall), so the close never answers ok with chunks
        still queued here."""
        q, t = state.get("queue"), state.get("thread")
        if q is not None:
            try:
                q.put(None, timeout=state.get("stall_timeout", 1.0))
            except queue.Full:
                # forwarder wedged mid-send: mark failed so it discards
                # the backlog, then the sentinel fits
                state["error"] = state["error"] or {
                    "error": "stream_stall",
                    "failed_hop_server": "", "chunk": -1}
                try:
                    q.put(None, timeout=5.0)
                except queue.Full:
                    pass
        if t is None:
            return
        budget = state.get("stall_timeout", STREAM_STALL_TIMEOUT)
        seen = state["drained"]
        while True:
            t.join(timeout=budget)
            if not t.is_alive():
                return
            if state["drained"] == seen:
                break
            seen = state["drained"]
        ec_decoder.REPAIR.inc("stream_chunks", "stalled")
        state["error"] = state["error"] or {
            "error": "stream_stall",
            "failed_hop_server": state["downstream"][0].get("server", ""),
            "chunk": -1}

    def _sweep_streams_locked(self) -> list[dict]:
        """Drop sessions past the idle age (a dead orchestrator never
        closed them). Caller holds _stream_lock; returns the swept
        states for teardown OUTSIDE the lock."""
        now = time.time()
        swept = []
        for sid in list(self._partial_streams):
            st = self._partial_streams[sid]
            if now - st["touched"] > STREAM_SESSION_MAX_AGE:
                swept.append(self._partial_streams.pop(sid))
        return swept

    # --- replication --------------------------------------------------------------
    def _replicate(
        self,
        method: str,
        vid: int,
        fid: str,
        body: bytes,
        headers: dict,
        extra_query: dict | None = None,
    ) -> None:
        """Fan out to the other replica locations (`store_replicate.go:26`).
        All-or-nothing: any replica failure raises VolumeError, so the
        client's write is not acknowledged and it can retry with a fresh
        assignment. The original request's ttl/headers are forwarded so
        replicas store identical needles. Each push retries transient
        failures under READ_POLICY (fid-addressed, so a re-send cannot
        duplicate) before the verdict."""
        me = self.node_id
        _FP_REPLICATE.hit(key=me)
        try:
            info = get_json(f"{self.master_url}/dir/lookup?volumeId={vid}", timeout=5)
        except Exception as e:
            raise VolumeError(f"replicate lookup failed: {e}")
        qs = "type=replicate"
        for k, v in (extra_query or {}).items():
            qs += f"&{k}={urllib.parse.quote(str(v))}"
        for loc in info.get("locations", []):
            target = loc["url"]
            if target == me:
                continue

            def push(target=target):
                status, _, out = http_request(
                    method,
                    peer_url(target) + f"/{vid},{fid}?{qs}",
                    body=body,
                    headers={k: v for k, v in headers.items() if v},
                    timeout=READ_POLICY.deadline,
                )
                if status >= 500:  # transient server-side: worth a retry
                    raise IOError(f"replica {target} -> {status}")
                return status, out

            try:
                status, out = READ_POLICY.call(push)
            except (IOError, OSError) as e:
                raise VolumeError(f"replica write to {target} failed: {e}")
            if status >= 400:
                raise VolumeError(f"replica write to {target} failed: {out[:200]!r}")

    def _pull_file(
        self, source: str, vid: int, collection: str, ext: str, dest: str,
        chunk: int = 16 * 1024 * 1024,
    ) -> int:
        """Ranged GETs of /admin/volume/raw until EOF -> dest file.
        Downloads into a `.pull` sibling and renames, so a failed pull
        never clobbers an existing good file; a range that fails raises
        IOError. Returns the bytes pulled."""
        tmp = dest + ".pull"
        try:
            offset = 0
            with open(tmp, "wb") as f:
                while True:
                    url = (
                        f"{source}/admin/volume/raw?volume={vid}&ext={ext}"
                        f"&collection={urllib.parse.quote(collection)}"
                        f"&offset={offset}&size={chunk}"
                    )
                    status, headers, body = http_request("GET", url, timeout=120)
                    if status != 200:
                        raise IOError(f"pull {ext} from {source}: {status}")
                    f.write(body)
                    offset += len(body)
                    total = int(headers.get("X-Total-Size", offset))
                    if offset >= total or not body:
                        break
            os.replace(tmp, dest)
            return offset
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    # --- routes -------------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service

        @svc.route("GET", FID_RE)
        def read(req: Request) -> Response:
            return self._do_read(req, head=False)

        @svc.route("HEAD", FID_RE)
        def head(req: Request) -> Response:
            return self._do_read(req, head=True)

        @svc.route("POST", FID_RE)
        def write(req: Request) -> Response:
            return self._do_write(req)

        @svc.route("PUT", FID_RE)
        def put(req: Request) -> Response:
            return self._do_write(req)

        @svc.route("DELETE", FID_RE)
        def delete(req: Request) -> Response:
            return self._do_delete(req)

        @svc.route("GET", r"/status")
        def status(req: Request) -> Response:
            hb = self.store.collect_heartbeat()
            out = {"Version": "seaweedfs-tpu-torch", **hb}
            online = {
                str(v.id): v.online_ec.stats()
                for loc in self.store.locations
                for v in loc.volumes.values()
                if v.online_ec is not None
            }
            if online:
                out["ec_online"] = online
            return Response(out)

        @svc.route("POST", r"/admin/allocate_volume")
        def allocate(req: Request) -> Response:
            p = req.json()
            self.store.add_volume(
                int(p["volume"]),
                p.get("collection", ""),
                p.get("replication", "000"),
                p.get("ttl", ""),
                ec_online=bool(p.get("ecOnline", False)),
                ec_online_block=(
                    int(p["ecOnlineBlock"]) if p.get("ecOnlineBlock") else None
                ),
            )
            return Response({"ok": True})

        @svc.route("POST", r"/admin/delete_volume")
        def delete_volume(req: Request) -> Response:
            self.store.delete_volume(int(req.json()["volume"]))
            self.heartbeat_once()  # master forgets this replica promptly
            return Response({"ok": True})

        @svc.route("POST", r"/admin/vacuum")
        def vacuum(req: Request) -> Response:
            vid = int(req.json()["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            garbage = v.garbage_level()
            v.compact()
            v.commit_compact()
            self.heartbeat_once()
            return Response({"ok": True, "garbage_was": garbage})

        @svc.route("POST", r"/admin/volume/readonly")
        def readonly(req: Request) -> Response:
            p = req.json()
            self.store.mark_readonly(int(p["volume"]), bool(p.get("readonly", True)))
            return Response({"ok": True})

        @svc.route("GET", r"/ui")
        def ui(req: Request) -> Response:
            # minimal HTML status page (`weed/server/volume_server_ui/`)
            rows = []
            if self.store is not None:
                for vid in self.store.volume_ids():
                    v = self.store.get_volume(vid)
                    if v is None:
                        continue
                    rows.append(
                        f"<tr><td>{vid}</td><td>{v.collection or '(default)'}"
                        f"</td><td>{v.size()}</td><td>{v.file_count()}</td>"
                        f"<td>{v.garbage_level():.1%}</td>"
                        f"<td>{'ro' if v.readonly else 'rw'}</td></tr>"
                    )
            html = (
                "<html><head><title>seaweedfs-tpu volume</title></head><body>"
                f"<h1>Volume server {self.url}</h1>"
                f"<p>master: {self.master_url}</p>"
                "<table border=1><tr><th>id</th><th>collection</th>"
                "<th>size</th><th>files</th><th>garbage</th><th>mode</th></tr>"
                + "".join(rows) + "</table>"
                "<p><a href='/status'>status json</a> | "
                "<a href='/metrics'>metrics</a></p>"
                "</body></html>"
            ).encode()
            return Response(html, content_type="text/html")

        @svc.route("POST", r"/admin/volume/configure_replication")
        def configure_replication(req: Request) -> Response:
            p = req.json()
            vid = int(p["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            try:
                rp = ReplicaPlacement.parse(str(p["replication"]))
            except (ValueError, KeyError) as e:
                return Response({"error": str(e)}, 400)
            v.configure_replication(rp)
            return Response({"ok": True, "replication": str(rp)})

        # --- tiering (volume_grpc_tier_upload.go / _download.go) ---
        @svc.route("POST", r"/admin/backend/configure")
        def backend_configure(req: Request) -> Response:
            p = req.json()
            try:
                configure_backend(p["id"], p["kind"], **p.get("options", {}))
            except (BackendError, KeyError) as e:
                return Response({"error": str(e)}, 400)
            return Response({"ok": True})

        @svc.route("POST", r"/admin/volume/tier_upload")
        def tier_upload(req: Request) -> Response:
            p = req.json()
            vid = int(p["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            try:
                size = v.tier_to_remote(
                    p["backend"], keep_local=bool(p.get("keepLocal", False))
                )
            except (VolumeError, BackendError) as e:
                return Response({"error": str(e)}, 409)
            return Response({"ok": True, "size": size})

        @svc.route("POST", r"/admin/volume/tier_download")
        def tier_download(req: Request) -> Response:
            vid = int(req.json()["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            try:
                v.tier_to_local()
            except (VolumeError, BackendError) as e:
                return Response({"error": str(e)}, 409)
            return Response({"ok": True})

        @svc.route("GET", r"/admin/volume/tier_info")
        def tier_info(req: Request) -> Response:
            vid = int(req.query["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            return Response({"volume": vid, "remote": v.tier_info()})

        @svc.route("GET", r"/admin/tail")
        def tail(req: Request) -> Response:
            """The .dat bytes of the needles appended after since_ns
            (`volume_backup.go:66`), read through the volume's file (a
            tiered volume's through its backend)."""
            vid = int(req.query["volume"])
            since_ns = int(req.query.get("since_ns", 0))
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            start = (
                v.binary_search_by_append_at_ns(since_ns) if since_ns
                else SUPER_BLOCK_SIZE
            )
            data = v._dat.read_at(v.size() - start, start)
            return Response(data, content_type="application/octet-stream")

        @svc.route("POST", r"/query")
        def query(req: Request) -> Response:
            """S3-Select-ish filtering of one needle's JSON or CSV content
            (`volume_grpc_query.go:12`)."""
            p = req.json()
            fid = p.get("fid", "")
            try:
                vid_s, _, rest = fid.partition(",")
                vid = int(vid_s)
                key, cookie = parse_key_hash_with_delta(rest)
            except (ValueError, AttributeError):
                return Response({"error": f"bad fid {fid!r}"}, 400)
            # /query returns needle content: it is a read and demands the
            # same token the GET path does
            if not self._file_jwt_ok(req, self.security.read_key, fid):
                return Response({"error": "unauthorized"}, 401)
            try:
                n = self.store.read(vid, key, cookie=cookie)
            except (NotFound, VolumeError) as e:
                return Response({"error": str(e)}, 404)
            data = decompress_data(n.data) if n.is_compressed() else n.data
            select, where = p.get("select"), p.get("where")
            limit = int(p.get("limit", 0))
            try:
                if p.get("type", "json") == "csv":
                    rows = query_csv(
                        data, select, where,
                        has_header=bool(p.get("header", True)),
                        delimiter=p.get("delimiter", ","), limit=limit,
                    )
                else:
                    rows = query_json_lines(data, select, where, limit=limit)
            except ValueError as e:
                return Response({"error": str(e)}, 400)
            return Response({"rows": rows, "count": len(rows)})

        @svc.route("POST", r"/admin/leave")
        def leave(req: Request) -> Response:
            # stop heartbeating; the master expires this node
            # (`command_volume_server_leave.go` VolumeServerLeave rpc)
            self._leaving = True
            return Response({"ok": True})

        # --- volume copy / move plane (volume_grpc_copy.go) ---
        @svc.route("GET", r"/admin/volume/files")
        def volume_files(req: Request) -> Response:
            """List a volume's files + sizes so a receiver can pull them."""
            vid = int(req.query["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            out = {}
            for ext in (".dat", ".idx", ".vif"):
                path = v.base_name + ext
                if os.path.exists(path):
                    out[ext] = os.path.getsize(path)
            return Response(
                {"collection": v.collection, "files": out,
                 "version": v.version(),
                 "last_append_at_ns": v.last_append_at_ns}
            )

        @svc.route("GET", r"/admin/volume/raw")
        def volume_raw(req: Request) -> Response:
            """Raw byte range of one volume/EC file — the copy stream
            (`VolumeCopy`/`CopyFile` stream in volume_server.proto)."""
            vid = int(req.query["volume"])
            ext = req.query["ext"]
            collection = req.query.get("collection", "")
            offset = int(req.query.get("offset", 0))
            size = int(req.query.get("size", -1))
            if not _SAFE_EXT_RE.fullmatch(ext):
                return Response({"error": f"bad ext {ext}"}, 400)
            v = self.store.get_volume(vid)
            if v is not None:
                path = v.base_name + ext
            else:
                path = None
                for loc in self.store.locations:
                    cand = volume_file_name(loc.directory, collection, vid) + ext
                    if os.path.exists(cand):
                        path = cand
                        break
            if path is None or not os.path.exists(path):
                return Response({"error": f"no {ext} for volume {vid}"}, 404)
            total = os.path.getsize(path)
            if size < 0:
                size = total - offset
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size)
            return Response(
                data, content_type="application/octet-stream",
                headers={"X-Total-Size": str(total)},
            )

        @svc.route("POST", r"/admin/volume/copy")
        def volume_copy(req: Request) -> Response:
            """Pull a volume's .dat/.idx from another volume server and mount
            it locally (`volume_grpc_copy.go VolumeCopy` — receiver-driven).
            A live online-EC volume arrives as .dat/.idx/.vif only, so the
            pulled .vif's unsealed ec_online policy re-arms the striper
            here: parity re-encoded from byte 0 of the durable .dat on this
            server's device."""
            p = req.json()
            vid = int(p["volume"])
            source = p["source"].rstrip("/")
            if self.store.has_volume(vid):
                return Response({"error": f"volume {vid} already here"}, 409)
            meta = get_json(f"{source}/admin/volume/files?volume={vid}", timeout=30)
            collection = meta.get("collection", "")
            loc = self.store._pick_location()
            base = volume_file_name(loc.directory, collection, vid)
            for ext in meta["files"]:
                self._pull_file(source, vid, collection, ext, base + ext)
            v = self.store.mount_volume(vid, collection)
            rearmed_rows = None
            try:
                _attach_online_ec(v)  # no-op unless the .vif demands it
                if v.online_ec is not None:
                    rearmed_rows = v.online_ec.rearm()
            except Exception:
                # parity re-arm failed: the volume still serves off the
                # .dat and heartbeats without ec_online, so the layout
                # re-demands its real replica count and repair owns it
                if v.online_ec is not None:
                    v.online_ec.close()
                    v.online_ec = None
            self.heartbeat_once()
            out = {"ok": True, "volume": vid, "size": v.size(),
                   "last_append_at_ns": v.last_append_at_ns}
            if rearmed_rows is not None:
                out["ec_online_rearmed_rows"] = rearmed_rows
            return Response(out)

        @svc.route("POST", r"/admin/volume/mount")
        def volume_mount(req: Request) -> Response:
            p = req.json()
            v = self.store.mount_volume(int(p["volume"]), p.get("collection", ""))
            self.heartbeat_once()
            return Response({"ok": True, "size": v.size()})

        @svc.route("POST", r"/admin/volume/unmount")
        def volume_unmount(req: Request) -> Response:
            self.store.unmount_volume(int(req.json()["volume"]))
            self.heartbeat_once()
            return Response({"ok": True})

        @svc.route("GET", r"/admin/volume/needle_blob")
        def needle_blob(req: Request) -> Response:
            """Raw on-disk needle record (`ReadNeedleBlob`)."""
            vid = int(req.query["volume"])
            offset = int(req.query["offset"])
            size = int(req.query["size"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            return Response(
                v.read_needle_blob(offset, size),
                content_type="application/octet-stream",
            )

        @svc.route("POST", r"/admin/volume/write_needle_blob")
        def write_needle_blob(req: Request) -> Response:
            """Append a needle copied raw from a replica (`WriteNeedleBlob` —
            volume.check.disk repair path). Body = the on-disk record."""
            vid = int(req.query["volume"])
            size = int(req.query["size"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            n = Needle.from_bytes(req.body, size, v.version())
            v.write_needle(n)
            return Response({"ok": True, "id": n.id})

        @svc.route("GET", r"/admin/volume/needles")
        def volume_needles(req: Request) -> Response:
            """Live needle ids+sizes from the index — replica diffing for
            volume.check.disk and the scrub sync."""
            vid = int(req.query["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            needles = [
                {"id": key, "offset": off, "size": sz}
                for key, off, sz in v.nm.ascending_visit()
            ]
            return Response({"volume": vid, "needles": needles})

        @svc.route("GET", r"/admin/fsck")
        def fsck(req: Request) -> Response:
            """Walk the index and CRC-verify every live needle
            (`volume_checking.go` + shell volume.fsck)."""
            vid = int(req.query["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            checked, errors = 0, []
            for key, off, sz in v.nm.ascending_visit():
                try:
                    v.read_needle(key)
                    checked += 1
                except Exception as e:
                    errors.append({"id": key, "error": str(e)})
            return Response(
                {"volume": vid, "checked": checked, "errors": errors,
                 "ok": not errors}
            )

        # --- integrity scrub plane (maintenance/scrub.py) -----------------
        @svc.route("GET", r"/admin/scrub/status")
        def scrub_status(req: Request) -> Response:
            if self.scrubber is None:
                return Response({"error": "scrubber not started"}, 503)
            out = self.scrubber.status()
            out["interval"] = self.scrub_interval
            return Response(out)

        @svc.route("POST", r"/admin/scrub/run")
        def scrub_run(req: Request) -> Response:
            """One synchronous, throttled scrub pass (whole store, or one
            volume) — the volume.scrub verb's entry. Detection only:
            repairs route through volume.scrub -apply. A kernel or codec
            failure is a 500 `codec_failed` naming this server."""
            if self.scrubber is None:
                return Response({"error": "scrubber not started"}, 503)
            try:
                p = req.json()
            except ValueError:
                p = {}
            vid = int(p["volume"]) if p.get("volume") is not None else None
            try:
                found = self.scrubber.scrub_pass(volume_id=vid)
            except ScrubCodecFailed as e:
                return Response({"error": "codec_failed", "server": self.node_id,
                                 "detail": str(e)[:200]}, 500)
            if found:
                self.heartbeat_once()  # the master learns immediately
            return Response({
                "ok": True,
                "findings": [f.to_dict() for f in found],
                "stats": dict(self.scrubber.stats),
            })

        @svc.route("POST", r"/admin/scrub/resolve")
        def scrub_resolve(req: Request) -> Response:
            """Drop findings a just-applied repair addressed (the shard and
            parity heals call it), so the heartbeat stops re-advertising
            healed damage. The next pass re-verifies."""
            if self.scrubber is None:
                return Response({"error": "scrubber not started"}, 503)
            p = req.json()
            kind = p.get("kind")
            dropped = self.scrubber.resolve(
                kind=kind,
                volume=int(p["volume"]) if p.get("volume") is not None
                else None,
                needle=int(p["needle"]) if p.get("needle") is not None
                else None,
            )
            if kind in self.scrubber.counters["repairs"]:
                self.scrubber.count_repair(kind)
            if dropped:
                self.heartbeat_once()
            return Response({"ok": True, "resolved": dropped})

        @svc.route("GET", r"/admin/scrub/needle")
        def scrub_needle(req: Request) -> Response:
            """One needle's record, read through the full verifying path
            (CRC + degraded-read ladder) and re-serialized canonically —
            the verified-good source side of a corrupt-needle repair."""
            vid = int(req.query["volume"])
            needle_id = int(req.query["needle"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            try:
                n = v.read_needle(needle_id)
            except NotFound:
                return Response({"error": "needle not found"}, 404)
            except Exception as e:
                # this holder can't prove the needle either: not a source
                return Response({"error": f"unverifiable: {e}"}, 409)
            return Response(
                n.to_bytes(v.version()),
                content_type="application/octet-stream",
            )

        @svc.route("POST", r"/admin/scrub/repair_needle")
        def scrub_repair_needle(req: Request) -> Response:
            """Heal one corrupt needle in place: re-append a verified
            copy (from `source`'s /admin/scrub/needle, or reconstructed
            locally through the degraded-read ladder when this volume
            has EC redundancy). The needle map then points at the clean
            record; the corrupt bytes become vacuumable garbage."""
            p = req.json()
            vid = int(p["volume"])
            needle_id = int(p["needle"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            source = (p.get("source") or "").rstrip("/")
            try:
                if source:
                    status, _, blob = http_request(
                        "GET",
                        f"{source}/admin/scrub/needle?volume={vid}"
                        f"&needle={needle_id}",
                        timeout=60,
                    )
                    if status != 200:
                        return Response(
                            {"error": f"source -> {status}"}, 502)
                    n = Needle.from_bytes(blob, version=v.version())
                else:
                    # local redundancy: read_needle's degraded ladder
                    # reconstructs from online/sealed EC parity
                    n = v.read_needle(needle_id)
            except Exception as e:
                return Response(
                    {"error": f"no verified copy: {e}"}, 409)
            if n.id != needle_id:
                return Response({"error": "source returned wrong needle"},
                                409)
            v.write_needle(n)
            if self.scrubber is not None:
                self.scrubber.resolve(kind="corrupt_needle", volume=vid,
                                      needle=needle_id)
                self.scrubber.count_repair("corrupt_needle")
            self.heartbeat_once()  # digest/finding state changed
            return Response({"ok": True, "needle": f"{needle_id:x}",
                             "source": source or "local-reconstruction"})

        @svc.route("POST", r"/admin/scrub/sync")
        def scrub_sync(req: Request) -> Response:
            """Anti-entropy re-sync of THIS holder's replica from a
            digest-majority source: pull the source's live needle list,
            append verified copies of needles we miss, tombstone needles
            the majority deleted. Needle-level — no whole-volume copy."""
            p = req.json()
            vid = int(p["volume"])
            source = p["source"].rstrip("/")
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            listing = get_json(
                f"{source}/admin/volume/needles?volume={vid}", timeout=300)
            theirs = {int(n["id"]): n for n in listing.get("needles", [])}
            mine = {key for key, _off, _sz in v.nm.ascending_visit()}
            if not theirs and mine:
                # an empty source would tombstone the whole replica:
                # refuse (fix_replication/human territory)
                return Response(
                    {"error": "source reports no live needles; refusing"
                              " to mass-delete this replica"}, 409)
            copied, deleted, failed = 0, 0, 0
            for nid, meta in theirs.items():
                if nid in mine:
                    continue
                status, _, blob = http_request(
                    "GET",
                    f"{source}/admin/volume/needle_blob?volume={vid}"
                    f"&offset={meta['offset']}&size={meta['size']}",
                    timeout=60,
                )
                if status != 200:
                    failed += 1
                    continue
                try:  # from_bytes CRC-verifies: never sync damage in
                    n = Needle.from_bytes(
                        blob, size=meta["size"], version=v.version())
                    v.write_needle(n)
                    copied += 1
                except Exception:
                    failed += 1
            for nid in mine - set(theirs):
                # the majority tombstoned it; a diverged replica that
                # missed the delete must not resurrect it on failover
                v.delete_needle(Needle(id=nid))
                deleted += 1
            if self.scrubber is not None:
                self.scrubber.resolve(kind="replica_divergence",
                                      volume=vid)
                self.scrubber.count_repair("replica_divergence")
            self.heartbeat_once()  # fresh digest -> divergence clears
            return Response({"ok": True, "copied": copied,
                             "deleted": deleted, "failed": failed})

        # --- EC verbs (volume_grpc_erasure_coding.go) ---
        @svc.route("POST", r"/admin/ec/generate")
        def ec_generate(req: Request) -> Response:
            p = req.json()
            vid = int(p["volume"])
            v = self.store.get_volume(vid)
            if v is None:
                return Response({"error": f"volume {vid} not found"}, 404)
            v.readonly = True
            sealed_online = False
            base = v.base_name
            if v.online_ec is not None and v.online_ec.active:
                # ingest already paid the GF math: the seal flushes the
                # tail row and copies the data shards — no re-encode
                try:
                    v.online_ec.seal()
                    sealed_online = True
                except RuntimeError:
                    pass  # degraded mid-seal: classic encode below
            if not sealed_online:
                ec_encoder.write_ec_files(base, codec=self._codec())
            ec_encoder.write_sorted_file_from_idx(base)
            if not sealed_online:
                # classic path: the shards now belong to the EC volume —
                # detach any (degraded) stripe writer so a later destroy
                # can't mistake .ec10-.ec13 for its partial parity, and
                # write a plain .vif
                if v.online_ec is not None:
                    v.online_ec.close()
                    v.online_ec = None
                    try:
                        os.unlink(base + ".ecp")
                    except OSError:
                        pass
                ec_encoder.save_volume_info(base + ".vif", version=v.version())
            return Response({"ok": True, "shards": list(range(14)),
                             "online": sealed_online})

        @svc.route("POST", r"/admin/ec/mount")
        def ec_mount(req: Request) -> Response:
            p = req.json()
            vid = int(p["volume"])
            # atomic: the old instance (if any) serves until the new one
            # is swapped in
            ev = self.store.remount_ec_volume(vid, p.get("collection", ""))
            if ev is None:
                return Response(
                    {"error": f"no local .ecx for ec volume {vid}"}, 404)
            self._attach_shard_fetcher(ev)
            self.heartbeat_once()
            return Response({"ok": True, "shards": ev.shard_ids()})

        @svc.route("POST", r"/admin/ec/unmount")
        def ec_unmount(req: Request) -> Response:
            self.store.unmount_ec_volume(int(req.json()["volume"]))
            self.heartbeat_once()
            return Response({"ok": True})

        @svc.route("POST", r"/admin/ec/rebuild")
        def ec_rebuild(req: Request) -> Response:
            p = req.json()
            vid = int(p["volume"])
            collection = p.get("collection", "")
            for loc in self.store.locations:
                base = ec_shard_file_name(collection, loc.directory, vid)
                if any(
                    os.path.exists(base + geometry.to_ext(i))
                    for i in range(geometry.TOTAL_SHARDS_COUNT)
                ):
                    rebuilt = ec_encoder.rebuild_ec_files(
                        base, codec=self._codec())
                    return Response({"ok": True, "rebuilt": rebuilt})
            return Response({"error": f"no shards for volume {vid}"}, 404)

        @svc.route("POST", r"/admin/ec/online/rebuild")
        def ec_online_rebuild(req: Request) -> Response:
            """Re-arm a LIVE online-EC volume's striper and re-encode its
            parity from the durable .dat — the heal for a lost/torn parity
            shard. Safe under traffic: parity is a pure function of the
            append-only .dat."""
            vid = int(req.json()["volume"])
            v = self.store.get_volume(vid)
            if v is None or v.online_ec is None:
                return Response(
                    {"error": f"volume {vid} has no online-EC striper"}, 404
                )
            rows = v.online_ec.rearm()
            self.heartbeat_once()  # the parity-damage count clears now
            return Response({
                "ok": True, "rows": rows,
                "watermark": v.online_ec.watermark,
                "active": v.online_ec.active,
            })

        @svc.route("POST", r"/admin/ec/delete_volume")
        def ec_delete(req: Request) -> Response:
            """Delete the original volume files after EC spread
            (`command_ec_encode.go` deletes source replicas)."""
            self.store.delete_volume(int(req.json()["volume"]))
            self.heartbeat_once()
            return Response({"ok": True})

        @svc.route("POST", r"/admin/ec/to_volume")
        def ec_to_volume(req: Request) -> Response:
            """Reconstruct the original .dat/.idx from locally-collected EC
            shards (`volume_grpc_erasure_coding.go:407 VolumeEcShardsToVolume`).
            Missing data shards are rebuilt from parity first."""
            p = req.json()
            vid = int(p["volume"])
            collection = p.get("collection", "")
            base = None
            for loc in self.store.locations:
                cand = ec_shard_file_name(collection, loc.directory, vid)
                if os.path.exists(cand + ".ecx"):
                    base = cand
                    break
            if base is None:
                return Response({"error": f"no .ecx for volume {vid}"}, 404)
            have = [
                s for s in range(geometry.TOTAL_SHARDS_COUNT)
                if os.path.exists(base + geometry.to_ext(s))
            ]
            if any(s not in have for s in range(geometry.DATA_SHARDS_COUNT)):
                ec_encoder.rebuild_ec_files(base, codec=self._codec())
            # an EC volume with zero live needles still has its superblock
            # striped into .ec00 — never write a .dat shorter than that
            dat_size = max(
                ec_decoder.find_dat_file_size(base, base), SUPER_BLOCK_SIZE
            )
            shard_names = [
                base + geometry.to_ext(s)
                for s in range(geometry.DATA_SHARDS_COUNT)
            ]
            # online-sealed volumes striped with a recorded uniform block
            # geometry — the .vif is authoritative over the defaults
            info = ec_encoder.load_volume_info(base + ".vif")
            ec_decoder.write_dat_file(
                base, dat_size, shard_names,
                large_block_size=int(
                    info.get("large_block_size", geometry.LARGE_BLOCK_SIZE)),
                small_block_size=int(
                    info.get("small_block_size", geometry.SMALL_BLOCK_SIZE)),
            )
            ec_decoder.write_idx_file_from_ec_index(base)
            v = self.store.mount_volume(vid, collection)
            self.heartbeat_once()
            return Response({"ok": True, "size": v.size()})

        @svc.route("POST", r"/admin/ec/copy")
        def ec_copy(req: Request) -> Response:
            """Pull EC shard files (+ .ecx/.vif) from a source server
            (`VolumeEcShardsCopy`)."""
            p = req.json()
            vid = int(p["volume"])
            collection = p.get("collection", "")
            shards = [int(s) for s in p.get("shards", [])]
            source = p["source"].rstrip("/")
            loc = self.store._pick_location()
            base = ec_shard_file_name(collection, loc.directory, vid)
            exts = [geometry.to_ext(s) for s in shards]
            if p.get("copy_ecx", True) and not os.path.exists(base + ".ecx"):
                exts += [".ecx"]
            if p.get("copy_ecj", False):
                exts.append(".ecj")
            if p.get("copy_vif", True) and not os.path.exists(base + ".vif"):
                exts.append(".vif")
            copied = []
            pulled = 0
            for ext in exts:
                try:
                    pulled += self._pull_file(
                        source, vid, collection, ext, base + ext)
                    copied.append(ext)
                except IOError:
                    if ext == ".ecj":  # deletion journal may not exist
                        continue
                    if ext == ".vif":  # synthesize a default when absent
                        ec_encoder.save_volume_info(base + ".vif")
                        continue
                    raise
            if p.get("repair") and pulled:
                # whole-shard pulls feeding a classic rebuild: the traffic
                # the pipelined mode exists to cut, counted at the
                # receiving rebuilder as the partial hops are
                ec_decoder.REPAIR.inc("bytes_on_wire", "classic", pulled)
            return Response({"ok": True, "copied": copied, "bytes": pulled})

        @svc.route("POST", r"/admin/ec/delete_shards")
        def ec_delete_shards(req: Request) -> Response:
            """Remove local shard files after they moved elsewhere
            (`VolumeEcShardsDelete`)."""
            p = req.json()
            vid = int(p["volume"])
            collection = p.get("collection", "")
            shards = [int(s) for s in p.get("shards", [])]
            removed = []
            was_mounted = self.store.get_ec_volume(vid) is not None
            for loc in self.store.locations:
                base = ec_shard_file_name(collection, loc.directory, vid)
                for s in shards:
                    path = base + geometry.to_ext(s)
                    if os.path.exists(path):
                        os.remove(path)
                        removed.append(s)
                if p.get("delete_index", False):
                    for ext in (".ecx", ".ecj", ".vif"):
                        if os.path.exists(base + ext):
                            os.remove(base + ext)
            if was_mounted:
                # atomic swap: the old instance (whose open fds still
                # serve the just-unlinked shards) covers concurrent reads
                # until the refreshed one is in place, and the refresh
                # re-attaches the remote shard fetcher
                ev = self.store.remount_ec_volume(vid, collection)
                if ev is not None:
                    self._attach_shard_fetcher(ev)
            self.heartbeat_once()
            return Response({"ok": True, "removed": removed})

        @svc.route("GET", r"/admin/ec/shard")
        def ec_shard_read(req: Request) -> Response:
            """Raw shard byte range — remote EC reads (`store_ec.go:281`).
            An OPEN online-EC volume serves the same ranges before any
            seal: parity from the incrementally-written .ec1x files, data
            shards as views into the live .dat (online.py
            read_shard_range)."""
            vid = int(req.query["volume"])
            shard = int(req.query["shard"])
            offset = int(req.query.get("offset", 0))
            size = int(req.query.get("size", -1))
            ev = self.store.get_ec_volume(vid)
            if ev is None:
                v = self.store.get_volume(vid)
                if v is not None and v.online_ec is not None and size >= 0:
                    data = v.online_ec.read_shard_range(shard, offset, size)
                    if data is None:
                        return Response(
                            {"error": f"shard {shard} range unavailable"}, 404)
                    return Response(
                        data, content_type="application/octet-stream")
                return Response({"error": "ec volume not mounted"}, 404)
            fd = ev.shards.get(shard)
            if fd is None:
                return Response({"error": f"shard {shard} not local"}, 404)
            if size < 0:
                size = ev.shard_size - offset
            data = os.pread(fd, size, offset)
            return Response(data, content_type="application/octet-stream")

        # --- pipelined partial-sum rebuild plane --------------------------
        @svc.route("POST", r"/admin/ec/partial/start")
        def ec_partial_start(req: Request) -> Response:
            """Open a pipelined rebuild on this node (the chain's terminal
            writer): pre-sized tmp shard files for `targets`, renamed into
            place only at commit. `resume: true` keeps an existing
            same-target state and returns its committed frontier, so a
            restarted chain re-sends only the uncommitted suffix."""
            p = req.json()
            vid = int(p["volume"])
            targets = [int(s) for s in p.get("targets", [])]
            ev = self.store.get_ec_volume(vid)
            if ev is None:
                return Response({"error": "ec volume not mounted"}, 404)
            if not targets or any(
                t < 0 or t >= geometry.TOTAL_SHARDS_COUNT for t in targets
            ):
                return Response({"error": f"bad targets {targets}"}, 400)
            with self._partial_lock:
                old = self._partial_rebuilds.get(vid)
                if (
                    p.get("resume") and old is not None
                    and old["targets"] == targets
                ):
                    return Response({
                        "ok": True, "shard_size": old["shard_size"],
                        "targets": targets, "resumed": True,
                        "committed": old["committed"],
                    })
                old = self._partial_rebuilds.pop(vid, None)
                if old is not None:  # stale orchestrator: replace its state
                    old["writers"].abort()
                writers = ec_encoder._ShardWriters(
                    ev.data_base, ev.shard_size, shard_ids=targets
                )
                self._partial_rebuilds[vid] = {
                    "writers": writers, "targets": targets,
                    "shard_size": ev.shard_size,
                    "collection": p.get("collection", ""),
                    # contiguous per-shard byte frontier the chain has
                    # landed (chunks arrive in order): restarts resume here
                    "committed": 0,
                }
            return Response({
                "ok": True, "shard_size": ev.shard_size, "targets": targets,
                "committed": 0,
            })

        @svc.route("POST", r"/admin/ec/partial/commit")
        def ec_partial_commit(req: Request) -> Response:
            vid = int(req.json()["volume"])
            with self._partial_lock:
                state = self._partial_rebuilds.get(vid)
                if state is not None and state["committed"] < state["shard_size"]:
                    # committing a half-landed rebuild would rename a
                    # partially-written file under a valid shard name
                    return Response(
                        {"error": "rebuild incomplete",
                         "committed": state["committed"],
                         "shard_size": state["shard_size"]}, 409)
                state = self._partial_rebuilds.pop(vid, None)
            if state is None:
                return Response({"error": "no rebuild state"}, 404)
            state["writers"].close()
            # atomic swap: reads keep serving off the old instance until
            # the one that sees the rebuilt shards replaces it
            ev = self.store.remount_ec_volume(vid, state["collection"])
            if ev is None:
                return Response({"error": "ec volume vanished"}, 409)
            self._attach_shard_fetcher(ev)
            self.heartbeat_once()
            return Response({
                "ok": True, "rebuilt": state["targets"],
                "shards": ev.shard_ids(),
            })

        @svc.route("POST", r"/admin/ec/partial/abort")
        def ec_partial_abort(req: Request) -> Response:
            vid = int(req.json()["volume"])
            with self._partial_lock:
                state = self._partial_rebuilds.pop(vid, None)
            if state is not None:
                state["writers"].abort()
            return Response({"ok": True, "aborted": state is not None})

        @svc.route("POST", r"/admin/ec/partial")
        def ec_partial(req: Request) -> Response:
            """One partial-sum hop. Body: the accumulated partial so far
            (empty for the chain head), CRC-guarded. Query: volume /
            collection / offset / size / targets, plus either `chain`
            (JSON hop list, chain[0] == this node; forward the XOR to
            chain[1], the last hop writes into the /admin/ec/partial/start
            state) or bare `coefs` (the range-limited partial served
            straight back: a degraded read fans in one scaled range per
            holder). Every received or served payload counts into
            bytes_on_wire["pipelined"]."""
            me = self.node_id
            q = req.query
            vid = int(q["volume"])
            _FP_PARTIAL.hit(key=me)
            collection = q.get("collection", "")
            offset = int(q["offset"])
            size = int(q["size"])
            targets = [int(s) for s in q.get("targets", "").split(",") if s]
            if size <= 0 or offset < 0 or not targets:
                return Response({"error": "bad offset/size/targets"}, 400)
            chain = json.loads(q["chain"]) if "chain" in q else []
            # hop identity onto the request's server span: a pipelined
            # rebuild renders in cluster.trace as one cross-node chain of
            # `POST /admin/ec/partial` spans, the attrs naming each hop
            trace.annotate(volume=vid, targets=targets, hop=me,
                           hops_left=len(chain))
            if chain:
                hop, rest = chain[0], chain[1:]
                coefs = {int(k): v for k, v in hop.get("coefs", {}).items()}
                write = bool(hop.get("write"))
            else:
                rest, write = [], False
                coefs = {int(k): v for k, v in
                         json.loads(q.get("coefs", "{}")).items()}
            body = req.body
            if body:
                if len(body) != len(targets) * size:
                    return Response(
                        {"error": "partial size mismatch",
                         "failed_hop_server": me}, 409)
                want = req.headers.get("X-Repair-Crc")
                if want is not None and int(want) != crc_mod.crc32c(body):
                    return Response(
                        {"error": "crc_mismatch", "failed_hop_server": me},
                        409)
                ec_decoder.REPAIR.inc("bytes_on_wire", "pipelined", len(body))
                partial = np.frombuffer(body, dtype=np.uint8) \
                    .reshape(len(targets), size).copy()
            else:
                partial = None
            try:
                contrib, local_read = self._scale_local_shards(
                    vid, coefs, targets, offset, size, me)
            except _PartialError as e:
                return Response(e.payload, e.status)
            if contrib is not None:
                partial = contrib if partial is None \
                    else ec_decoder.xor_partials(partial, contrib)
            if partial is None:
                partial = np.zeros((len(targets), size), dtype=np.uint8)
            if rest:  # forward the accumulated sum to the next hop
                nxt = rest[0]
                payload = np.ascontiguousarray(partial).tobytes()
                url = (
                    nxt["url"] + f"/admin/ec/partial?volume={vid}"
                    f"&collection={urllib.parse.quote(collection)}"
                    f"&offset={offset}&size={size}"
                    f"&targets={','.join(str(t) for t in targets)}"
                    f"&chain={urllib.parse.quote(json.dumps(rest))}"
                )

                def fwd():
                    return http_request(
                        "POST", url, payload,
                        headers={"X-Repair-Crc":
                                 str(crc_mod.crc32c(payload))},
                        timeout=READ_POLICY.deadline,
                    )

                try:  # transport failures retry under the shared policy
                    status, _, out = READ_POLICY.call(fwd)
                except (IOError, OSError) as e:
                    return Response(
                        {"error": "hop_unreachable",
                         "failed_hop_server": nxt.get("server", ""),
                         "failed_hop": nxt["url"],
                         "detail": str(e)[:200]}, 502)
                downstream = _error_of(out)
                if status != 200:
                    downstream.setdefault("error", f"hop -> {status}")
                    downstream.setdefault(
                        "failed_hop_server", nxt.get("server", ""))
                    return Response(downstream, 502)
                downstream["received"] = (
                    [len(body)] + downstream.get("received", []))
                downstream["read"] = (
                    [local_read] + downstream.get("read", []))
                return Response(downstream)
            if write:  # chain terminal: land the sum in the rebuild state
                with self._partial_lock:
                    state = self._partial_rebuilds.get(vid)
                    if state is None or state["targets"] != targets:
                        return Response(
                            {"error": "start_failed",
                             "detail": "no matching rebuild state",
                             "failed_hop_server": me}, 409)
                    for i, sid in enumerate(targets):
                        state["writers"].pwrite(sid, partial[i], offset)
                    if offset == state["committed"]:
                        state["committed"] = offset + size
                return Response({"ok": True, "received": [len(body)],
                                 "read": [local_read]})
            # bare ranged partial: serve the scaled range back
            payload = np.ascontiguousarray(partial).tobytes()
            ec_decoder.REPAIR.inc("bytes_on_wire", "pipelined", len(payload))
            return Response(
                payload, content_type="application/octet-stream",
                headers={"X-Repair-Crc": str(crc_mod.crc32c(payload))},
            )

        # --- streaming session mode (hop-parallel chunk pipelining) -------
        # A stream session arms every hop once (open cascades down the
        # chain), then each chunk POST is ACKed after local compute +
        # enqueue — the hop's forwarder thread ships chunk k downstream
        # while the handler computes chunk k+1. Bounded queue = in-flight
        # window = backpressure: a stalled downstream fills the queue and
        # the enqueue timeout surfaces as a typed stream_stall.

        @svc.route("POST", r"/admin/ec/partial/stream/open")
        def ec_partial_stream_open(req: Request) -> Response:
            me = self.node_id
            p = req.json()
            sid = str(p.get("session", ""))
            vid = int(p["volume"])
            chain = p.get("chain") or []
            targets = [int(t) for t in p.get("targets", [])]
            if not sid or not chain or not targets:
                return Response(
                    {"error": "bad session/chain/targets",
                     "failed_hop_server": me}, 400)
            _FP_PARTIAL.hit(key=me)
            trace.annotate(volume=vid, targets=targets, hop=me,
                           hops_left=len(chain), stream=True)
            hop, rest = chain[0], chain[1:]
            state = {
                "session": sid, "volume": vid,
                "collection": p.get("collection", ""),
                "targets": targets,
                "coefs": {int(k): v
                          for k, v in hop.get("coefs", {}).items()},
                "write": bool(hop.get("write")),
                "downstream": rest,
                "window": max(1, int(p.get("window", STREAM_WINDOW))),
                "stall_timeout": float(
                    p.get("stall_timeout", STREAM_STALL_TIMEOUT)),
                "received": 0, "read": 0, "forwarded": 0, "drained": 0,
                "error": None, "touched": time.time(),
                "queue": None, "thread": None,
            }
            if rest:
                # arm the whole chain before any chunk flows: the open
                # cascades downstream synchronously (chain latency once,
                # not per chunk)
                body = dict(p)
                body["chain"] = rest
                try:
                    status, _, out = http_request(
                        "POST",
                        rest[0]["url"] + "/admin/ec/partial/stream/open",
                        json.dumps(body).encode(),
                        headers={"Content-Type": "application/json"},
                        timeout=60,
                    )
                except (IOError, OSError) as e:
                    return Response(
                        {"error": "hop_unreachable",
                         "failed_hop_server": rest[0].get("server", ""),
                         "detail": str(e)[:200]}, 502)
                if status != 200:
                    downstream = _error_of(out)
                    downstream.setdefault("error", f"open -> {status}")
                    downstream.setdefault(
                        "failed_hop_server", rest[0].get("server", ""))
                    return Response(downstream, 502)
                state["queue"] = queue.Queue(maxsize=state["window"])
                t = threading.Thread(
                    target=self._stream_forwarder, args=(state,),
                    daemon=True, name="ec-stream-forwarder",
                )
                state["thread"] = t
                t.start()
            elif state["write"]:
                with self._partial_lock:
                    rb = self._partial_rebuilds.get(vid)
                    if rb is None or rb["targets"] != targets:
                        return Response(
                            {"error": "start_failed",
                             "detail": "no matching rebuild state",
                             "failed_hop_server": me}, 409)
            with self._stream_lock:
                old = self._partial_streams.pop(sid, None)
                self._partial_streams[sid] = state
                swept = self._sweep_streams_locked()
            if old is not None:
                self._teardown_stream(old)
            for st in swept:
                self._teardown_stream(st)
            return Response({"ok": True, "session": sid})

        @svc.route("POST", r"/admin/ec/partial/stream/chunk")
        def ec_partial_stream_chunk(req: Request) -> Response:
            me = self.node_id
            q = req.query
            sid = q.get("session", "")
            with self._stream_lock:
                state = self._partial_streams.get(sid)
            if state is None:
                return Response(
                    {"error": "unknown stream session",
                     "failed_hop_server": me}, 404)
            vid = state["volume"]
            seq = int(q["seq"])
            offset = int(q["offset"])
            size = int(q["size"])
            if size <= 0 or offset < 0:
                return Response({"error": "bad offset/size",
                                 "failed_hop_server": me,
                                 "chunk": seq}, 400)
            _FP_PARTIAL.hit(key=me)
            state["touched"] = time.time()
            if state["error"] is not None:
                return Response(dict(state["error"]), 502)
            targets = state["targets"]
            body = req.body
            partial = None
            if body:
                if len(body) != len(targets) * size:
                    return Response(
                        {"error": "partial size mismatch",
                         "failed_hop_server": me, "chunk": seq}, 409)
                want = req.headers.get("X-Repair-Crc")
                if want is not None and int(want) != crc_mod.crc32c(body):
                    ec_decoder.REPAIR.inc("stream_chunks", "crc_failed")
                    return Response(
                        {"error": "chunk_crc", "failed_hop_server": me,
                         "chunk": seq}, 409)
                state["received"] += len(body)
                ec_decoder.REPAIR.inc("bytes_on_wire", "pipelined", len(body))
                partial = np.frombuffer(body, dtype=np.uint8) \
                    .reshape(len(targets), size).copy()
            try:
                contrib, local_read = self._scale_local_shards(
                    vid, state["coefs"], targets, offset, size, me)
            except _PartialError as e:
                return Response({**e.payload, "chunk": seq}, e.status)
            state["read"] += local_read
            if contrib is not None:
                partial = contrib if partial is None \
                    else ec_decoder.xor_partials(partial, contrib)
            if partial is None:
                partial = np.zeros((len(targets), size), dtype=np.uint8)
            if state["queue"] is not None:
                payload = np.ascontiguousarray(partial).tobytes()
                try:
                    state["queue"].put((seq, offset, size, payload),
                                       timeout=state["stall_timeout"])
                except queue.Full:
                    ec_decoder.REPAIR.inc("stream_chunks", "stalled")
                    state["error"] = {
                        "error": "stream_stall",
                        "failed_hop_server":
                            state["downstream"][0].get("server", ""),
                        "chunk": seq,
                    }
                    return Response(dict(state["error"]), 503)
                return Response({"ok": True, "chunk": seq})
            # chain terminal: land the chunk at the committed frontier
            with self._partial_lock:
                rb = self._partial_rebuilds.get(vid)
                if rb is None or rb["targets"] != targets:
                    return Response(
                        {"error": "start_failed",
                         "detail": "no matching rebuild state",
                         "failed_hop_server": me, "chunk": seq}, 409)
                committed = rb["committed"]
                if offset + size <= committed:
                    # duplicate delivery: the upstream forwarder's retry
                    # re-sent a chunk whose ACK was lost. The write already
                    # landed — ACK it again instead of failing the session
                    # (a 409 would get the healthy writer excluded)
                    return Response({"ok": True, "chunk": seq,
                                     "committed": committed,
                                     "duplicate": True})
                if offset != committed:
                    return Response(
                        {"error": f"chunk out of order (offset {offset},"
                                  f" committed {committed})",
                         "failed_hop_server": me, "chunk": seq}, 409)
                for i, t in enumerate(targets):
                    rb["writers"].pwrite(t, partial[i], offset)
                rb["committed"] = offset + size
            ec_decoder.REPAIR.inc("stream_chunks", "written")
            return Response({"ok": True, "chunk": seq,
                             "committed": offset + size})

        @svc.route("POST", r"/admin/ec/partial/stream/close")
        def ec_partial_stream_close(req: Request) -> Response:
            """Flush-and-report: drain this hop's forward queue, cascade
            the close downstream, and return per-hop received/read byte
            lists (chain order) plus the terminal's committed frontier.
            The payload carries `ok` and, on failure, the attributed error
            so the orchestrator's ladder can resume from `committed`."""
            me = self.node_id
            sid = req.query.get("session", "")
            with self._stream_lock:
                state = self._partial_streams.pop(sid, None)
            if state is None:
                return Response(
                    {"error": "unknown stream session",
                     "failed_hop_server": me}, 404)
            if state["queue"] is not None:
                self._teardown_stream(state)  # drains in order, then joins
            out: dict = {
                "ok": True,
                "received": [state["received"]],
                "read": [state["read"]],
                "committed": None,
            }
            if state["downstream"]:
                nxt = state["downstream"][0]
                try:
                    status, _, body = http_request(
                        "POST",
                        nxt["url"]
                        + f"/admin/ec/partial/stream/close?session={sid}",
                        b"", timeout=120,
                    )
                    down = json.loads(body) if body else {}
                except (IOError, OSError, ValueError) as e:
                    down = {"error": "hop_unreachable",
                            "failed_hop_server": nxt.get("server", ""),
                            "detail": str(e)[:200]}
                out["received"] += down.get("received", [])
                out["read"] += down.get("read", [])
                out["committed"] = down.get("committed")
                if (down.get("error") or not down.get("ok", True)) \
                        and state["error"] is None:
                    state["error"] = {
                        k: down[k]
                        for k in ("error", "failed_hop_server", "chunk",
                                  "detail")
                        if k in down
                    }
            else:
                with self._partial_lock:
                    rb = self._partial_rebuilds.get(state["volume"])
                    out["committed"] = None if rb is None else rb["committed"]
            if state["error"] is not None:
                out.update(state["error"])
                out["ok"] = False
            return Response(out)

    # --- handlers -------------------------------------------------------------
    def _parse_fid(self, req: Request) -> tuple[int, int, int]:
        vid = int(req.match.group(1))
        key, cookie = parse_key_hash_with_delta(req.match.group(2))
        return vid, key, cookie

    def _file_jwt_ok(self, req: Request, key: str, fid: str) -> bool:
        """One fid-bound token check for reads and writes
        (`volume_server_handlers.go:33-75` maybeCheckJwtAuthorization): the
        multi-count `_N` suffix and any `.ext` are stripped, since the
        master signed the base fid."""
        if not key:
            return True
        base = fid.split("_")[0].split(".")[0]
        token = token_from_request(req.headers, req.query)
        return verify_file_jwt(key, token, base)

    def _check_read_jwt(self, req: Request) -> bool:
        fid = f"{req.match.group(1)},{req.match.group(2)}"
        return self._file_jwt_ok(req, self.security.read_key, fid)

    def _check_write_jwt(self, req: Request) -> bool:
        fid = f"{req.match.group(1)},{req.match.group(2)}"
        return self._file_jwt_ok(req, self.security.write_key, fid)

    def _do_read(self, req: Request, head: bool) -> Response:
        try:
            vid, key, cookie = self._parse_fid(req)
        except ValueError as e:
            return Response({"error": str(e)}, 400)
        if not self._check_read_jwt(req):
            return Response({"error": "unauthorized"}, 401)
        try:
            n = self.store.read(vid, key, cookie=cookie)
        except NotFound:
            return Response(b"", 404)
        except VolumeError as e:
            return Response({"error": str(e)}, 404)
        headers = {"ETag": f'"{n.etag()}"', "Accept-Ranges": "bytes"}
        mime = n.mime.decode() if n.has_mime() and n.mime else "application/octet-stream"
        if n.has_name() and n.name:
            headers["Content-Disposition"] = (
                f'inline; filename="{urllib.parse.quote(n.name.decode("utf-8", "replace"))}"'
            )
        if n.is_compressed():
            headers["Content-Encoding"] = "gzip"
        data = n.data
        # on-read resize/crop hook (`volume_server_handlers_read.go:310-370`)
        if not n.is_compressed() and (
            "width" in req.query or "height" in req.query
        ):
            from ..images import RESIZABLE_MIME, resized

            guessed = mime
            if guessed == "application/octet-stream" and n.has_name() and n.name:
                ext = n.name.decode("utf-8", "replace").rsplit(".", 1)[-1].lower()
                guessed = {"jpg": "image/jpeg", "jpeg": "image/jpeg",
                           "png": "image/png", "gif": "image/gif",
                           "webp": "image/webp"}.get(ext, guessed)
            if guessed in RESIZABLE_MIME:
                def _int(qk):
                    try:
                        return int(req.query.get(qk, "") or 0) or None
                    except ValueError:
                        return None

                data = resized(data, guessed, _int("width"), _int("height"),
                               req.query.get("mode", ""))
                mime = guessed
        rng = req.headers.get("Range")
        status = 200
        if rng and rng.startswith("bytes=") and "," not in rng:
            # RFC 7233: an unintelligible Range is ignored (200 full body)
            try:
                spec = rng[6:]
                if "-" not in spec:
                    raise ValueError(rng)
                start_s, _, end_s = spec.partition("-")
                if (start_s and not (start_s.isascii() and start_s.isdigit())) or \
                        (end_s and not (end_s.isascii() and end_s.isdigit())):
                    raise ValueError(rng)
                start = (int(start_s) if start_s
                         else max(0, len(data) - int(end_s)))
                end = int(end_s) if end_s and start_s else len(data) - 1
            except ValueError:
                start, end = 0, -1  # ignore the malformed header
            end = min(end, len(data) - 1)
            if 0 <= start <= end:
                headers["Content-Range"] = f"bytes {start}-{end}/{len(data)}"
                data = data[start : end + 1]
                status = 206
        if head:
            headers["Content-Length-Hint"] = str(len(data))
            return Response(b"", status, headers, content_type=mime)
        return Response(data, status, headers, content_type=mime)

    def _do_write(self, req: Request) -> Response:
        try:
            vid, key, cookie = self._parse_fid(req)
        except ValueError as e:
            return Response({"error": str(e)}, 400)
        if not self._check_write_jwt(req):
            return Response({"error": "unauthorized"}, 401)
        is_replicate = req.query.get("type") == "replicate"
        body = req.body
        part = req.multipart_file()
        if part is not None:
            filename, mime, data = part
        else:
            data = body
            filename = req.headers.get("X-File-Name", "")
            mime = req.headers.get("Content-Type", "")
            if mime in ("application/json", "application/x-www-form-urlencoded"):
                mime = ""
        # EXIF orientation fix on upload (`needle.go:101-106`: .jpg only;
        # a replica stores the bytes its primary was sent)
        is_jpg = (
            mime == "image/jpeg"
            or filename.lower().endswith((".jpg", ".jpeg"))
        )
        if is_jpg and not is_replicate:
            from ..images import fix_jpg_orientation

            data = fix_jpg_orientation(data)
        n = Needle(cookie=cookie, id=key, data=data)
        if filename:
            n.name = filename.encode()
            n.set_has_name()
        if mime and len(mime) < 256 and mime != "application/octet-stream":
            n.mime = mime.encode()
            n.set_has_mime()
        ttl_s = req.query.get("ttl", "")
        if ttl_s:
            n.ttl = TTL.parse(ttl_s)
            n.set_has_ttl()
        n.last_modified = int(time.time())
        n.set_has_last_modified()
        try:
            self.store.write(vid, n, check_cookie=not is_replicate)
        except VolumeError as e:
            return Response({"error": str(e)}, 500)
        if not is_replicate:
            v = self.store.get_volume(vid)
            if v is not None and v.online_ec is not None \
                    and v.online_ec.active:
                # parity-only durability: the ack rides on local .dat
                # durability + the streamed parity emit — no replica
                # fan-out (write amplification 1.4x instead of 2.0x)
                v.online_ec.pump()
                if v.size() >= self.volume_size_limit:
                    self.heartbeat_once()
                return Response(
                    {"name": filename, "size": len(data), "eTag": n.etag()},
                    201,
                )
            rp = v.super_block.replica_placement if v else None
            if rp and rp.copy_count() > 1:
                try:
                    extra = {"ttl": ttl_s} if ttl_s else {}
                    self._replicate(
                        "POST", vid, req.match.group(2), body,
                        {
                            "Content-Type": req.headers.get("Content-Type", ""),
                            "X-File-Name": req.headers.get("X-File-Name", ""),
                            # replicas verify the same master-signed token
                            "Authorization": req.headers.get("Authorization", ""),
                        },
                        extra_query=extra,
                    )
                except VolumeError as e:
                    return Response({"error": str(e)}, 500)
            if v and v.size() >= self.volume_size_limit:
                self.heartbeat_once()  # tell the master it's full
        return Response(
            {"name": filename, "size": len(data), "eTag": n.etag()}, 201
        )

    def _do_delete(self, req: Request) -> Response:
        try:
            vid, key, cookie = self._parse_fid(req)
        except ValueError as e:
            return Response({"error": str(e)}, 400)
        if not self._check_write_jwt(req):
            return Response({"error": "unauthorized"}, 401)
        is_replicate = req.query.get("type") == "replicate"
        n = Needle(cookie=cookie, id=key)
        try:
            freed = self.store.delete(vid, n)
        except VolumeError as e:
            return Response({"error": str(e)}, 500)
        if not is_replicate:
            v = self.store.get_volume(vid)
            if v is not None and v.online_ec is not None \
                    and v.online_ec.active:
                v.online_ec.pump()  # the tombstone append rides the stripe
            else:
                rp = v.super_block.replica_placement if v else None
                if rp and rp.copy_count() > 1:
                    try:
                        self._replicate(
                            "DELETE", vid, req.match.group(2), b"",
                            {"Authorization": req.headers.get("Authorization", "")})
                    except VolumeError as e:
                        return Response({"error": str(e)}, 500)
        return Response({"size": freed}, 202)
