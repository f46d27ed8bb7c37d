"""Volume server, EC surface: the port's partial copy of
`seaweedfs_tpu/server/volume.py`.

Reference: `weed/server/volume_server_handlers_read.go:45` /
`_write.go:18` (GET/POST/DELETE /<vid>,<fid>), `volume_grpc_erasure_coding.go`
(EC verbs — JSON admin endpoints here), `volume_grpc_client_to_master.go:50`
(heartbeat).

Routes: the needle routes (GET/HEAD/POST/PUT/DELETE on `FID_RE`), `/status`,
`/admin/allocate_volume` (with `ecOnline` and `ecOnlineBlock`),
`/admin/volume/readonly`, the copy stream `/admin/volume/raw`, and the EC
verbs `/admin/ec/{generate,mount,unmount,rebuild,online/rebuild,
delete_volume,to_volume,shard,copy,delete_shards}` that the shell's
`ec.*` commands drive. Every mounted EC volume gets a remote shard
fetcher: the master's `/dir/ec_lookup` (cached 10 s), then
`/admin/ec/shard` range reads off the other holders, so a read of a
shard this server lacks goes remote before it reconstructs. Writes and
deletes on an online-EC volume pump its stripe writer, and a pulse loop
pumps every `pulse_seconds` so the timed trickle flush fires between
writes; it also posts the heartbeat when a `master_url` is given (with
none, nothing is posted).

The server has one device, `cuda` unless the caller passes `device="cpu"`
(with neither nor CUDA, construction raises): the online writers'
parity, degraded reads, and `/admin/ec/rebuild` run there.

Not ported: the native fastlane, JWT, peer replication (a write to a
volume whose placement needs replicas is refused), EXIF and image
resizing, the partial and streaming rebuild plane (with its partial
fan-in), scrub, tiering, vacuum and the volume copy verbs, `/query`,
metrics, traces, events, fault points and the retry policy of the copy
stream (a failed range fails the copy).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse

from ..ops.rs_kernel import RSCodec, resolve_device
from ..storage.erasure_coding import decoder as ec_decoder
from ..storage.erasure_coding import encoder as ec_encoder
from ..storage.erasure_coding import geometry
from ..storage.erasure_coding.ec_volume import ec_shard_file_name
from ..storage.file_id import parse_key_hash_with_delta
from ..storage.needle import Needle
from ..storage.store import Store
from ..storage.super_block import SUPER_BLOCK_SIZE
from ..storage.types import TTL
from ..storage.volume import NotFound, VolumeError, volume_file_name
from .httpd import HTTPService, Request, Response, get_json, http_request, peer_url

FID_RE = r"/(\d+),([0-9a-fA-F_]+)(?:\.[^/]*)?"
_SAFE_EXT_RE = re.compile(r"\.(dat|idx|vif|ecx|ecj|ec\d\d)")


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
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        # -mserver may list several masters; heartbeats follow the raft
        # leader hint (`volume_grpc_client_to_master.go` re-dial on redirect)
        self.master_urls = [
            peer_url(u).rstrip("/") for u in master_url.split(",") if u
        ]
        self.master_url = self.master_urls[0] if self.master_urls else ""
        self.service = HTTPService(host, port)
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
        self.heartbeat_once()
        self._pulse = threading.Thread(
            target=self._pulse_loop, name="volume-pulse", daemon=True
        )
        self._pulse.start()

    def stop(self) -> None:  # idempotent: fixtures may stop twice
        self._stop.set()
        self.service.stop()
        if self._pulse is not None:
            self._pulse.join()
            self._pulse = None
        if self.store:
            self.store.close()
            self.store = None

    @property
    def url(self) -> str:
        return self.service.url

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
            self.heartbeat_once()

    def heartbeat_once(self) -> None:
        """One heartbeat POST to the master (none without a master_url)."""
        if not self.master_urls or self.store is None:
            return
        with self._hb_lock:
            self._heartbeat_locked()

    def _heartbeat_locked(self) -> None:
        hb = self.store.collect_heartbeat()
        hb["data_center"] = self.data_center
        hb["rack"] = self.rack
        hb["max_volume_count"] = self.max_volume_count
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

    def _attach_shard_fetcher(self, ev) -> None:
        """Give an EcVolume remote shard sourcing: master ec_lookup for
        locations, then /admin/ec/shard range reads off sibling servers
        (`store_ec.go:281` readRemoteEcShardInterval)."""
        me = f"{self._host}:{self.service.port}"
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

        ev.shard_fetcher = fetch

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
            ec_online = bool(p.get("ecOnline", False))
            replication = p.get("replication", "000")
            if not ec_online and sum(int(c) for c in replication[:3]) > 0:
                return Response(
                    {"error": "peer replication is not ported"}, 400)
            self.store.add_volume(
                int(p["volume"]),
                p.get("collection", ""),
                replication,
                p.get("ttl", ""),
                ec_online=ec_online,
                ec_online_block=(
                    int(p["ecOnlineBlock"]) if p.get("ecOnlineBlock") else None
                ),
            )
            return Response({"ok": True})

        @svc.route("POST", r"/admin/volume/readonly")
        def readonly(req: Request) -> Response:
            p = req.json()
            self.store.mark_readonly(int(p["volume"]), bool(p.get("readonly", True)))
            return Response({"ok": True})

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

    # --- handlers -------------------------------------------------------------
    def _parse_fid(self, req: Request) -> tuple[int, int, int]:
        vid = int(req.match.group(1))
        key, cookie = parse_key_hash_with_delta(req.match.group(2))
        return vid, key, cookie

    def _needs_replicas(self, vid: int) -> bool:
        """A classic volume whose placement asks for copies elsewhere: the
        port cannot fan a write out, so it refuses the write."""
        v = self.store.get_volume(vid)
        if v is None or (v.online_ec is not None and v.online_ec.active):
            return False
        return v.super_block.replica_placement.copy_count() > 1

    def _do_read(self, req: Request, head: bool) -> Response:
        try:
            vid, key, cookie = self._parse_fid(req)
        except ValueError as e:
            return Response({"error": str(e)}, 400)
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
        is_replicate = req.query.get("type") == "replicate"
        if not is_replicate and self._needs_replicas(vid):
            return Response({"error": "peer replication is not ported"}, 500)
        part = req.multipart_file()
        if part is not None:
            filename, mime, data = part
        else:
            data = req.body
            filename = req.headers.get("X-File-Name", "")
            mime = req.headers.get("Content-Type", "")
            if mime in ("application/json", "application/x-www-form-urlencoded"):
                mime = ""
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
        v = self.store.get_volume(vid)
        if not is_replicate and v is not None and v.online_ec is not None \
                and v.online_ec.active:
            # parity-only durability: the ack rides on local .dat
            # durability + the streamed parity emit
            v.online_ec.pump()
        if v is not None and v.size() >= self.volume_size_limit:
            self.heartbeat_once()  # tell the master it's full
        return Response(
            {"name": filename, "size": len(data), "eTag": n.etag()}, 201
        )

    def _do_delete(self, req: Request) -> Response:
        try:
            vid, key, cookie = self._parse_fid(req)
        except ValueError as e:
            return Response({"error": str(e)}, 400)
        is_replicate = req.query.get("type") == "replicate"
        if not is_replicate and self._needs_replicas(vid):
            return Response({"error": "peer replication is not ported"}, 500)
        n = Needle(cookie=cookie, id=key)
        try:
            freed = self.store.delete(vid, n)
        except VolumeError as e:
            return Response({"error": str(e)}, 500)
        v = self.store.get_volume(vid)
        if not is_replicate and v is not None and v.online_ec is not None \
                and v.online_ec.active:
            v.online_ec.pump()  # the tombstone append rides the stripe
        return Response({"size": freed}, 202)
