"""Filer HTTP server: upload pipeline with auto-chunking + MD5 tee, streamed
ranged reads via visible intervals, directory listings, recursive delete.
The port's copy of the core of `seaweedfs_tpu/server/filer.py`.

Reference: `weed/server/filer_server_handlers_write_autochunk.go:26-155`,
`_write_upload.go:30-141` (chunk fan-out + whole-stream MD5),
`_read.go:91` (ranged streaming), `filer/stream.go:153`.

Write path (`_do_write`): `mv.from`, `link.from`, `meta.entry`, mkdir,
multipart, the `fs.configure` rule of the path (`filer/filer_conf.py`),
TTL, inline content of 2 KiB or less, and larger bodies cut into
`chunk_size` chunks (`_upload_chunks_plain`: one batched assign for a
multi-chunk upload, each chunk maybe-compressed and, with `cipher=True`,
AES-GCM encrypted, POSTed to its volume server through
`filer/wdclient.py`), over 1,000 chunks stored as manifests; an
overwritten version's chunks are reclaimed, except blobs the dedup index
owns (`_dedup_managed`). Read path (`_do_read`): `?metadata=true`, lazy
TTL reaping, the ETag and 304, Range (206, 416), HEAD, directory
listings (JSON and HTML); compressed and ciphered chunks are fetched whole
through the tiered chunk cache and sliced.

Hashing runs on the server's device, through its own `HashService`
(`self.hash_service`, started and stopped with the server): every chunk's
ETag goes through `submit_many`, whose buckets the batch kernels
(`md5_batch`, `crc32c_batch`) hash on cuda; inline content goes through
`submit`, whose lone blob on an idle service hashes on the host, as in the
JAX package. The filer's service takes `min_batch=1`, so a bucket of any
size goes to the kernels: every chunk ETag is counted in
`hash_service.batch_blobs`. The whole-stream MD5 tee stays a sequential
host hash. With `dedup=True` uploads take the content-defined dedup path
(`_upload_chunks_cdc`, the `gear_hash` kernel on the server's device).

The server's device is cuda unless the caller passes `device="cpu"`; with
neither it raises. `filer=` and `client=` (keyword-only) inject a `Filer`
and a client with `WeedClient`'s `upload` / `upload_to` / `assign_batch` /
`fetch` / `delete` / `lookup` in place of the store and master client;
`notification_queue=` (anything with `send_message(key, message)`) is the
filer's external event bus, and `peers=` the other filers of its lock ring.

Control routes: `/__meta__/events` (the long-poll metadata feed a
`filer/meta_aggregator.MetaSubscriber` reads), `/__meta__/notify`,
`/__meta__/change_volume_id` and `/__meta__/merge_volumes` (the `fs.meta.*`
and `fs.merge.volumes` rewrites), `/__dedup__/stats` and `/__dedup__/gc`
(`dedup_gc`, the dedup index's reclaim), and `/__dlm__/{lock,unlock,status}`
(the distributed lock manager of `cluster/`, keys placed on the filers of
`lock_ring`). `start()` announces the filer to the master
(`/cluster/register`, then every 5 s, sweeping expired locks).

`faults_spec` is the `-faults` flag (see `util/faults.opt_in`), and
`local_socket` the `-filer.localSocket` flag: `start()` adds a unix-socket
listener there (`service.unix_url`), how a mount reaches its filer.

Remote storage mounts (`remote_storage/`): `/__remote__/configure`,
`mount`, `mount_buckets`, `unmount`, `mounts`, `meta_sync`, `cache` and
`uncache` keep the configs and mounts in `/etc/remote/remote.conf` and
`/etc/remote/remote.mount` (loaded at construction), make stub entries
that carry `remote.*` extended attributes and no chunks, and cache a stub's
object into chunks (or inline content) on its first GET, a failed fetch
answering 502.

Security (`security/`): `security=` hands the write and read keys to the
filer's `WeedClient` (chunk uploads carry the assign's write token, chunk
fetches a read token the filer signs, deletes a wildcard write token) and
`white_list` puts a `Guard` on the service.

Observability (`stats/`): the service is metered as role "filer" without
a `/metrics` route on its own port, since any path there may be a file;
`metrics_port` (`-metricsPort`: -1 an ephemeral port, 0 none, above 0
that port) serves `/metrics` and the debug routes on a `MetricsService`
(`metrics_url`). `slow_ms` is its `-slowMs` span threshold. Uploads record
`filer.upload_chunks` (or `filer.upload_chunks_cdc`) spans, and its hash
service feeds `SeaweedFS_filer_hash_seconds` under the port's kernel
labels.

Tenants and QoS (`stats/usage.py`, `qos/`): every GET, HEAD, POST, PUT and
DELETE on the namespace passes QoS admission before any bytes move (a shed
is a typed 429/503 with Retry-After and `X-Sw-Qos-Reason`; unarmed, the
check is one attribute load) and is then recorded in the process's usage
accountant under its collection. `qos_limits` (`-qos.limits`, e.g.
`'a=100,b=50:200,*=25'`) arms admission and starts the burn actuator, which
reads the master's cluster telemetry. `telemetry_dir` (`-telemetry.dir`)
turns on the durable spool, and a telemetry frame rides every
registration beat.

Not ported: the native fastlane front door (`_fl_*`, and with it the
`lease_churn` and `fallback_fastlane` events, the fid-lease sharding by
the gateway ordinal of the registration's answer, and the fastlane's qos
charge on the beat; ROADMAP 10a-3).
"""

from __future__ import annotations

import base64
import copy
import hashlib
import json
import logging
import os
import threading
import time
import urllib.parse
from xml.sax.saxutils import escape as _esc
from xml.sax.saxutils import quoteattr as _qa

from ..cluster import DistributedLockManager, LockedError, LockRing
from ..filer import Attributes, Entry, FileChunk, Filer
from ..filer.dedup import DEDUP_DIR, DedupIndex
from ..filer.filechunks import maybe_manifestize, resolve_chunk_manifest, view_from_chunks
from ..filer.filer import FilerError, normalize
from ..filer.filer_conf import FILER_CONF_PATH, FilerConf
from ..filer.filerstore import make_store
from ..filer.wdclient import WeedClient
from ..ops import cdc
from ..qos import actuator as qos_act
from ..qos import admission as qos_mod
from ..stats import aggregate as agg_mod
from ..stats import store as store_mod
from ..stats import trace
from ..stats import usage as usage_mod
from ..remote_storage import (
    CONF_FILE,
    MOUNT_FILE,
    REMOTE_KEY,
    REMOTE_MTIME,
    REMOTE_SIZE,
    REMOTE_STORAGE,
    make_remote_client,
)
from ..ops.hash_service import HashService
from ..security import Guard, SecurityConfig
from ..ops.rs_kernel import resolve_device
from ..storage.types import TTL
from ..util import cipher as cipher_util
from ..util import faults
from ..util.chunk_cache import TieredChunkCache
from ..util.compression import decompress_data, maybe_compress_data
from .httpd import HTTPService, MetricsService, Request, Response, http_request, peer_url

SMALL_CONTENT_LIMIT = 2 * 1024  # inline small files in the entry

log = logging.getLogger(__name__)


class FilerServer:
    def __init__(
        self,
        master_url: str = "",
        host: str = "127.0.0.1",
        port: int = 8888,
        store_kind: str = "memory",
        store_path: str | None = None,
        chunk_size_mb: int = 4,
        default_replication: str = "",
        collection: str = "",
        cipher: bool = False,
        compress: bool = True,
        chunk_cache_dir: str | None = None,
        dedup: bool = False,
        dedup_avg_bits: int = 16,
        dedup_min: int = 16 * 1024,
        dedup_max: int = 512 * 1024,
        device=None,
        faults_spec: str | None = None,
        local_socket: str | None = None,
        *,
        filer: Filer | None = None,
        client=None,
        notification_queue=None,
        peers: list[str] | None = None,
        security: SecurityConfig | None = None,
        metrics_port: int = -1,
        slow_ms: float | None = None,
        telemetry_dir: str | None = None,
        telemetry_retention_mb: float | None = None,
        qos_limits: str | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.security = security or SecurityConfig()
        faults.opt_in(faults_spec)  # the -faults flag
        # -encryptVolumeData / compression defaults (`weed/command/filer.go`)
        if cipher and not cipher_util.available():
            # fail at boot, not with a 500 on the first write
            raise RuntimeError(
                "-encryptVolumeData needs the 'cryptography' package,"
                " which is not installed"
            )
        if client is None:
            if not master_url:
                raise ValueError("FilerServer needs a master_url or a client")
            client = WeedClient(master_url, jwt_key=self.security.write_key,
                                read_jwt_key=self.security.read_key)
        self.filer = filer if filer is not None else Filer(make_store(store_kind, store_path))
        if notification_queue is not None:
            self.filer.notification_queue = notification_queue
        self.client = client
        self.chunk_size = chunk_size_mb * 1024 * 1024
        self.default_replication = default_replication
        self.collection = collection
        self.service = HTTPService(host, port)
        if self.security.white_list:
            self.service.guard = Guard(self.security.white_list)
        # the filer's namespace is a catch-all (any path may be a file, incl.
        # /metrics), so metrics get their own listener (`-metricsPort`)
        self.service.enable_metrics("filer", serve_route=False)
        # -telemetry.dir: durable history/event spool (stats/store.py)
        if telemetry_dir:
            store_mod.enable(telemetry_dir, telemetry_retention_mb)
        if slow_ms is not None:  # -slowMs: the role's slow-span threshold
            trace.set_slow_threshold_ms(slow_ms, role="filer")
        # -qos.limits: arm admission control (qos/) + the burn actuator;
        # without the flag the per-request check is one attribute read
        if qos_limits is not None:
            limits, default = qos_mod.parse_limits_spec(qos_limits)
            qos_mod.controller().set_limits(limits=limits, default=default)
            qos_mod.enable()
            master = getattr(client, "master_url", "")
            qos_act.start(master_url=master or None)
        self.metrics_service = (
            MetricsService(host, max(metrics_port, 0)) if metrics_port != 0 else None
        )
        self.cipher = cipher
        self.compress = compress
        # the server's own batch hash service, on its device: chunk ETags
        # (submit_many) and inline content (submit); min_batch=1 sends a
        # bucket of any size to the kernels
        self.hash_service = HashService(device=self.device, min_batch=1)
        self._count_mu = threading.Lock()
        self.assign_batch_fallbacks = 0  # multi-chunk uploads assigned per chunk
        # CDC dedup (filer/dedup.py): content-defined chunking + hash index.
        # Mutually exclusive with cipher — random per-chunk AES keys make
        # equal plaintexts distinct, and convergent encryption leaks equality.
        self.dedup = dedup and not cipher
        if self.dedup:
            self.dedup_index = DedupIndex(self.filer)
            self.dedup_avg_bits = dedup_avg_bits
            self.dedup_min = dedup_min
            self.dedup_max = dedup_max
            # gc-vs-upload coordination (see dedup_gc): hits
            # record the fid under this lock; gc condemns keys under the
            # same lock, so every hit either lands before the gc decision
            # (gc skips the fid) or sees the key condemned (upload treats
            # it as a miss).
            self._dedup_mu = threading.Lock()
            self._dedup_recent: dict[str, float] = {}
            self._dedup_condemned: set[str] = set()
        self.chunk_cache = TieredChunkCache(disk_dir=chunk_cache_dir)
        # distributed lock manager hosted on the filer group (weed/cluster)
        self.lock_ring = LockRing()
        self.dlm = DistributedLockManager()
        self._static_peers = list(peers or [])
        # remote-storage mounts (weed/remote_storage): configs + dir mounts
        self._remote_confs: dict = {}
        self._remote_mounts: dict = {}
        self._load_remote_state()
        # `-filer.localSocket` (weed/command/filer.go): same-host clients
        # (mounts) reach the filer over a unix domain socket
        self.local_socket = local_socket
        self._register_stop = threading.Event()
        self._register_thread: threading.Thread | None = None
        # per-path storage rules (`weed/filer/filer_conf.go`): loaded from
        # /etc/seaweedfs/filer.conf, hot-reloaded via the meta-log
        conf_entry = self.filer.find_entry(FILER_CONF_PATH)
        self.filer_conf = FilerConf.from_bytes(
            bytes(conf_entry.content) if conf_entry else b"")
        self.filer.subscribe(self._conf_on_meta)
        self._routes()

    def _conf_on_meta(self, ev) -> None:
        """Hot-reload /etc/seaweedfs/filer.conf on any mutation of it."""
        target = ev.new_entry or ev.old_entry
        if target is None or target.full_path != FILER_CONF_PATH:
            return
        if ev.new_entry is not None and not ev.new_entry.content and \
                ev.new_entry.chunks:
            # chunk-backed conf (written by an old build): refusing to
            # parse b"" keeps the PREVIOUS rules instead of silently
            # dropping enforcement
            log.warning("filer.conf is chunk-backed; keeping previous"
                        " rules (rewrite it to inline)")
            return
        content = ev.new_entry.content if ev.new_entry else b""
        self.filer_conf = FilerConf.from_bytes(bytes(content))

    def start(self) -> None:
        # the flusher thread must run, or submit_many hashes on the host
        self.hash_service.start()
        self.service.start()
        if self.metrics_service is not None:
            self.metrics_service.start()
        if self.local_socket:
            self.service.enable_unix_socket(self.local_socket)
        self.dlm.host = self.url
        self.lock_ring.set_servers(self._static_peers + [self.url])
        self._register_once()
        self._register_thread = threading.Thread(
            target=self._register_loop, daemon=True)
        self._register_thread.start()

    def _register_once(self) -> None:
        """Announce to the master's cluster membership (`cluster.go` rides
        KeepConnected; here the equivalent periodic POST). A master that is
        not up yet is retried by the loop. The cluster telemetry frame
        rides the beat, as it rides the volume heartbeat: no extra
        connection."""
        master_url = getattr(self.client, "master_url", "")
        if not master_url:
            return
        payload = {"type": "filer", "address": self.url}
        try:
            payload["telemetry"] = agg_mod.build_frame(
                "filer", self.url, interval=5.0)
        except Exception:  # a frame must never stop the registration
            pass
        try:
            http_request(
                "POST", master_url + "/cluster/register",
                body=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"}, timeout=5,
            )
        except OSError as e:
            log.debug("filer registration with %s failed: %s", master_url, e)

    def _register_loop(self) -> None:
        while not self._register_stop.wait(5.0):
            self._register_once()
            self.dlm.sweep()

    def stop(self) -> None:
        self._register_stop.set()
        if self._register_thread is not None:
            self._register_thread.join(timeout=10)
        self.service.stop()
        if self.metrics_service is not None:
            self.metrics_service.stop()
        self.hash_service.stop()
        close = getattr(self.client, "close", None)
        if close is not None:
            close()
        self.filer.close()

    @property
    def url(self) -> str:
        return self.service.url

    @property
    def metrics_url(self) -> str | None:
        """The `-metricsPort` listener's URL (None when it is off)."""
        return self.metrics_service.url if self.metrics_service else None

    # --- upload pipeline --------------------------------------------------------
    def _upload_chunks(
        self, data: bytes, ttl: str, collection: str, replication: str,
        mime: str = "", filename: str = "",
    ) -> tuple[list[FileChunk], str]:
        """Split into chunks, upload each, tee a whole-stream MD5
        (`filer_server_handlers_write_upload.go:30`). Each chunk is
        independently maybe-compressed (mime heuristic) and AES-GCM
        encrypted when the filer runs ciphered (`upload_content.go`)."""
        if self.dedup:
            with trace.span("filer.upload_chunks_cdc", role="filer",
                            bytes=len(data)):
                return self._upload_chunks_cdc(
                    data, ttl, collection, replication, mime=mime,
                    filename=filename,
                )
        with trace.span("filer.upload_chunks", role="filer", bytes=len(data)):
            return self._upload_chunks_plain(
                data, ttl, collection, replication, mime=mime,
                filename=filename,
            )

    def _upload_chunks_plain(
        self, data: bytes, ttl: str, collection: str, replication: str,
        mime: str = "", filename: str = "",
    ) -> tuple[list[FileChunk], str]:
        ext = os.path.splitext(filename)[1]
        md5 = hashlib.md5()
        chunks: list[FileChunk] = []
        pieces = [
            data[o : o + self.chunk_size]
            for o in range(0, len(data), self.chunk_size)
        ]
        # per-chunk MD5 via the batch hash service: every chunk of this
        # upload (and of concurrent uploads) coalesces into one batch-kernel
        # call (`upload_content.go` md5 ETag semantics)
        etag_futures = self.hash_service.submit_many(pieces)
        # batched Assign: one master RPC leases fids for EVERY chunk of
        # this upload (base fid + _delta fids on one volume) instead of an
        # assign round-trip per chunk
        batch_fids: list[str] | None = None
        batch_loc = batch_auth = ""
        if len(pieces) > 1:
            try:
                batch_fids, batch_loc, batch_auth = self.client.assign_batch(
                    len(pieces), replication=replication,
                    collection=collection, ttl=ttl,
                )
            except IOError:
                batch_fids = None  # per-chunk assigns still work
                with self._count_mu:
                    self.assign_batch_fallbacks += 1
        offset = 0
        for i, piece in enumerate(pieces):
            md5.update(piece)
            logical_size = len(piece)
            payload, compressed = (
                maybe_compress_data(piece, mime, ext) if self.compress
                else (piece, False)
            )
            key_b64 = ""
            if self.cipher:
                payload, key = cipher_util.encrypt(payload)
                key_b64 = base64.b64encode(key).decode()
            if batch_fids is not None:
                out = self.client.upload_to(
                    batch_fids[i], batch_loc, payload, ttl=ttl,
                    auth=batch_auth,
                )
                out["fid"] = batch_fids[i]
            else:
                out = self.client.upload(
                    payload, replication=replication, collection=collection,
                    ttl=ttl,
                )
            chunks.append(
                FileChunk(
                    file_id=out["fid"],
                    offset=offset,
                    size=logical_size,
                    modified_ts_ns=time.time_ns(),
                    etag=out.get("eTag", ""),
                    cipher_key=key_b64,
                    is_compressed=compressed,
                )
            )
            offset += logical_size
        for chunk, fut in zip(chunks, etag_futures):
            chunk.etag = fut.md5_hex()
        if not data:
            md5.update(b"")
        return chunks, md5.hexdigest()

    def _upload_chunks_cdc(
        self, data: bytes, ttl: str, collection: str, replication: str,
        mime: str = "", filename: str = "",
    ) -> tuple[list[FileChunk], str]:
        """Dedup write path (filer/dedup.py, BASELINE config 4): cut at
        content-defined boundaries, key every chunk by its SW128 identity
        hash (span_keys), and upload only the chunks whose (identity, length)
        key is new; known chunks reference the already-stored fileId, reusing
        the MD5 ETag recorded at insert. MD5 runs ONLY over index misses
        (their upload ETags). Boundaries follow content, so shifted or
        partially-edited re-uploads still dedup."""
        ext = os.path.splitext(filename)[1]
        md5 = hashlib.md5()
        md5.update(data)
        cuts = cdc.find_boundaries(
            memoryview(data), avg_bits=self.dedup_avg_bits,
            min_size=self.dedup_min, max_size=self.dedup_max,
            device=self.device,
        )
        hash_svc = self.hash_service
        idx = self.dedup_index
        keys = hash_svc.span_keys(memoryview(data), cuts, seed=idx.seed)
        # pass 1: classify against the index; collect the miss spans.
        # A key repeating WITHIN this upload is a miss only once — later
        # occurrences defer to the first one's insert (sentinel "defer"),
        # preserving intra-upload dedup across the two-pass split.
        DEFER = "defer"
        recs: list[dict | str | None] = []
        miss_ranges: list[tuple[int, int]] = []
        seen_this_upload: set[str] = set()
        prev = 0
        for c, khash in zip(cuts, keys):
            ln = c - prev
            key = f"{khash}-{ln:x}"
            rec = idx.lookup(key)
            if rec is not None:
                # linearize vs gc: record the fid as freshly referenced, or
                # learn the key was condemned this instant and re-upload
                with self._dedup_mu:
                    if key in self._dedup_condemned:
                        rec = None
                    else:
                        self._dedup_recent[rec["fid"]] = time.monotonic()
            if rec is None and key in seen_this_upload:
                rec = DEFER
            recs.append(rec)
            if rec is None:
                miss_ranges.append((prev, ln))
                seen_this_upload.add(key)
            prev = c
        # pass 2: one MD5 batch over ONLY the missed spans (upload ETags)
        miss_md5s = iter(hash_svc.md5_spans(memoryview(data), miss_ranges))
        chunks: list[FileChunk] = []
        offset = 0
        prev = 0
        for c, khash, rec in zip(cuts, keys, recs):
            ln = c - prev
            key = f"{khash}-{ln:x}"
            defer_md5 = None
            if rec is DEFER:
                # repeat of an earlier chunk in this same upload: its
                # first occurrence has inserted by now (or was TTL'd /
                # condemned — then upload this occurrence individually)
                rec = idx.lookup(key)
                if rec is None:
                    defer_md5 = hash_svc.md5_spans(
                        memoryview(data), [(prev, ln)])[0]
            if rec is not None and not isinstance(rec, str):
                idx.hits += 1
                idx.bytes_saved += ln
                chunks.append(
                    FileChunk(
                        file_id=rec["fid"], offset=offset, size=ln,
                        modified_ts_ns=time.time_ns(),
                        etag=rec.get("etag", ""),
                        is_compressed=bool(rec.get("z")),
                    )
                )
            else:
                idx.misses += 1
                etag = defer_md5 if defer_md5 is not None else next(miss_md5s)
                piece = data[prev:c]  # bytes materialized only for uploads
                payload, compressed = (
                    maybe_compress_data(piece, mime, ext) if self.compress
                    else (piece, False)
                )
                out = self.client.upload(
                    payload, replication=replication, collection=collection,
                    ttl=ttl,
                )
                chunks.append(
                    FileChunk(
                        file_id=out["fid"], offset=offset, size=ln,
                        modified_ts_ns=time.time_ns(), etag=etag,
                        is_compressed=compressed,
                    )
                )
                # TTL'd chunks expire under shared references; skip the index
                if not ttl:
                    with self._dedup_mu:
                        self._dedup_condemned.discard(key)
                        self._dedup_recent[out["fid"]] = time.monotonic()
                    # shadow entry keyed by the chunk's MD5: lets
                    # _dedup_managed answer "is this fid
                    # index-owned?" from chunk metadata alone. Shadow FIRST:
                    # its lifetime must cover the primary's, or a crash
                    # window would leave a primary whose blob
                    # overwrite-reclaim no longer recognizes as shared.
                    idx.insert(f"m{etag}-{ln:x}",
                               {"fid": out["fid"], "p": key})
                    idx.insert(key, {"fid": out["fid"], "z": int(compressed),
                                     "etag": etag})
            prev = c
            offset += ln
        return chunks, md5.hexdigest()

    def _save_manifest_blob(self, blob: bytes) -> FileChunk:
        # manifests carry every per-chunk AES key — on a ciphered filer they
        # must be as opaque to volume servers as the data itself
        key_b64 = ""
        if self.cipher:
            blob, key = cipher_util.encrypt(blob)
            key_b64 = base64.b64encode(key).decode()
        out = self.client.upload(blob, collection=self.collection)
        return FileChunk(
            file_id=out["fid"], offset=0, size=len(blob),
            modified_ts_ns=time.time_ns(), cipher_key=key_b64,
        )

    def _fetch_chunk(self, chunk: FileChunk) -> bytes:
        raw = self.client.fetch(chunk.file_id)
        if chunk.cipher_key:
            raw = cipher_util.decrypt(raw, base64.b64decode(chunk.cipher_key))
        return raw

    def _resolved_chunks(self, entry: Entry) -> list[FileChunk]:
        return resolve_chunk_manifest(self._fetch_chunk, entry.chunks)

    # --- remote storage mounts (weed/remote_storage + read_remote.go) -----------
    def _load_remote_state(self) -> None:
        for path, attr in ((CONF_FILE, "_remote_confs"),
                           (MOUNT_FILE, "_remote_mounts")):
            e = self.filer.find_entry(path)
            if e is not None and e.content:
                try:
                    setattr(self, attr, json.loads(e.content))
                except ValueError:
                    pass

    def _save_remote_state(self) -> None:
        for path, value in ((CONF_FILE, self._remote_confs),
                            (MOUNT_FILE, self._remote_mounts)):
            body = json.dumps(value).encode()
            e = self.filer.find_entry(path)
            if e is None:
                e = Entry(full_path=path, content=body)
                e.attributes.file_size = len(body)
                self.filer.create_entry(e)
            else:
                e.content = body
                e.attributes.file_size = len(body)
                self.filer.update_entry(e)

    def _remote_mount_for(self, path: str):
        """Longest mounted prefix covering path -> (mount_dir, mount)."""
        best = None
        for d, mount in self._remote_mounts.items():
            if path == d or path.startswith(d.rstrip("/") + "/"):
                if best is None or len(d) > len(best[0]):
                    best = (d, mount)
        return best

    def _remote_client(self, config_name: str):
        conf = self._remote_confs.get(config_name)
        if conf is None:
            raise FilerError(f"remote config {config_name!r} not found")
        return make_remote_client(conf)

    def _remote_meta_sync(self, mount_dir: str) -> int:
        """Traverse the remote tree and (re)create stub entries carrying
        remote.* extended attrs and no chunks (`remote.mount`/`meta.sync`)."""
        mount = self._remote_mounts[mount_dir]
        client = self._remote_client(mount["config"])
        base = mount.get("path", "")
        n = 0
        for rel, size, mtime in client.traverse(base):
            full = normalize(f"{mount_dir}/{rel}")
            existing = self.filer.find_entry(full)
            key = f"{base.rstrip('/')}/{rel}".lstrip("/") if base else rel
            if existing is not None:
                ext = existing.extended
                if ext.get(REMOTE_KEY) == key and \
                        float(ext.get(REMOTE_MTIME, 0)) >= mtime:
                    continue  # unchanged
                existing.extended.update({
                    REMOTE_KEY: key, REMOTE_SIZE: str(size),
                    REMOTE_MTIME: str(mtime),
                    REMOTE_STORAGE: mount["config"],
                })
                existing.chunks = []  # changed upstream: drop stale cache
                existing.attributes.file_size = size
                self._reclaim_chunks(self.filer.update_entry(existing))
            else:
                e = Entry(full_path=full)
                e.attributes.file_size = size
                e.attributes.mtime = mtime
                e.extended = {
                    REMOTE_KEY: key, REMOTE_SIZE: str(size),
                    REMOTE_MTIME: str(mtime),
                    REMOTE_STORAGE: mount["config"],
                }
                self.filer.create_entry(e)
            n += 1
        return n

    def _remote_cache_entry(self, entry: Entry) -> Entry:
        """Read-through: pull remote bytes into local chunks on first access
        (`read_remote.go` CacheRemoteObjectToLocalCluster)."""
        key = entry.extended.get(REMOTE_KEY)
        config = entry.extended.get(REMOTE_STORAGE)
        if not key or not config:
            return entry
        client = self._remote_client(config)
        data = client.read_file(key)
        if len(data) <= SMALL_CONTENT_LIMIT:
            entry.content = data
            entry.attributes.md5 = self.hash_service.submit(data).md5_hex()
        else:
            chunks, md5_hex = self._upload_chunks(
                data, "", self.collection, self.default_replication,
                mime=entry.attributes.mime, filename=entry.full_path,
            )
            entry.chunks = maybe_manifestize(self._save_manifest_blob, chunks)
            entry.attributes.md5 = md5_hex
        entry.attributes.file_size = len(data)
        self._reclaim_chunks(self.filer.update_entry(entry))
        return entry

    def _register_remote_routes(self, svc) -> None:
        @svc.route("POST", r"/__remote__/configure")
        def remote_configure(req: Request) -> Response:
            p = req.json()
            self._remote_confs[p["name"]] = p["conf"]
            self._save_remote_state()
            return Response({"ok": True, "configs": list(self._remote_confs)})

        @svc.route("POST", r"/__remote__/mount")
        def remote_mount(req: Request) -> Response:
            p = req.json()
            dir_ = normalize(p["dir"])
            if p.get("config") not in self._remote_confs:
                return Response(
                    {"error": f"unknown remote config {p.get('config')!r}"}, 400
                )
            self._remote_mounts[dir_] = {
                "config": p["config"], "path": p.get("path", ""),
            }
            self._save_remote_state()
            try:
                n = self._remote_meta_sync(dir_)
            except (FilerError, OSError, ValueError) as e:
                return Response({"error": str(e)}, 500)
            return Response({"ok": True, "dir": dir_, "synced": n})

        @svc.route("POST", r"/__remote__/mount_buckets")
        def remote_mount_buckets(req: Request) -> Response:
            # `command_remote_mount_buckets.go`: mount every bucket of a
            # configured remote under /buckets/<name> and pull metadata
            p = req.json()
            conf_name = p.get("config")
            conf = self._remote_confs.get(conf_name)
            if conf is None:
                return Response(
                    {"error": f"unknown remote config {conf_name!r}"}, 400)
            try:
                client = make_remote_client(conf)
                buckets = client.list_buckets()
            except (OSError, ValueError, NotImplementedError) as e:
                return Response({"error": f"list buckets: {e}"}, 500)
            mounted = []
            for b in buckets:
                dir_ = f"/buckets/{b}"
                # persist BEFORE syncing (like /__remote__/mount): a
                # partial failure must leave the completed mounts durable,
                # not in-memory-only until a restart drops them
                self._remote_mounts[dir_] = {"config": conf_name, "path": b}
                self._save_remote_state()
                try:
                    self._remote_meta_sync(dir_)
                except (FilerError, OSError, ValueError) as e:
                    return Response(
                        {"error": f"sync {dir_}: {e}", "mounted": mounted},
                        500)
                mounted.append(b)
            return Response({"ok": True, "mounted": mounted})

        @svc.route("POST", r"/__remote__/unmount")
        def remote_unmount(req: Request) -> Response:
            dir_ = normalize(req.json()["dir"])
            if self._remote_mounts.pop(dir_, None) is None:
                return Response({"error": f"{dir_} not mounted"}, 404)
            self._save_remote_state()
            return Response({"ok": True})

        @svc.route("GET", r"/__remote__/mounts")
        def remote_mounts(req: Request) -> Response:
            return Response({
                "mounts": self._remote_mounts,
                "configs": {k: v.get("kind", "?")
                            for k, v in self._remote_confs.items()},
            })

        @svc.route("POST", r"/__remote__/meta_sync")
        def remote_meta_sync(req: Request) -> Response:
            dir_ = normalize(req.json()["dir"])
            if dir_ not in self._remote_mounts:
                return Response({"error": f"{dir_} not mounted"}, 404)
            n = self._remote_meta_sync(dir_)
            return Response({"ok": True, "synced": n})

        @svc.route("POST", r"/__remote__/cache")
        def remote_cache(req: Request) -> Response:
            path = normalize(req.json().get("dir", req.json().get("path", "/")))
            cached = 0

            def walk(p: str) -> None:
                nonlocal cached
                for e in self.filer.list_entries(p):
                    if e.is_directory:
                        walk(e.full_path)
                    elif e.extended.get(REMOTE_KEY) and not e.chunks \
                            and not e.content:
                        self._remote_cache_entry(e)
                        cached += 1

            entry = self.filer.find_entry(path)
            if entry is None:
                return Response({"error": f"{path} not found"}, 404)
            if entry.is_directory:
                walk(path)
            elif entry.extended.get(REMOTE_KEY):
                self._remote_cache_entry(entry)
                cached = 1
            return Response({"ok": True, "cached": cached})

        @svc.route("POST", r"/__remote__/uncache")
        def remote_uncache(req: Request) -> Response:
            path = normalize(req.json().get("dir", "/"))
            dropped = 0

            def walk(p: str) -> None:
                nonlocal dropped
                for e in self.filer.list_entries(p):
                    if e.is_directory:
                        walk(e.full_path)
                    elif e.extended.get(REMOTE_KEY) and (e.chunks or e.content):
                        self._reclaim_chunks(e.chunks)
                        e.chunks = []
                        e.content = b""
                        self.filer.update_entry(e)
                        dropped += 1

            entry = self.filer.find_entry(path)
            if entry is None:
                return Response({"error": f"{path} not found"}, 404)
            if entry.is_directory:
                walk(path)
            elif entry.extended.get(REMOTE_KEY) and (
                entry.chunks or entry.content
            ):
                self._reclaim_chunks(entry.chunks)
                entry.chunks = []
                entry.content = b""
                self.filer.update_entry(entry)
                dropped = 1
            return Response({"ok": True, "uncached": dropped})

    # --- routes -----------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service
        path_re = r"(/.*)"
        self._register_remote_routes(svc)

        # metadata subscription (must register before the catch-all
        # namespace): long-poll equivalent of gRPC SubscribeMetadata
        # (`weed/server/filer_grpc_server_sub_meta.go`)
        @svc.route("GET", r"/__meta__/events")
        def meta_events(req: Request) -> Response:
            trace.annotate(long_poll=True)  # slow by design: skip slow-log
            since = int(req.query.get("since_ns", 0))
            limit = int(req.query.get("limit", 1024))
            wait = float(req.query.get("wait", 0))
            batch = self.filer.event_payloads_since(since, limit, wait=min(wait, 30.0))
            events = [json.loads(p) for _, p in batch]
            next_ts = batch[-1][0] if batch else since
            return Response(
                {"events": events, "next_ts_ns": next_ts,
                 "signature": self.filer.signature}
            )

        @svc.route("GET", r"/__dedup__/stats")
        def dedup_stats(req: Request) -> Response:
            if not self.dedup:
                return Response({"enabled": False})
            out = self.dedup_index.stats()
            out["enabled"] = True
            return Response(out)

        @svc.route("POST", r"/__dedup__/gc")
        def dedup_gc(req: Request) -> Response:
            if not self.dedup:
                return Response({"error": "dedup not enabled"}, 400)
            return Response(self.dedup_gc())

        # --- distributed lock manager (weed/cluster/lock_manager) ---
        @svc.route("POST", r"/__dlm__/lock")
        def dlm_lock(req: Request) -> Response:
            p = req.json()
            key = p["key"]
            target = self.lock_ring.server_for(key)
            if target and target != self.url:
                return Response({"moved_to": target}, 307)
            try:
                token, expires = self.dlm.lock(
                    key, p.get("owner", "?"), float(p.get("ttl_sec", 30)),
                    token=p.get("token", ""),
                )
            except LockedError as e:
                return Response({"error": str(e), "owner": e.owner}, 409)
            return Response(
                {"ok": True, "token": token, "expires_at": expires}
            )

        @svc.route("POST", r"/__dlm__/unlock")
        def dlm_unlock(req: Request) -> Response:
            p = req.json()
            key = p["key"]
            target = self.lock_ring.server_for(key)
            if target and target != self.url:
                return Response({"moved_to": target}, 307)
            try:
                self.dlm.unlock(key, p.get("token", ""))
            except LockedError as e:
                return Response({"error": str(e), "owner": e.owner}, 409)
            return Response({"ok": True})

        @svc.route("GET", r"/__dlm__/status")
        def dlm_status(req: Request) -> Response:
            return Response({
                "ring": self.lock_ring.servers(),
                "host": self.url,
            })

        @svc.route("POST", r"/__meta__/notify")
        def meta_notify(req: Request) -> Response:
            # `command_fs_meta_notify.go`: recursively (re)send every
            # entry under a directory to the notification queue so a
            # downstream replicator can bootstrap from existing data
            p = req.json()
            root = normalize(p.get("directory", "/"))
            if self.filer.notification_queue is None:
                return Response({"error": "no notification queue"
                                          " configured"}, 400)
            sent = 0

            def walk(d: str) -> None:
                nonlocal sent
                for e in self.filer.list_entries(d, limit=1 << 31):
                    self.filer.notification_queue.send_message(
                        e.full_path,
                        {"directory": d, "old_entry": None,
                         "new_entry": e.to_dict(),
                         "ts_ns": time.time_ns(), "signatures": []},
                    )
                    sent += 1
                    if e.is_directory:
                        walk(e.full_path)

            walk(root)
            return Response({"sent": sent})

        @svc.route("POST", r"/__meta__/change_volume_id")
        def meta_change_volume_id(req: Request) -> Response:
            # `command_fs_meta_change_volume_id.go`: after volumes are
            # relocated/renumbered (e.g. cross-cluster copies), rewrite
            # the volume id inside chunk fids under a directory. The
            # blobs themselves moved — freed-chunk reclaim must not run.
            p = req.json()
            root = normalize(p.get("directory", "/"))
            mapping = {str(k): str(v)
                       for k, v in (p.get("mapping") or {}).items()}
            if not mapping:
                return Response({"error": "empty volume id mapping"}, 400)
            changed = 0

            def rewrite(chunks) -> bool:
                hit = False
                for c in chunks:
                    vid, _, rest = c.file_id.partition(",")
                    if vid in mapping:
                        c.file_id = f"{mapping[vid]},{rest}"
                        hit = True
                return hit

            def walk(d: str) -> None:
                nonlocal changed
                for e in self.filer.list_entries(d, limit=1 << 31):
                    if e.is_directory:
                        walk(e.full_path)
                        continue
                    if rewrite(e.chunks):
                        self.filer.create_entry(e)  # freed fids ignored
                        changed += 1

            walk(root)
            return Response({"changed": changed})

        @svc.route("POST", r"/__meta__/merge_volumes")
        def meta_merge_volumes(req: Request) -> Response:
            # `command_fs_merge_volumes.go`: move chunks out of volume
            # `from_vid` into `to_vid` (needle key/cookie preserved, so
            # existing fids only change their volume part) and rewrite
            # the metadata; dry-run unless apply. Old blobs are deleted
            # after their entry is updated.
            p = req.json()
            root = normalize(p.get("directory", "/"))
            from_vid = str(p.get("from_vid", ""))
            to_vid = str(p.get("to_vid", ""))
            apply = bool(p.get("apply"))
            if not from_vid or not to_vid or from_vid == to_vid:
                return Response(
                    {"error": "need distinct from_vid and to_vid"}, 400)
            try:
                targets = self.client.lookup(int(to_vid))
            except (IOError, ValueError) as e:
                return Response({"error": f"target volume: {e}"}, 400)
            target = targets[0]
            moved = planned = 0
            skipped: list[str] = []
            manifest_skipped = 0

            def migrate(entry) -> bool:
                nonlocal moved, planned
                changed = False
                old_chunks = []
                for c in entry.chunks:
                    vid, _, rest = c.file_id.partition(",")
                    if vid != from_vid:
                        continue
                    planned += 1
                    if not apply:
                        continue
                    new_fid = f"{to_vid},{rest}"
                    try:
                        # key collision in the target volume would clobber
                        # a foreign needle (a same-key/other-cookie needle
                        # HEADs 404 but still fails the overwrite check
                        # below — caught the same way)
                        st, _, _ = http_request(
                            "HEAD", f"{peer_url(target)}/{new_fid}")
                        if st == 200:
                            skipped.append(c.file_id)
                            continue
                        data = self.client.fetch(c.file_id)
                        self.client.upload_to(new_fid, target, data)
                    except IOError:
                        skipped.append(c.file_id)
                        continue
                    old_chunks.append(copy.copy(c))
                    c.file_id = new_fid
                    changed = True
                    moved += 1
                if changed:
                    self.filer.create_entry(entry)  # moved, not freed
                    # reclaim via the shared path: dedup-managed blobs
                    # (shared with other entries / the dedup index) are
                    # kept, everything else is deleted
                    self._reclaim_chunks(old_chunks)
                return changed

            def walk(d: str) -> None:
                nonlocal manifest_skipped
                for e in self.filer.list_entries(d, limit=1 << 31):
                    if e.is_directory:
                        walk(e.full_path)
                        continue
                    if any(c.is_chunk_manifest for c in e.chunks):
                        # inner manifest fids may live in from_vid too;
                        # migrating them means rewriting manifest blobs —
                        # report instead of claiming a full drain
                        manifest_skipped += 1
                        continue
                    if any(c.file_id.startswith(from_vid + ",")
                           for c in e.chunks):
                        migrate(e)

            walk(root)
            return Response({"planned": planned, "moved": moved,
                             "skipped": skipped,
                             "manifest_entries_skipped": manifest_skipped,
                             "applied": apply})

        @svc.route("GET", r"/__meta__/info")
        def meta_info(req: Request) -> Response:
            return Response(
                {
                    "signature": self.filer.signature,
                    "latest_ts_ns": self.filer.log_buffer.latest_ts_ns,
                    "master": getattr(self.client, "master_url", ""),
                    "chunk_size": self.chunk_size,
                }
            )

        def front_door(do, bytes_in: bool = False, bytes_out: bool = False):
            """A path handler behind QoS admission and tenant accounting,
            with the tenant resolved once for both."""
            def handler(req: Request) -> Response:
                try:
                    coll = self._resolve_collection(req)
                except Exception:  # neither may fail a request
                    coll = None
                shed = self._admit(req, coll)
                if shed is not None:
                    return shed
                resp = do(req)
                self._account_usage(
                    coll, resp,
                    bytes_in=int(req.headers.get("Content-Length") or 0) if bytes_in else 0,
                    bytes_out=len(resp.body) if bytes_out else 0)
                return resp
            return handler

        svc.route("GET", path_re)(front_door(
            lambda req: self._do_read(req, head=False), bytes_out=True))
        svc.route("HEAD", path_re)(front_door(
            lambda req: self._do_read(req, head=True)))
        svc.route("POST", path_re)(front_door(self._do_write, bytes_in=True))
        svc.route("PUT", path_re)(front_door(self._do_write, bytes_in=True))
        svc.route("DELETE", path_re)(front_door(self._do_delete))

    def _admit(self, req: Request, coll: str | None) -> Response | None:
        """QoS admission at the front door (qos/admission.py), BEFORE any
        bytes move. None = admitted; otherwise a typed 429/503 with
        Retry-After and a machine-readable reason — never an untyped
        failure. Unarmed, this is one attribute load."""
        if not qos_mod.controller().armed or coll is None:
            return None
        try:
            cls = qos_mod.classify(req.method, req.headers)
            d = qos_mod.admit(coll, cls)
        except Exception:  # admission must never fail a request untyped
            return None
        if d is None:
            return None
        return Response(d.to_dict(), d.status, headers=d.headers())

    def _account_usage(self, coll: str | None, resp: Response,
                       bytes_in: int = 0, bytes_out: int = 0) -> None:
        """Tenant accounting of the front door (stats/usage.py)."""
        if coll is None:
            return
        try:
            usage_mod.accountant().record(
                coll,
                bytes_in=float(bytes_in), bytes_out=float(bytes_out),
                error=resp.status >= 500,
            )
        except Exception:  # accounting must never fail a request
            pass

    def _resolve_collection(self, req: Request) -> str:
        """The tenant dimension both usage accounting AND qos admission
        key on — resolved exactly like the write path's placement:
        explicit ?collection=, then the fs.configure rule, then the filer
        default."""
        path = normalize(urllib.parse.unquote(req.path))
        coll = req.query.get("collection")
        if not coll and not path.startswith("/etc/"):
            rule = self.filer_conf.match(path) or {}
            coll = rule.get("collection")
        return coll or self.collection or "default"

    # --- handlers ---------------------------------------------------------------
    @staticmethod
    def _parse_signatures(req: Request) -> list[int]:
        """?signatures=1,2 — carried by filer.sync replays to break
        replication loops (`filer_sync.go:119-385`)."""
        raw = req.query.get("signatures", "")
        out = []
        for piece in raw.split(","):
            piece = piece.strip()
            if piece:
                try:
                    out.append(int(piece))
                except ValueError:
                    pass
        return out

    def _do_write(self, req: Request) -> Response:
        path = normalize(urllib.parse.unquote(req.path))
        signatures = self._parse_signatures(req)
        if "mv.from" in req.query:
            # POST /new/path?mv.from=/old/path — rename/move, matching the
            # reference filer's mv.from query API (filer_server_handlers_write.go)
            try:
                self.filer.rename(req.query["mv.from"], path)
            except FilerError as e:
                return Response({"error": str(e)}, 409)
            return Response({"ok": True}, 200)
        if "link.from" in req.query:
            # POST /new/path?link.from=/old/path — hard link (the FUSE Link
            # flow, `weed/mount/weedfs_link.go:53`; counter semantics from
            # `weed/filer/filerstore_hardlink.go`)
            try:
                link = self.filer.create_hard_link(req.query["link.from"], path)
            except FilerError as e:
                return Response({"error": str(e)}, 409)
            return Response(
                {"ok": True, "nlink": link.hard_link_counter}, 201
            )
        if req.query.get("meta.entry") == "true":
            # raw metadata restore (fs.meta.load): entry dict incl. chunks
            try:
                entry = Entry.from_dict(req.json())
                entry.full_path = path
                freed = self.filer.create_entry(entry, signatures=signatures)
                self._reclaim_chunks(freed)
            except (FilerError, KeyError, ValueError) as e:
                return Response({"error": str(e)}, 409)
            return Response({"name": entry.name}, 201)
        if path.endswith("/") or req.query.get("mkdir") == "true":
            e = Entry(full_path=path, is_directory=True,
                      attributes=Attributes(mode=0o755))
            self.filer.create_entry(e, signatures=signatures)
            return Response({"name": e.name}, 201)
        part = req.multipart_file()
        if part is not None:
            filename, mime, data = part
        else:
            data = req.body
            mime = req.headers.get("Content-Type", "")
            filename = path.rsplit("/", 1)[-1]
        # fs.configure per-path rules (filer_conf.go): longest prefix wins;
        # explicit query params still override the rule's defaults. The
        # /etc/ config area is EXEMPT — a broad read-only rule must never
        # brick the very file that removes it.
        rule = {} if path.startswith("/etc/") else (
            self.filer_conf.match(path) or {})
        if rule.get("read_only"):
            return Response(
                {"error": f"{rule.get('location_prefix')} is read-only"
                          " (fs.configure)"}, 403)
        rule_ttl = rule.get("ttl") or ""
        if rule_ttl:
            try:  # a malformed persisted rule must not 500 a whole subtree
                TTL.parse(rule_ttl)
            except (ValueError, KeyError):
                log.warning("fs.configure rule %s has invalid ttl %r;"
                            " ignoring it", rule.get("location_prefix"),
                            rule_ttl)
                rule_ttl = ""
        ttl = req.query.get("ttl") or rule_ttl
        collection = (req.query.get("collection") or rule.get("collection")
                      or self.collection)
        replication = (req.query.get("replication")
                       or rule.get("replication")
                       or self.default_replication)

        entry = Entry(full_path=path)
        entry.attributes.mime = mime
        entry.attributes.file_size = len(data)
        entry.attributes.ttl_sec = TTL.parse(ttl).minutes() * 60
        entry.attributes.mtime = time.time()
        # /etc/seaweedfs/ config files are ALWAYS inlined: their
        # loaders (filer.conf hot-reload) read entry.content, and a
        # config silently chunked past 2KB would parse as empty —
        # rules vanishing without a trace
        if (len(data) <= SMALL_CONTENT_LIMIT
                or (path.startswith("/etc/seaweedfs/")
                    and len(data) <= 4 * 1024 * 1024)):
            entry.content = data
            entry.attributes.md5 = self.hash_service.submit(data).md5_hex()
        else:
            chunks, md5_hex = self._upload_chunks(
                data, ttl, collection, replication, mime=mime, filename=filename
            )
            entry.chunks = maybe_manifestize(self._save_manifest_blob, chunks)
            entry.attributes.md5 = md5_hex
        old_entry = self.filer.find_entry(path)
        try:
            freed = self.filer.create_entry(entry, signatures=signatures)
        except FilerError as e:
            return Response({"error": str(e)}, 409)
        if old_entry is not None and old_entry.hard_link_id:
            # hardlinked target: surviving links still reference the shared
            # chunks — reclaim only what the detach actually freed
            self._reclaim_chunks(freed)
        elif old_entry is not None and old_entry.chunks:
            self._reclaim_chunks(old_entry.chunks)  # overwritten version's blobs
        return Response(
            {"name": entry.name, "size": len(data), "md5": entry.attributes.md5},
            201,
        )

    def _reclaim_chunks(self, chunks) -> None:
        for c in chunks:
            try:
                if c.is_chunk_manifest:
                    for inner in resolve_chunk_manifest(self._fetch_chunk, [c]):
                        if not self._dedup_managed(inner):
                            self.client.delete(inner.file_id)
                    self.client.delete(c.file_id)  # manifests are never shared
                    continue
                if self._dedup_managed(c):
                    continue
                self.client.delete(c.file_id)
            except Exception:
                pass

    def _dedup_managed(self, chunk: FileChunk) -> bool:
        """True when the chunk's blob is owned by the dedup index — other
        entries may reference the same fid, so delete/overwrite must not
        reclaim it (`dedup_gc` does, once nothing references it).
        Consults the MD5-keyed shadow entry ("m<md5>-<len>",
        written next to every SW128 primary) because chunk metadata
        carries only the MD5 ETag; legacy md5-primary keys (pre-SW128
        indexes) still match via the bare-key fallback."""
        if not self.dedup or not chunk.etag:
            return False
        for key in (f"m{chunk.etag}-{chunk.size:x}",
                    f"{chunk.etag}-{chunk.size:x}"):
            rec = self.dedup_index.lookup(key)
            if rec is None:
                continue
            if rec.get("fid") == chunk.file_id:
                return True
            # racing first-uploads of the same content can leave the
            # shadow pointing at the loser's fid while the primary (the
            # fid dup-hits actually hand out) holds the winner's — follow
            # the shadow's primary pointer so the winner stays protected
            primary = rec.get("p")
            if primary:
                prec = self.dedup_index.lookup(primary)
                if prec is not None and prec.get("fid") == chunk.file_id:
                    return True
        return False

    def dedup_gc(self) -> dict:
        """Walk the namespace, then drop every index entry (and delete its
        blob) that no live entry references. Concurrency-safe against
        in-flight dedup'd uploads: a lookup-hit records its fid in
        `_dedup_recent` under `_dedup_mu` before the entry exists, and the
        gc decision runs under the same lock — so a hit either precedes the
        decision (gc skips the fid as recently referenced) or follows the
        key's condemnation (the upload sees `_dedup_condemned` and
        re-uploads instead). Order per dropped key: the index entry first,
        then its shadow, then the blob."""
        gc_start = time.monotonic()
        referenced: set[str] = set()

        def walk(p: str) -> None:
            for e in self.filer.list_entries(p, limit=1 << 31):
                if e.is_directory:
                    if e.full_path != DEDUP_DIR:
                        walk(e.full_path)
                    continue
                chunks = e.chunks
                if any(c.is_chunk_manifest for c in chunks):
                    # a manifest we cannot resolve hides data fids — any
                    # error here must abort the gc, not shrink the pin set
                    chunks = self._resolved_chunks(e)
                for c in chunks:
                    referenced.add(c.file_id)

        try:
            walk("/")
        except Exception as e:
            return {"error": f"namespace walk failed, gc aborted: {e}",
                    "scanned": 0, "dropped": 0, "bytes_freed": 0, "errors": 1}
        scanned = dropped = freed = errors = 0
        for key, rec in list(self.dedup_index.iter_records()):
            scanned += 1
            fid = rec.get("fid", "")
            if not fid or fid in referenced:
                continue
            # Shadow entries ("m<md5>-<len>") must OUTLIVE their primary —
            # a shadow removed while the primary still hands out the fid
            # would let overwrite-reclaim delete a shared blob. They are
            # only swept here once their primary is gone (crash orphans).
            is_shadow = key.startswith("m") and len(key) > 33
            if is_shadow:
                primary = rec.get("p", "")
                if primary and self.dedup_index.lookup(primary) is not None:
                    continue  # primary alive: the pair drops together below
                try:
                    self.dedup_index.remove(key)
                except Exception:
                    errors += 1
                continue
            with self._dedup_mu:
                # referenced (or re-inserted) since the walk began: keep
                ts = self._dedup_recent.get(fid)
                if ts is not None and ts >= gc_start - 1.0:
                    continue
                self._dedup_condemned.add(key)
            try:
                # index entry first: if this fails the blob merely leaks and
                # a later gc retries; the reverse order would leave the index
                # handing out a deleted fid (silent data loss)
                self.dedup_index.remove(key)
            except Exception:
                errors += 1
                continue
            # the paired shadow goes with its primary (etag recorded at
            # insert); failure just leaves an orphan the next gc sweeps
            etag = rec.get("etag", "")
            if etag:
                try:
                    self.dedup_index.remove(
                        f"m{etag}-{key.rsplit('-', 1)[1]}")
                except Exception:
                    pass
            try:
                self.client.delete(fid)
            except Exception:
                errors += 1  # blob leaked; index is already consistent
                continue
            dropped += 1
            try:
                freed += int(key.rsplit("-", 1)[1], 16)
            except (IndexError, ValueError):
                pass
        with self._dedup_mu:  # prune the recency map so it stays bounded
            cutoff = time.monotonic() - 600.0
            self._dedup_recent = {
                f: t for f, t in self._dedup_recent.items() if t > cutoff
            }
        return {
            "scanned": scanned, "dropped": dropped,
            "bytes_freed": freed, "errors": errors,
        }

    def _do_read(self, req: Request, head: bool) -> Response:
        path = normalize(urllib.parse.unquote(req.path))
        entry = self.filer.find_entry(path)
        if entry is None:
            return Response({"error": f"{path} not found"}, 404)
        if req.query.get("metadata") == "true":
            return Response(entry.to_dict())
        if entry.is_directory:
            if req.headers.get("X-Sw-S3"):
                # S3-front relay: object keys never resolve to listings —
                # the gateway translates this into NoSuchKey
                return Response({"error": f"{path} is a directory"}, 404)
            return self._list_dir(req, entry)
        if (
            entry.attributes.ttl_sec > 0
            and entry.attributes.mtime + entry.attributes.ttl_sec < time.time()
        ):
            self.filer.delete_entry(path)  # expired: reap lazily
            return Response({"error": f"{path} expired"}, 404)
        if not entry.content and not entry.chunks and entry.extended.get(REMOTE_KEY):
            # read-through: cache the remote object locally on first
            # access (`read_remote.go` CacheRemoteObjectToLocalCluster)
            try:
                entry = self._remote_cache_entry(entry)
            except (FilerError, OSError) as e:
                return Response({"error": f"remote fetch: {e}"}, 502)
        etag = entry.attributes.md5 or str(entry.attributes.mtime)
        headers = {
            "ETag": f'"{etag}"',
            "Accept-Ranges": "bytes",
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(entry.attributes.mtime)
            ),
        }
        if entry.attributes.mime:
            headers["Content-Type"] = entry.attributes.mime
        if req.headers.get("If-None-Match") == f'"{etag}"':
            return Response(b"", 304, headers)
        size = entry.size()
        start, end = 0, size - 1
        status = 200
        rng = req.headers.get("Range")
        if rng and rng.startswith("bytes=") and "," not in rng:
            spec = rng[6:]
            s, _, e = spec.partition("-")
            try:
                start = int(s) if s else max(0, size - int(e))
                end = int(e) if e and s else size - 1
            except ValueError:
                # RFC 7233: unintelligible specs are ignored (full entity)
                start, end = 0, size - 1
            else:
                end = min(end, size - 1)
                if start > end:
                    return Response(
                        b"", 416, {"Content-Range": f"bytes */{size}"})
                status = 206
                headers["Content-Range"] = f"bytes {start}-{end}/{size}"
        if head:
            headers["X-File-Size"] = str(size)
            headers["Content-Length"] = str(size)
            return Response(b"", 200 if status == 200 else status, headers)
        body = self._read_range(entry, start, end - start + 1)
        return Response(body, status, headers)

    def _read_range(self, entry: Entry, offset: int, size: int) -> bytes:
        """Visible-interval resolution + ranged chunk fetches
        (`filer/stream.go:153` StreamContent)."""
        if entry.content:
            return entry.content[offset : offset + size]
        chunks = self._resolved_chunks(entry)
        by_fid = {c.file_id: c for c in chunks}
        views = view_from_chunks(chunks, offset, size)
        buf = bytearray(size)
        for view in views:
            chunk = by_fid.get(view.file_id)
            if chunk is not None and (chunk.cipher_key or chunk.is_compressed):
                # transformed chunks can't be range-read on the volume
                # server; fetch whole via the tiered cache, decode, slice
                # (`filer/stream.go` fetchChunkRange → ReaderCache)
                piece = self._fetch_whole_chunk(chunk)[
                    view.offset_in_chunk : view.offset_in_chunk + view.size
                ]
            else:
                rng = (
                    f"bytes={view.offset_in_chunk}-"
                    f"{view.offset_in_chunk + view.size - 1}"
                )
                piece = self.client.fetch(view.file_id, range_header=rng)
            dst = view.view_offset - offset
            buf[dst : dst + len(piece)] = piece
        return bytes(buf)

    def _fetch_whole_chunk(self, chunk: FileChunk) -> bytes:
        """Whole-chunk fetch + decrypt + decompress. Decoded ciphertext is
        cached in memory only — the disk tiers must never hold plaintext of
        encrypted chunks (the reference's ReaderCache is mem-only too)."""
        cached = (
            self.chunk_cache.mem.get(chunk.file_id) if chunk.cipher_key
            else self.chunk_cache.get_chunk(chunk.file_id)
        )
        if cached is not None:
            return cached
        raw = self.client.fetch(chunk.file_id)
        if chunk.cipher_key:
            raw = cipher_util.decrypt(raw, base64.b64decode(chunk.cipher_key))
        if chunk.is_compressed:
            raw = decompress_data(raw)
        if chunk.cipher_key:
            self.chunk_cache.mem.set(chunk.file_id, raw)
        else:
            self.chunk_cache.set_chunk(chunk.file_id, raw)
        return raw

    def _list_dir(self, req: Request, entry: Entry) -> Response:
        limit = int(req.query.get("limit", 1024))
        last = req.query.get("lastFileName", "")
        entries = self.filer.list_entries(entry.full_path, last, False, limit)
        accept = (req.headers.get("Accept") or "")
        if "text/html" in accept and "application/json" not in accept:
            # browsers get the directory browser (`weed/server/filer_ui`);
            # API clients keep the JSON listing. Attribute values go
            # through quoteattr (escape() leaves double quotes — an XSS
            # hole via filenames) and hrefs are percent-encoded (names
            # with %/#/? would link to the wrong resource otherwise).
            def _href(p: str) -> str:
                return _qa(urllib.parse.quote(p))

            rows = []
            if entry.full_path != "/":
                rows.append(f"<tr><td><a href={_href(entry.parent)}>..</a>"
                            "</td><td></td><td></td></tr>")
            for e in entries:
                name = _esc(e.name) + ("/" if e.is_directory else "")
                size = "" if e.is_directory else str(e.size())
                mtime = time.strftime(
                    "%Y-%m-%d %H:%M", time.localtime(e.attributes.mtime))
                rows.append(f"<tr><td><a href={_href(e.full_path)}>{name}"
                            f'</a></td><td align="right">{size}</td>'
                            f"<td>{mtime}</td></tr>")
            more = ""
            if len(entries) == limit:
                next_url = (f"{urllib.parse.quote(entry.full_path)}"
                            f"?lastFileName="
                            f"{urllib.parse.quote_plus(entries[-1].name)}"
                            f"&limit={limit}")
                more = f"<p><a href={_qa(next_url)}>more…</a></p>"
            html = (
                "<html><head><title>seaweedfs-tpu filer"
                f" {_esc(entry.full_path)}</title></head><body>"
                f"<h3>{_esc(entry.full_path)}</h3>"
                '<table cellpadding="4">'
                "<tr><th align=\"left\">name</th>"
                "<th align=\"right\">size</th>"
                "<th align=\"left\">modified</th></tr>"
                + "".join(rows) + f"</table>{more}</body></html>"
            )
            return Response(html.encode(),
                            content_type="text/html; charset=utf-8")
        return Response(
            {
                "Path": entry.full_path,
                "Entries": [
                    {
                        "FullPath": e.full_path,
                        "IsDirectory": e.is_directory,
                        "FileSize": e.size(),
                        "Mtime": e.attributes.mtime,
                        "Mime": e.attributes.mime,
                        "Md5": e.attributes.md5,
                    }
                    for e in entries
                ],
                "LastFileName": entries[-1].name if entries else "",
                "ShouldDisplayLoadMore": len(entries) == limit,
            }
        )

    def _do_delete(self, req: Request) -> Response:
        path = normalize(urllib.parse.unquote(req.path))
        rule = {} if path.startswith("/etc/") else (
            self.filer_conf.match(path) or {})
        if rule.get("read_only"):
            return Response(
                {"error": f"{rule.get('location_prefix')} is read-only"
                          " (fs.configure)"}, 403)
        recursive = req.query.get("recursive") == "true"
        try:
            chunks = self.filer.delete_entry(
                path, recursive=recursive,
                signatures=self._parse_signatures(req),
            )
        except FilerError as e:
            return Response({"error": str(e)}, 409)
        self._reclaim_chunks(chunks)
        return Response(b"", 204)
