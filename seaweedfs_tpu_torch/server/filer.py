"""Filer server, dedup write path: the port's partial copy of
`seaweedfs_tpu/server/filer.py`.

`FilerServer._upload_chunks_cdc` is the JAX package's content-defined dedup
write path (BASELINE config 4) line for line: cut the upload at
content-defined boundaries (`ops/cdc.find_boundaries`, the `gear_hash`
kernel on the server's device), key every span by SW128 seeded with the
store's secret (`HashService.span_keys`, host code), look each
(key, length) up in the dedup index, hash MD5 ETags for the index misses
only (`HashService.md5_spans`, host code), upload only the misses, and
record each miss under a shadow `m<md5>-<len>` entry and then its primary
entry.

Chunks go to `client`, any object with the JAX package's
`WeedClient.upload(payload, replication=, collection=, ttl=)` signature
that returns `{"fid": ...}`. The server's device is cuda unless the caller
passes `device="cpu"`; with neither it raises.

Not ported yet: the HTTP handlers, master and volume clients,
`_upload_chunks_plain`, manifests, cipher, `_dedup_managed`, the reclaim
path and `dedup_gc`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

from ..filer import FileChunk, Filer
from ..filer.dedup import DedupIndex
from ..ops import cdc
from ..ops.hash_service import HashService
from ..ops.rs_kernel import resolve_device
from ..util.compression import maybe_compress_data


class FilerServer:
    def __init__(
        self,
        filer: Filer,
        client,
        device=None,
        compress: bool = True,
        dedup_avg_bits: int = 16,
        dedup_min: int = 16 * 1024,
        dedup_max: int = 512 * 1024,
    ) -> None:
        self.device = resolve_device(device)
        self.filer = filer
        self.client = client
        self.compress = compress
        # span keys and ETags are host code on either device
        self.hash_service = HashService(device=self.device)
        self.dedup_index = DedupIndex(self.filer)
        self.dedup_avg_bits = dedup_avg_bits
        self.dedup_min = dedup_min
        self.dedup_max = dedup_max
        # gc-vs-upload coordination (the JAX package's dedup_gc): hits record
        # the fid under this lock; gc condemns keys under the same lock, so
        # every hit either lands before the gc decision (gc skips the fid) or
        # sees the key condemned (upload treats it as a miss).
        self._dedup_mu = threading.Lock()
        self._dedup_recent: dict[str, float] = {}
        self._dedup_condemned: set[str] = set()

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
                    # shadow entry keyed by the chunk's MD5: lets the JAX
                    # package's _dedup_managed answer "is this fid
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
