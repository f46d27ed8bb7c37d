"""Visible-interval resolution of overlapping chunks.

Behavioral port of `weed/filer/filechunks.go:183-291` + `interval_list.go`:
files are lists of chunks written at different times to possibly-overlapping
logical ranges; the visible view applies chunks in ModifiedTsNs order
(latest wins, LSM-style), producing non-overlapping read intervals. Subtle
and fully unit-testable — the reference ships an extensive test file for it
(`filechunks_test.go`), mirrored in tests/test_filechunks.py.

Manifest chunks (`filechunk_manifest.go`): entries with > MANIFEST_BATCH
chunks store their chunk lists as gzipped JSON blobs on volume servers,
recursively.

The port's copy of `seaweedfs_tpu/filer/filechunks.py`.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass

from .entry import FileChunk

MANIFEST_BATCH = 1000


@dataclass
class VisibleInterval:
    start: int
    stop: int
    file_id: str
    modified_ts_ns: int
    offset_in_chunk: int  # logical start's offset inside the chunk
    chunk_size: int


@dataclass
class ChunkView:
    """One ranged read against one chunk (`filechunks.go` ChunkView)."""

    file_id: str
    offset_in_chunk: int  # where in the chunk to start reading
    size: int
    view_offset: int  # logical file offset this view serves
    chunk_size: int


def read_resolved_chunks(chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Non-overlapping visible intervals, latest-write-wins."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.file_id)):
        new = VisibleInterval(
            start=chunk.offset,
            stop=chunk.offset + chunk.size,
            file_id=chunk.file_id,
            modified_ts_ns=chunk.modified_ts_ns,
            offset_in_chunk=0,
            chunk_size=chunk.size,
        )
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.stop <= new.start or v.start >= new.stop:
                out.append(v)
                continue
            # overlapped: keep the non-covered pieces of the older interval
            if v.start < new.start:
                out.append(
                    VisibleInterval(
                        start=v.start,
                        stop=new.start,
                        file_id=v.file_id,
                        modified_ts_ns=v.modified_ts_ns,
                        offset_in_chunk=v.offset_in_chunk,
                        chunk_size=v.chunk_size,
                    )
                )
            if v.stop > new.stop:
                out.append(
                    VisibleInterval(
                        start=new.stop,
                        stop=v.stop,
                        file_id=v.file_id,
                        modified_ts_ns=v.modified_ts_ns,
                        offset_in_chunk=v.offset_in_chunk + (new.stop - v.start),
                        chunk_size=v.chunk_size,
                    )
                )
        out.append(new)
        out.sort(key=lambda x: x.start)
        visibles = out
    return visibles


def view_from_chunks(
    chunks: list[FileChunk], offset: int = 0, size: int | None = None
) -> list[ChunkView]:
    """Chunk reads covering [offset, offset+size) (`filechunks.go:183`
    ViewFromChunks). Gaps (sparse ranges) are simply absent."""
    return view_from_visibles(read_resolved_chunks(chunks), offset, size)


def view_from_visibles(
    visibles: list[VisibleInterval], offset: int = 0, size: int | None = None
) -> list[ChunkView]:
    """`view_from_chunks` over intervals `read_resolved_chunks` already
    resolved, for a reader that keeps them across reads of one entry."""
    if size is None:
        stop = max((v.stop for v in visibles), default=0)
    else:
        stop = offset + size
    views: list[ChunkView] = []
    for v in visibles:
        if v.stop <= offset or v.start >= stop:
            continue
        start = max(offset, v.start)
        end = min(stop, v.stop)
        views.append(
            ChunkView(
                file_id=v.file_id,
                offset_in_chunk=v.offset_in_chunk + (start - v.start),
                size=end - start,
                view_offset=start,
                chunk_size=v.chunk_size,
            )
        )
    return views


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def separate_garbage_chunks(
    chunks: list[FileChunk],
) -> tuple[list[FileChunk], list[FileChunk]]:
    """(still-visible, fully-shadowed) — shadowed chunk file-ids can be
    deleted from volume servers (`filechunks.go` MinusChunks usage)."""
    visibles = read_resolved_chunks(chunks)
    used = {v.file_id for v in visibles}
    live, garbage = [], []
    for c in chunks:
        (live if c.file_id in used else garbage).append(c)
    return live, garbage


# --- manifest chunks --------------------------------------------------------
def pack_manifest(chunks: list[FileChunk]) -> bytes:
    payload = json.dumps([c.to_dict() for c in chunks]).encode()
    return gzip.compress(payload)


def unpack_manifest(blob: bytes) -> list[FileChunk]:
    return [FileChunk.from_dict(d) for d in json.loads(gzip.decompress(blob))]


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def resolve_chunk_manifest(fetch_fn, chunks: list[FileChunk]) -> list[FileChunk]:
    """Expand manifest chunks recursively; fetch_fn(chunk) -> decoded bytes
    (the chunk is passed whole so ciphered manifest blobs can be decrypted
    with their per-chunk key)."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        nested = unpack_manifest(fetch_fn(c))
        out.extend(resolve_chunk_manifest(fetch_fn, nested))
    return out


def maybe_manifestize(save_fn, chunks: list[FileChunk], batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """If too many chunks, store batches as manifest blobs
    (`filechunk_manifest.go` maybeManifestize); save_fn(bytes) -> FileChunk."""
    if len(chunks) <= batch:
        return chunks
    data_chunks = [c for c in chunks if not c.is_chunk_manifest]
    manifest_chunks = [c for c in chunks if c.is_chunk_manifest]
    out = list(manifest_chunks)
    for i in range(0, len(data_chunks), batch):
        group = data_chunks[i : i + batch]
        blob = pack_manifest(group)
        mc = save_fn(blob)
        mc.is_chunk_manifest = True
        mc.offset = min(c.offset for c in group)
        mc.size = sum(c.size for c in group)
        mc.modified_ts_ns = max(c.modified_ts_ns for c in group)
        out.append(mc)
    return maybe_manifestize(save_fn, out, batch)
