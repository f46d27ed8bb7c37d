"""Content-defined dedup index for the filer write path (BASELINE config 4).
The port's copy of `seaweedfs_tpu/filer/dedup.py`, plus `copy_store`.

Uploads are cut at content-defined boundaries (`ops/cdc.find_boundaries`,
the gear hash on the card), each chunk is keyed by its SW128 identity hash
(`HashService.span_keys`, host code), and chunks whose (key, length) already
exist in the index are NOT uploaded again: the existing fileId is referenced
by the new entry's chunk list (`server/filer.py::_upload_chunks_cdc`).
Identical data shifted by insertions still dedups because boundaries
follow content, not offsets.

The index lives in the filer store itself under `/etc/dedup/<p>/<key>`
(sharded by key prefix), with the store's 16-byte SW128 seed at
`/etc/dedup/.seed`, so every store backend inherits it. An in-process LRU
caches hot keys. Index state is nothing but store entries, so a store the
JAX package's filer wrote dedups in the port once `copy_store` has copied
its entries over.

Deduplicated chunks are shared between entries — deleting one entry does
not reclaim their blobs: the filer's reclaim path skips any fid the index
still maps (`FilerServer._reclaim_chunks`). Space is reclaimed by
`fs.dedup.gc` (shell) / POST `/__dedup__/gc` (`FilerServer.dedup_gc`),
which walks the namespace and deletes the blobs and index entries no entry
references. Dedup is disabled when the filer runs ciphered (per-chunk
random AES keys make equal plaintexts distinct).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

DEDUP_DIR = "/etc/dedup"


class DedupIndex:
    def __init__(self, filer, cache_size: int = 65536) -> None:
        self.filer = filer
        self._cache: OrderedDict[str, dict] = OrderedDict()
        self._cache_size = cache_size
        self._mu = threading.Lock()
        self._seed_mu = threading.Lock()
        self._seed: bytes | None = None
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0

    @property
    def seed(self) -> bytes:
        """Per-store 16-byte secret keying the SW128 identity hash:
        without it an attacker could construct offline collisions and make
        a victim's upload dedup to attacker-chosen bytes. Generated once
        under a lock (two racing first-uploads must not mint different
        seeds — the in-memory one would diverge from the persisted one and
        every key written this session would be unmatchable after
        restart), persisted beside the index so keys stay stable for the
        store's lifetime."""
        if self._seed is not None:
            return self._seed
        with self._seed_mu:
            if self._seed is not None:
                return self._seed
            path = f"{DEDUP_DIR}/.seed"
            e = self.filer.find_entry(path)
            if e is not None and len(e.content) == 16:
                self._seed = bytes(e.content)
            else:
                import os as _os

                from . import Entry

                s = _os.urandom(16)
                ent = Entry(full_path=path)
                ent.content = s
                ent.attributes.file_size = 16
                self.filer.create_entry(ent)
                self._seed = s
        return self._seed

    @staticmethod
    def _path(key: str) -> str:
        return f"{DEDUP_DIR}/{key[:2]}/{key}"

    def lookup(self, key: str) -> dict | None:
        with self._mu:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        entry = self.filer.find_entry(self._path(key))
        if entry is None or not entry.content:
            return None
        try:
            rec = json.loads(entry.content)
        except ValueError:
            return None
        self._remember(key, rec)
        return rec

    def insert(self, key: str, rec: dict) -> None:
        from . import Entry

        e = Entry(full_path=self._path(key))
        e.content = json.dumps(rec).encode()
        e.attributes.file_size = len(e.content)
        self.filer.create_entry(e)
        self._remember(key, rec)

    def remove(self, key: str) -> None:
        """Drop an index entry (gc path); the blob itself is the caller's
        responsibility."""
        with self._mu:
            self._cache.pop(key, None)
        self.filer.delete_entry(self._path(key))

    def iter_records(self):
        """Yield (key, rec) for every persisted index entry — walks the
        sharded `/etc/dedup/<p>/` directories in the filer store."""
        root = self.filer.find_entry(DEDUP_DIR)
        if root is None:
            return
        for shard in self.filer.list_entries(DEDUP_DIR, limit=1 << 31):
            if not shard.is_directory:
                continue
            for e in self.filer.list_entries(shard.full_path, limit=1 << 31):
                if e.is_directory or not e.content:
                    continue
                try:
                    rec = json.loads(e.content)
                except ValueError:
                    continue
                yield e.full_path.rsplit("/", 1)[-1], rec

    def _remember(self, key: str, rec: dict) -> None:
        with self._mu:
            self._cache[key] = rec
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "bytes_saved": self.bytes_saved,
        }


def copy_store(src, dst) -> int:
    """Copy every entry of the filer store `src` into the filer store `dst`,
    walking directories from the root: full path, attributes, content,
    chunks and extended attributes, through each entry's `to_dict()`. `src`
    may be any store with the FilerStore listing interface, such as one the
    JAX package's filer wrote, so its dedup index (and seed) carries over.
    Returns the number of entries copied."""
    from .entry import Entry

    copied = 0
    root = src.find_entry("/")
    if root is not None:
        dst.insert_entry(Entry.from_dict(root.to_dict()))
        copied += 1
    pending = ["/"]
    while pending:
        d = pending.pop()
        for e in list(src.list_entries(d, "", True, 1 << 31)):
            dst.insert_entry(Entry.from_dict(e.to_dict()))
            copied += 1
            if e.is_directory:
                pending.append(e.full_path)
    return copied
