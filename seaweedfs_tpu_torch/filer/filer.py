"""Filer core: path->Entry over a FilerStore, with parent-dir maintenance,
recursive delete, rename, and a metadata event log with subscriptions.

Reference: `weed/filer/filer.go:37`, `filer_delete_entry.go`,
`filer_rename.go`, `filer_notify.go:20` (event log), `meta_aggregator.go`.
The port's copy of `seaweedfs_tpu/filer/filer.py`.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Callable

from ..util.log_buffer import LogBuffer

from . import filer_notify
from .entry import Attributes, Entry, FileChunk
from .filerstore import FilerStore, MemoryStore


class FilerError(Exception):
    pass


def normalize(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    if len(path) > 1 and path.endswith("/"):
        path = path[:-1]
    return path


class MetaEvent:
    def __init__(
        self,
        directory: str,
        old: Entry | None,
        new: Entry | None,
        ts_ns: int = 0,
        signatures: list[int] | None = None,
    ) -> None:
        self.directory = directory
        self.old_entry = old
        self.new_entry = new
        self.ts_ns = ts_ns or time.time_ns()
        self.signatures = signatures or []

    @staticmethod
    def from_payload(payload: bytes) -> "MetaEvent":
        d = filer_notify.deserialize_event(payload)
        return MetaEvent(
            d["directory"], d["old_entry"], d["new_entry"],
            d["ts_ns"], d.get("signatures", []),
        )


class Filer:
    def __init__(self, store: FilerStore | None = None) -> None:
        self.store = store or MemoryStore()
        self._lock = threading.RLock()
        self._subscribers: list[Callable[[MetaEvent], None]] = []
        # per-filer signature: events carry the signatures of every filer they
        # passed through — filer.sync uses this to break replication loops
        # (`weed/filer/meta_aggregator.go`, `filer_sync.go:119`)
        self.signature = random.SystemRandom().randrange(1, 1 << 31)
        self.notification_queue = None  # optional external bus (weed/notification)
        self._persister = filer_notify.MetaLogPersister(self)
        self.log_buffer = LogBuffer(flush_fn=self._persister.flush)
        root = self.store.find_entry("/")
        if root is None:
            self.store.insert_entry(
                Entry(full_path="/", is_directory=True,
                      attributes=Attributes(mode=0o755))
            )

    # --- events ---------------------------------------------------------------
    def subscribe(self, fn: Callable[[MetaEvent], None]) -> None:
        self._subscribers.append(fn)

    def events_since(self, ts_ns: int, limit: int = 1 << 31) -> list[MetaEvent]:
        return [MetaEvent.from_payload(p) for _, p in
                self.event_payloads_since(ts_ns, limit)]

    def event_payloads_since(
        self, ts_ns: int, limit: int = 1 << 31, wait: float = 0.0
    ) -> list[tuple[int, bytes]]:
        """Raw (ts_ns, json payload) stream: flushed segments first, then the
        in-memory buffer (`filer_grpc_server_sub_meta.go` catch-up protocol)."""
        batch, resumable = self.log_buffer.read_since(ts_ns, limit)
        if not resumable:
            old = self._persister.read_since(ts_ns, limit)
            # top up from the in-memory window past the segment cursor so a
            # single call doesn't silently drop the newest unflushed events
            cursor = old[-1][0] if old else ts_ns
            tail, ok = self.log_buffer.read_since(cursor, limit - len(old))
            return old + (tail if ok else [])
        if not batch and wait > 0:
            batch, _ = self.log_buffer.wait_since(ts_ns, wait, limit)
        return batch

    def _insert_quiet(self, entry: Entry) -> None:
        """Insert without generating events (meta-log segment writes)."""
        with self._lock:
            self._ensure_parents(entry.full_path, quiet=True)
            self.store.insert_entry(entry)

    def _notify(
        self,
        directory: str,
        old: Entry | None,
        new: Entry | None,
        signatures: list[int] | None = None,
    ) -> None:
        path = (new or old).full_path if (new or old) else directory
        if path.startswith(filer_notify.SYSTEM_LOG_DIR):
            return
        sigs = list(signatures or [])
        if self.signature not in sigs:
            sigs.append(self.signature)
        ts = self.log_buffer.append_with(
            lambda t: filer_notify.serialize_event(directory, old, new, t, sigs)
        )
        ev = MetaEvent(directory, old, new, ts, sigs)
        for fn in list(self._subscribers):
            try:
                fn(ev)
            except Exception:
                pass
        if self.notification_queue is not None:
            # external bus (`filer_notify.go` Notify → notification.Queue)
            try:
                self.notification_queue.send_message(
                    path,
                    {
                        "directory": directory,
                        "old_entry": old.to_dict() if old else None,
                        "new_entry": new.to_dict() if new else None,
                        "ts_ns": ts,
                        "signatures": sigs,
                    },
                )
            except Exception:
                pass

    # --- core ops ---------------------------------------------------------------
    def _ensure_parents(self, path: str, quiet: bool = False) -> None:
        parent = path.rsplit("/", 1)[0] or "/"
        if parent == path:
            return
        if self.store.find_entry(parent) is None:
            self._ensure_parents(parent, quiet)
            e = Entry(full_path=parent, is_directory=True,
                      attributes=Attributes(mode=0o755))
            self.store.insert_entry(e)
            if not quiet:
                self._notify(e.parent, None, e)

    # --- hard links (reference `weed/filer/filerstore_hardlink.go`,
    # `entry.go` HardLinkId/HardLinkCounter) --------------------------------
    # A hardlinked entry's shared state (attributes, chunks, content,
    # counter) lives ONCE in the store's KV under the hardlink id; directory
    # rows carry only the id. Reads hydrate from KV; writes write through;
    # deleting a link decrements the counter and the blobs are reclaimable
    # only when it reaches zero. Renames move the row without touching the
    # counter (reference DeleteEntry skips DeleteHardLink when op == "MV").

    _HL_PREFIX = "hardlink:"

    def _hl_blob(self, entry: Entry) -> bytes:
        return json.dumps({
            "attributes": entry.attributes.to_dict(),
            "chunks": [c.to_dict() for c in entry.chunks],
            "extended": entry.extended,
            "content": entry.content.hex() if entry.content else "",
            "counter": entry.hard_link_counter,
        }).encode()

    def _hl_write(self, entry: Entry) -> None:
        self.store.kv_put(self._HL_PREFIX + entry.hard_link_id,
                          self._hl_blob(entry))

    def maybe_read_hardlink(self, entry: Entry | None) -> Entry | None:
        if entry is None or entry.is_directory or not entry.hard_link_id:
            return entry
        blob = self.store.kv_get(self._HL_PREFIX + entry.hard_link_id)
        if blob is None:
            return entry
        d = json.loads(blob)
        entry.attributes = Attributes.from_dict(d.get("attributes", {}))
        entry.chunks = [FileChunk.from_dict(c) for c in d.get("chunks", [])]
        entry.extended = d.get("extended", {}) or {}
        entry.content = bytes.fromhex(d["content"]) if d.get("content") else b""
        entry.hard_link_counter = int(d.get("counter", 1))
        return entry

    def _hl_delete_link(self, hard_link_id: str) -> list[FileChunk]:
        """Decrement; returns the chunks to reclaim iff the last link died
        (reference DeleteHardLink)."""
        key = self._HL_PREFIX + hard_link_id
        blob = self.store.kv_get(key)
        if blob is None:
            return []
        d = json.loads(blob)
        d["counter"] = int(d.get("counter", 1)) - 1
        if d["counter"] <= 0:
            self.store.kv_delete(key)
            return [FileChunk.from_dict(c) for c in d.get("chunks", [])]
        self.store.kv_put(key, json.dumps(d).encode())
        return []

    def _hl_on_write(
        self, existing: Entry | None, entry: Entry
    ) -> list[FileChunk]:
        """handleUpdateToHardLinks: write-through the shared blob; if the
        row previously pointed at a different hardlink, drop that link.
        Returns the chunks freed when that drop killed the last link —
        the caller owns reclaiming their blobs."""
        if entry.is_directory:
            return []
        if entry.hard_link_id:
            self._hl_write(entry)
        if (
            existing is not None
            and existing.hard_link_id
            and existing.hard_link_id != entry.hard_link_id
        ):
            return self._hl_delete_link(existing.hard_link_id)
        return []

    def create_hard_link(self, old_path: str, new_path: str) -> Entry:
        """The FUSE Link flow (`weed/mount/weedfs_link.go:53-76`): promote
        the target to hardlink mode if needed, bump the counter, create the
        new row sharing the id."""
        import secrets

        old_path, new_path = normalize(old_path), normalize(new_path)
        with self._lock:
            entry = self.maybe_read_hardlink(self.store.find_entry(old_path))
            if entry is None:
                raise FilerError(f"{old_path} not found")
            if entry.is_directory:
                raise FilerError("cannot hardlink a directory")
            if self.store.find_entry(new_path) is not None:
                raise FilerError(f"{new_path} already exists")
            if not entry.hard_link_id:
                entry.hard_link_id = secrets.token_hex(16)
                entry.hard_link_counter = 1
            entry.hard_link_counter += 1
            entry.attributes.mtime = time.time()
            self._hl_write(entry)
            self.store.update_entry(entry)
            self._notify(entry.parent, entry, entry)
            link = Entry.from_dict(entry.to_dict())
            link.full_path = new_path
            self._ensure_parents(new_path)
            self.store.insert_entry(link)
            self._notify(link.parent, None, link)
            return link

    def create_entry(
        self, entry: Entry, signatures: list[int] | None = None
    ) -> list[FileChunk]:
        """Insert; returns chunks freed by detaching a dead hardlink (the
        caller reclaims their blobs — empty for ordinary writes)."""
        entry.full_path = normalize(entry.full_path)
        with self._lock:
            existing = self.store.find_entry(entry.full_path)
            if existing is not None and existing.is_directory != entry.is_directory:
                raise FilerError(
                    f"{entry.full_path} exists as "
                    f"{'directory' if existing.is_directory else 'file'}"
                )
            self._ensure_parents(entry.full_path)
            freed = self._hl_on_write(existing, entry)
            self.store.insert_entry(entry)
            self._notify(entry.parent, existing, entry, signatures)
            return freed

    def find_entry(self, path: str) -> Entry | None:
        return self.maybe_read_hardlink(
            self.store.find_entry(normalize(path))
        )

    def update_entry(
        self, entry: Entry, signatures: list[int] | None = None
    ) -> list[FileChunk]:
        """Update; same freed-chunks contract as create_entry."""
        with self._lock:
            old = self.store.find_entry(entry.full_path)
            freed = self._hl_on_write(old, entry)
            self.store.update_entry(entry)
            self._notify(entry.parent, old, entry, signatures)
            return freed

    def delete_entry(
        self, path: str, recursive: bool = False,
        signatures: list[int] | None = None,
    ) -> list[FileChunk]:
        """Delete; returns the chunks whose blobs should be reclaimed
        (`filer_delete_entry.go`)."""
        path = normalize(path)
        with self._lock:
            entry = self.store.find_entry(path)
            if entry is None:
                return []
            collected: list[FileChunk] = []
            if entry.is_directory:
                children = list(self.store.list_entries(path, "", True, 1 << 31))
                if children and not recursive:
                    raise FilerError(f"{path} is not empty")
                for child in children:
                    collected.extend(
                        self.delete_entry(
                            child.full_path, recursive=True, signatures=signatures
                        )
                    )
            if not entry.is_directory and entry.hard_link_id:
                # last-link-standing reclaims the shared chunks
                collected.extend(self._hl_delete_link(entry.hard_link_id))
            else:
                collected.extend(entry.chunks)
            self.store.delete_entry(path)
            self._notify(entry.parent, entry, None, signatures)
            return collected

    def close(self) -> None:
        self.log_buffer.close()
        self.store.close()

    def list_entries(
        self, dir_path: str, start_from: str = "", inclusive: bool = False,
        limit: int = 1024,
    ) -> list[Entry]:
        return [
            self.maybe_read_hardlink(e)
            for e in self.store.list_entries(
                normalize(dir_path), start_from, inclusive, limit
            )
        ]

    def rename(self, old_path: str, new_path: str) -> None:
        """Atomic-within-this-filer rename, directories recursively
        (`filer_rename.go`, gRPC AtomicRenameEntry)."""
        old_path, new_path = normalize(old_path), normalize(new_path)
        with self._lock:
            entry = self.store.find_entry(old_path)
            if entry is None:
                raise FilerError(f"{old_path} not found")
            if self.store.find_entry(new_path) is not None:
                raise FilerError(f"{new_path} already exists")
            self._ensure_parents(new_path)
            if entry.is_directory:
                for child in list(self.store.list_entries(old_path, "", True, 1 << 31)):
                    self.rename(
                        child.full_path, new_path + "/" + child.name
                    )
            old_copy = Entry.from_dict(entry.to_dict())
            self.store.delete_entry(old_path)
            entry.full_path = new_path
            self.store.insert_entry(entry)
            self._notify(old_copy.parent, old_copy, None)
            self._notify(entry.parent, None, entry)
