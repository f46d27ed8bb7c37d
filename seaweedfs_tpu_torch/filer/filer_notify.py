"""Metadata event log: every entry mutation is appended to a LogBuffer and
flushed as dated segment files inside the filer's own namespace under
`/topics/.system/log/<yyyy-mm-dd>/<hh-mm-ss>...` — so the event history is
itself replicated/durable like any other filer data.

Reference: `weed/filer/filer_notify.go:20` (NotifyUpdateEvent, event file
layout), `weed/server/filer_grpc_server_sub_meta.go` (subscription serving:
catch up from flushed segments, then stream the in-memory buffer). The
port's copy of `seaweedfs_tpu/filer/filer_notify.py`.
"""

from __future__ import annotations

import json
import time

# the whole .system tree is event-silent (see Filer._notify)
SYSTEM_TREE_PREFIX = "/topics/.system/"
SYSTEM_LOG_DIR = SYSTEM_TREE_PREFIX + "log"


def serialize_event(
    directory: str,
    old_entry,
    new_entry,
    ts_ns: int,
    signatures: list[int],
) -> bytes:
    return json.dumps(
        {
            "directory": directory,
            "old_entry": old_entry.to_dict() if old_entry is not None else None,
            "new_entry": new_entry.to_dict() if new_entry is not None else None,
            "ts_ns": ts_ns,
            "signatures": signatures,
        }
    ).encode()


def deserialize_event(payload: bytes) -> dict:
    from .entry import Entry

    d = json.loads(payload)
    d["old_entry"] = Entry.from_dict(d["old_entry"]) if d.get("old_entry") else None
    d["new_entry"] = Entry.from_dict(d["new_entry"]) if d.get("new_entry") else None
    return d


def segment_path(start_ns: int, stop_ns: int) -> str:
    """Dated segment file path; the name embeds the exact ns range so readers
    can skip segments without opening them."""
    t = time.gmtime(start_ns / 1e9)
    day = time.strftime("%Y-%m-%d", t)
    hms = time.strftime("%H-%M-%S", t)
    return f"{SYSTEM_LOG_DIR}/{day}/{hms}.{start_ns}.{stop_ns}"


def parse_segment_name(name: str) -> tuple[int, int] | None:
    parts = name.split(".")
    if len(parts) != 3:
        return None
    try:
        return int(parts[1]), int(parts[2])
    except ValueError:
        return None


class MetaLogPersister:
    """Flush callback for the filer's LogBuffer + segment reader."""

    def __init__(self, filer) -> None:
        self.filer = filer

    def flush(self, start_ns: int, stop_ns: int, batch: list[tuple[int, bytes]]) -> None:
        from .entry import Attributes, Entry

        body = b"\n".join(p for _, p in batch)
        entry = Entry(
            full_path=segment_path(start_ns, stop_ns),
            attributes=Attributes(mode=0o644, file_size=len(body)),
            content=body,
        )
        # write through the store directly — segment writes must not generate
        # further events (the reference skips SystemLogDir in NotifyUpdateEvent)
        self.filer._insert_quiet(entry)

    def read_since(self, ts_ns: int, limit: int = 1 << 31) -> list[tuple[int, bytes]]:
        """Replay flushed segments with events newer than ts_ns."""
        out: list[tuple[int, bytes]] = []
        store = self.filer.store
        days = list(store.list_entries(SYSTEM_LOG_DIR, "", True, 1 << 31))
        for day in sorted(days, key=lambda e: e.name):
            for seg in sorted(
                store.list_entries(day.full_path, "", True, 1 << 31),
                key=lambda e: e.name,
            ):
                rng = parse_segment_name(seg.name)
                if rng is None or rng[1] <= ts_ns:
                    continue
                body = seg.content
                if not body and seg.chunks:
                    continue  # chunked segments need a volume read — not used here
                for line in body.split(b"\n"):
                    if not line:
                        continue
                    ev = json.loads(line)
                    if ev["ts_ns"] > ts_ns:
                        out.append((ev["ts_ns"], line))
                        if len(out) >= limit:
                            return out
        return out
