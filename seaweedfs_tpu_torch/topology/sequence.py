"""File-key sequencers (reference: `weed/sequence/sequence.go`,
`snowflake_sequencer.go`).

The port's copy of `seaweedfs_tpu/topology/sequence.py`, whole."""

from __future__ import annotations

import json
import os
import threading
import time


class MemorySequencer:
    """Monotonic counter with optional file persistence (the reference
    persists via raft SetMax; a JSON file is this build's single-master WAL)."""

    def __init__(self, state_path: str | None = None, start: int = 1) -> None:
        self._lock = threading.Lock()
        self._path = state_path
        self._counter = start
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                self._counter = max(start, int(json.load(f).get("max", start)))

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            self._persist()
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._counter:
                self._counter = seen + 1
                self._persist()

    def peek(self) -> int:
        return self._counter

    def _persist(self) -> None:
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"max": self._counter}, f)
            os.replace(tmp, self._path)


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node id | 12-bit sequence."""

    EPOCH_MS = 1_288_834_974_657

    def __init__(self, node_id: int) -> None:
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            now = int(time.time() * 1000)
            if now == self._last_ms:
                self._seq = (self._seq + 1) & 0xFFF
                if self._seq == 0:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000)
            else:
                self._seq = 0
            self._last_ms = now
            return (
                ((now - self.EPOCH_MS) << 22) | (self.node_id << 12) | self._seq
            )

    def set_max(self, seen: int) -> None:
        pass  # time-ordered; nothing to bump
