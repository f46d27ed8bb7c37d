"""Mount-side metadata cache kept fresh by the filer's event stream.

Behavioral port of `weed/mount/meta_cache/`: entry lookups hit a local
cache; a background subscriber tails `/__meta__/events` and invalidates
(or updates) affected paths, so kernel-visible attributes converge on
external changes without per-op round trips.

The port's copy of `seaweedfs_tpu/mount/meta_cache.py`, over the port's
`FilerClient` and the port filer's `/__meta__/events`.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict

from ..filer.filer_client import FilerClient
from ..server.httpd import http_request


class MetaCache:
    def __init__(self, filer_url: str, capacity: int = 4096) -> None:
        self.fc = FilerClient(filer_url)
        self.capacity = capacity
        self._map: OrderedDict[str, dict | None] = OrderedDict()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lookups --------------------------------------------------------------
    def get_entry(self, path: str) -> dict | None:
        with self._lock:
            if path in self._map:
                self._map.move_to_end(path)
                return self._map[path]
        entry = self.fc.get_entry(path)
        with self._lock:
            self._map[path] = entry
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
        return entry

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._map.pop(path, None)

    def put(self, path: str, entry: dict | None) -> None:
        with self._lock:
            self._map[path] = entry
            self._map.move_to_end(path)

    # --- subscription ---------------------------------------------------------
    def start_subscriber(self) -> None:
        self._thread = threading.Thread(target=self._follow, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _follow(self) -> None:
        cursor = time.time_ns()
        url = self.fc.filer_url
        while not self._stop.is_set():
            try:
                status, _, body = http_request(
                    "GET",
                    f"{url}/__meta__/events?since_ns={cursor}&wait=2",
                    timeout=10,
                )
                if status != 200:
                    time.sleep(0.5)
                    continue
                out = json.loads(body)
                for ev in out["events"]:
                    for key in ("old_entry", "new_entry"):
                        e = ev.get(key)
                        if e:
                            self.invalidate(e["full_path"])
                cursor = out["next_ts_ns"]
            except Exception:
                time.sleep(0.5)
