"""Metadata subscription client + peer aggregator.

`MetaSubscriber` long-polls a filer's `/__meta__/events` endpoint (the HTTP
equivalent of the reference's gRPC SubscribeMetadata stream) and invokes a
callback per event. `MetaAggregator` fans in the metadata streams of all
filer peers so any filer (or gateway: mount meta-cache, S3 IAM reload,
filer.sync) sees the cluster-wide mutation feed.

Reference: `weed/filer/meta_aggregator.go:23`, `weed/wdclient/masterclient.go`
(the reconnect loop pattern).

The port's copy of `seaweedfs_tpu/filer/meta_aggregator.py`, over the
port's `server/httpd.py`.
"""

from __future__ import annotations

import threading
import urllib.parse
from typing import Callable

from ..server.httpd import get_json


class MetaSubscriber:
    """Background long-poll loop over one filer's event feed."""

    def __init__(
        self,
        filer_url: str,
        on_event: Callable[[dict], None],
        since_ns: int = 0,
        path_prefix: str = "/",
        poll_wait: float = 5.0,
    ) -> None:
        self.filer_url = filer_url.rstrip("/")
        self.on_event = on_event
        self.since_ns = since_ns
        self.path_prefix = path_prefix
        self.poll_wait = poll_wait
        self.peer_signature = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self, wait: float = 0.0) -> tuple[int, int]:
        """One fetch+dispatch round -> (events fetched, events matched)."""
        q = urllib.parse.urlencode(
            {"since_ns": self.since_ns, "wait": wait, "limit": 1024}
        )
        out = get_json(f"{self.filer_url}/__meta__/events?{q}")
        self.peer_signature = out.get("signature", 0)
        events = out.get("events", [])
        matched = 0
        for ev in events:
            path = ev.get("directory", "/")
            for side in ("new_entry", "old_entry"):
                e = ev.get(side)
                if e:
                    path = e["full_path"]
                    break
            if path.startswith(self.path_prefix):
                self.on_event(ev)
                matched += 1
        self.since_ns = max(self.since_ns, int(out.get("next_ts_ns", self.since_ns)))
        return len(events), matched

    def drain(self) -> int:
        """Apply everything currently available (no blocking). Terminates on
        an empty page — a page may fetch events yet match none."""
        total = 0
        while True:
            fetched, matched = self.poll_once(wait=0.0)
            total += matched
            if fetched == 0:
                return total

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once(wait=self.poll_wait)
            except Exception:
                self._stop.wait(1.0)  # peer down: retry with backoff

    def stop(self) -> None:
        self._stop.set()


class MetaAggregator:
    """Fan-in of every peer filer's metadata stream."""

    def __init__(self, self_url: str, on_event: Callable[[dict], None]) -> None:
        self.self_url = self_url.rstrip("/")
        self.on_event = on_event
        self.subscribers: dict[str, MetaSubscriber] = {}

    def set_peers(self, peer_urls: list[str]) -> None:
        for url in peer_urls:
            url = url.rstrip("/")
            if url == self.self_url or url in self.subscribers:
                continue
            sub = MetaSubscriber(url, self.on_event)
            self.subscribers[url] = sub
            sub.start()
        for url in list(self.subscribers):
            if url not in [u.rstrip("/") for u in peer_urls]:
                self.subscribers.pop(url).stop()

    def stop(self) -> None:
        for sub in self.subscribers.values():
            sub.stop()
        self.subscribers.clear()
