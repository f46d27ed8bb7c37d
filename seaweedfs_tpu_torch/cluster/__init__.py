"""Cluster membership helpers + distributed lock manager.

Behavioral port of `weed/cluster/`:
  - typed node groups with a deterministic leader (the longest-lived member,
    `cluster.go` — the master tracks first-seen timestamps and everyone
    agrees on the oldest)
  - `LockRing` (`lock_manager/lock_ring.go`): consistent assignment of lock
    keys to filer servers by hash, over snapshots of the filer membership
  - `DistributedLockManager` (`lock_manager/distributed_lock_manager.go`):
    TTL'd exclusive locks with renew tokens; a non-owning host answers with
    the address that does own the key so clients can re-target

The filer hosts the DLM over HTTP (`/__dlm__/lock`, `/__dlm__/unlock`);
gateway/mount/mq code uses it for exclusive client names and balancer
leadership, same as the reference.

The port's copy of `seaweedfs_tpu/cluster/__init__.py`, over the port's
`server/httpd.py`.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import uuid

from ..server.httpd import http_request


class LockRing:
    """Key -> server assignment by rendezvous hashing over the current
    membership snapshot (the reference keeps dated snapshots to tolerate
    membership churn; rendezvous hashing gives the same stability with
    no snapshot bookkeeping)."""

    def __init__(self, servers: list[str] | None = None) -> None:
        self._servers: list[str] = list(servers or [])
        self._lock = threading.Lock()

    def set_servers(self, servers: list[str]) -> None:
        with self._lock:
            self._servers = sorted(set(servers))

    def servers(self) -> list[str]:
        with self._lock:
            return list(self._servers)

    def server_for(self, key: str) -> str | None:
        with self._lock:
            if not self._servers:
                return None
            return max(
                self._servers,
                key=lambda s: hashlib.sha1(f"{s}|{key}".encode()).digest(),
            )

    def ranked_for(self, key: str, n: int) -> list[str]:
        """Top-n servers for the key by rendezvous rank — rank 0 is the
        owner, ranks 1.. are its natural followers (when membership
        changes, a follower is the next owner, which is what makes
        follower replication survive owner loss)."""
        with self._lock:
            ranked = sorted(
                self._servers,
                key=lambda s: hashlib.sha1(f"{s}|{key}".encode()).digest(),
                reverse=True,
            )
            return ranked[:n]


class LockEntry:
    __slots__ = ("key", "owner", "token", "expires_at")

    def __init__(self, key: str, owner: str, token: str, expires_at: float):
        self.key = key
        self.owner = owner
        self.token = token
        self.expires_at = expires_at


class DistributedLockManager:
    """TTL'd exclusive locks (`distributed_lock_manager.go`): lock returns a
    renew token; re-locking with the token extends the TTL; a different
    owner gets refused until expiry."""

    def __init__(self, host: str = "") -> None:
        self.host = host
        self._locks: dict[str, LockEntry] = {}
        self._mu = threading.Lock()

    def lock(self, key: str, owner: str, ttl_sec: float,
             token: str = "") -> tuple[str, float]:
        """Returns (renew_token, expires_at); raises LockedError if held."""
        now = time.time()
        with self._mu:
            cur = self._locks.get(key)
            if cur is not None and cur.expires_at > now:
                if token and cur.token == token:
                    cur.expires_at = now + ttl_sec
                    cur.owner = owner
                    return cur.token, cur.expires_at
                if cur.owner == owner and not token:
                    # same owner reconnecting without its token: refuse like
                    # the reference (token is the fencing mechanism)
                    raise LockedError(key, cur.owner)
                raise LockedError(key, cur.owner)
            new_token = token or str(uuid.uuid4())
            self._locks[key] = LockEntry(key, owner, new_token, now + ttl_sec)
            return new_token, now + ttl_sec

    def unlock(self, key: str, token: str) -> bool:
        with self._mu:
            cur = self._locks.get(key)
            if cur is None:
                return True
            if cur.token != token and cur.expires_at > time.time():
                raise LockedError(key, cur.owner)
            del self._locks[key]
            return True

    def owner_of(self, key: str) -> str | None:
        with self._mu:
            cur = self._locks.get(key)
            if cur is None or cur.expires_at <= time.time():
                return None
            return cur.owner

    def sweep(self) -> int:
        """Drop expired locks; returns how many were dropped."""
        now = time.time()
        with self._mu:
            dead = [k for k, e in self._locks.items() if e.expires_at <= now]
            for k in dead:
                del self._locks[k]
            return len(dead)


class LockedError(Exception):
    def __init__(self, key: str, owner: str) -> None:
        super().__init__(f"lock {key!r} held by {owner!r}")
        self.key = key
        self.owner = owner


class LockClient:
    """Client side of the filer-hosted DLM: follows `moved_to` redirects to
    the ring owner and renews in the background
    (`lock_manager/lock_client.go`)."""

    def __init__(self, filer_url: str, owner: str) -> None:
        self.filer_url = filer_url.rstrip("/")
        self.owner = owner

    def _post(self, url: str, payload: dict) -> tuple[int, dict]:
        status, _, body = http_request(
            "POST", url, body=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            return status, json.loads(body) if body else {}
        except ValueError:
            return status, {}

    def lock(self, key: str, ttl_sec: float = 30.0,
             token: str = "") -> tuple[str, str]:
        """Returns (serving_filer_url, token). Raises LockedError if held."""
        url = self.filer_url
        for _ in range(4):  # follow ring redirects
            status, out = self._post(
                f"{url}/__dlm__/lock",
                {"key": key, "owner": self.owner, "ttl_sec": ttl_sec,
                 "token": token},
            )
            if status == 307 and out.get("moved_to"):
                url = out["moved_to"].rstrip("/")
                continue
            if status == 409:
                raise LockedError(key, out.get("owner", "?"))
            if status != 200:
                raise IOError(f"dlm lock {key}: {status} {out}")
            return url, out["token"]
        raise IOError(f"dlm lock {key}: redirect loop")

    def unlock(self, key: str, token: str, url: str | None = None) -> None:
        target = (url or self.filer_url).rstrip("/")
        for _ in range(4):
            status, out = self._post(
                f"{target}/__dlm__/unlock", {"key": key, "token": token}
            )
            if status == 307 and out.get("moved_to"):
                target = out["moved_to"].rstrip("/")
                continue
            if status == 409:
                raise LockedError(key, out.get("owner", "?"))
            return
