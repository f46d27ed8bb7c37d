"""Master/volume client with cached volume locations (reference:
`weed/wdclient/masterclient.go`, `vid_map.go:37`, `weed/operation/`).

The reference keeps the vid->locations cache fresh by a KeepConnected push
stream; this build refreshes by lookup-on-miss with a TTL, which the filer's
request patterns amortize the same way.

The port's copy of `seaweedfs_tpu/filer/wdclient.py`, over the port's
master (`/dir/assign`, `/dir/lookup`) and volume servers. Writes carry the
assign's `auth` write token; with `read_jwt_key` every chunk fetch signs a
read token for its fid, and with `jwt_key` a delete signs a wildcard token
(an empty fid claim), as the reference's filer does with its copies of the
security.toml keys.
"""

from __future__ import annotations

import json
import random
import threading
import time

from ..security.jwt import encode_jwt, gen_read_jwt
from ..server.httpd import PooledHTTP, http_request, peer_url
from ..util import faults
from ..util.retry import READ_POLICY, RetryPolicy

# the filer -> volume chunk relay seam: latency/error here is what the
# holder-retry ladder below must absorb without a client-visible failure
_FP_CHUNK = faults.register("filer.chunk.read")


class WeedClient:
    def __init__(
        self, master_url: str, cache_ttl: float = 30.0, jwt_key: str = "",
        read_jwt_key: str = "",
        retry: RetryPolicy | None = None,
    ) -> None:
        # comma-separated master list; requests follow leader hints
        # (`wdclient/masterclient.go` leader failover)
        self.masters = [
            peer_url(u).rstrip("/")
            for u in master_url.split(",") if u
        ]
        self.master_url = self.masters[0]
        self.cache_ttl = cache_ttl
        self.jwt_key = jwt_key  # the shared security.toml signing key
        # jwt.signing.read: the filer signs read tokens from its own copy,
        # as the reference does (`weed/security/jwt.go`)
        self.read_jwt_key = read_jwt_key
        self._vid_cache: dict[int, tuple[float, list[str]]] = {}
        self._lock = threading.Lock()
        # keep-alive for the hot data-plane hops (assign, chunk upload,
        # chunk fetch) — urllib's conn-per-call dominates small chunks
        self._pool = PooledHTTP()
        # the unified read-retry policy (exp backoff + jitter + deadline
        # budget): every holder is tried each round, the vid cache is
        # invalidated between rounds so a heal/move is picked up mid-retry
        self.retry = retry or READ_POLICY
        self.retried_reads = 0  # fetches that needed >1 round

    # --- assignment -------------------------------------------------------------
    def assign(
        self,
        count: int = 1,
        replication: str = "",
        collection: str = "",
        ttl: str = "",
        data_center: str = "",
        shard: str = "",
    ) -> dict:
        qs = f"count={count}"
        if replication:
            qs += f"&replication={replication}"
        if collection:
            qs += f"&collection={collection}"
        if ttl:
            qs += f"&ttl={ttl}"
        if data_center:
            qs += f"&dataCenter={data_center}"
        if shard:
            # "i:n" — constrain the pick to vids where vid % n == i
            qs += f"&shard={shard}"
        return self._master_get(f"/dir/assign?{qs}")

    def _master_get(self, path_qs: str) -> dict:
        """GET against the current master, following `raft.not.leader`
        hints and rotating through the configured master list."""
        rotation = [u for u in self.masters if u != self.master_url]
        last_err: Exception | None = None
        for _ in range(len(self.masters) + 2):
            try:
                status, _, body = self._pool.request(
                    "GET", self.master_url + path_qs
                )
                data = json.loads(body) if body else {}
            except Exception as e:
                last_err = e
                if rotation:
                    self.master_url = rotation.pop(0)
                    continue
                raise
            if status < 400:
                return data
            leader = data.get("leader")
            if data.get("error") == "raft.not.leader" and leader:
                self.master_url = leader.rstrip("/")
                continue
            raise IOError(f"GET {path_qs} -> {status}: {data}")
        raise last_err or IOError(f"GET {path_qs}: no master reachable")

    # --- lookup -----------------------------------------------------------------
    def lookup(self, vid: int) -> list[str]:
        now = time.time()
        with self._lock:
            hit = self._vid_cache.get(vid)
            if hit and hit[0] > now:
                return hit[1]
        info = self._master_get(f"/dir/lookup?volumeId={vid}")
        urls = [loc["publicUrl"] or loc["url"] for loc in info.get("locations", [])]
        if not urls:
            raise IOError(f"volume {vid} has no locations")
        with self._lock:
            self._vid_cache[vid] = (now + self.cache_ttl, urls)
        return urls

    def lookup_cached(self, vid: int) -> list[str] | None:
        """Cache-only peek: never touches the network. For callers running
        under locks that must not block on master latency."""
        now = time.time()
        with self._lock:
            hit = self._vid_cache.get(vid)
            return hit[1] if hit and hit[0] > now else None

    def lookup_file_id(self, file_id: str) -> list[str]:
        vid = int(file_id.split(",")[0])
        return [f"{peer_url(u)}/{file_id}" for u in self.lookup(vid)]

    def invalidate(self, vid: int) -> None:
        with self._lock:
            self._vid_cache.pop(vid, None)

    def assign_batch(
        self,
        n: int,
        replication: str = "",
        collection: str = "",
        ttl: str = "",
    ) -> tuple[list[str], str, str]:
        """ONE master assign (count=n) covering a whole chunked upload:
        returns (fids, location, auth) where fids are the base fid plus its
        `_1.._n-1` deltas, all on one volume (`weed/operation/assign_file_id`
        count semantics). Amortizes the per-chunk allocation RPC that
        dominated multi-chunk upload latency."""
        a = self.assign(
            count=n, replication=replication, collection=collection, ttl=ttl
        )
        if a.get("error"):
            raise IOError(a["error"])
        granted = int(a.get("count", n) or n)
        if granted < n:
            raise IOError(f"assign granted {granted} < {n} fids")
        fid = a["fid"]
        fids = [fid] + [f"{fid}_{i}" for i in range(1, n)]
        return fids, a["publicUrl"], a.get("auth", "")

    # --- blob ops ---------------------------------------------------------------
    def upload(
        self,
        data: bytes,
        replication: str = "",
        collection: str = "",
        ttl: str = "",
        filename: str = "",
        mime: str = "",
    ) -> dict:
        """assign + POST; returns {fid, size, eTag, url}
        (`weed/operation/upload_content.go`)."""
        a = self.assign(
            replication=replication, collection=collection, ttl=ttl
        )
        if "error" in a and a["error"]:
            raise IOError(a["error"])
        fid, url = a["fid"], a["publicUrl"]
        out = self.upload_to(
            fid, url, data, filename=filename, mime=mime, ttl=ttl,
            auth=a.get("auth", ""),
        )
        out["fid"] = fid
        out["url"] = url
        return out

    def upload_to(
        self,
        fid: str,
        location: str,
        data: bytes,
        filename: str = "",
        mime: str = "",
        ttl: str = "",
        auth: str = "",
    ) -> dict:
        headers = {}
        if filename:
            headers["X-File-Name"] = filename
        if mime:
            headers["Content-Type"] = mime
        if auth:
            headers["Authorization"] = f"BEARER {auth}"
        url = f"{peer_url(location)}/{fid}"
        if ttl:
            url += f"?ttl={ttl}"
        # fid-addressed uploads are idempotent: safe to retry a stale
        # keep-alive socket that died while this client sat idle
        status, _, body = self._pool.request("POST", url, data, headers,
                                             idempotent=True)
        if status >= 300:
            raise IOError(f"upload {fid} -> {status}: {body[:200]!r}")
        return json.loads(body)

    def fetch(self, file_id: str, range_header: str | None = None) -> bytes:
        """Chunk read with the unified RetryPolicy: each round tries every
        holder (shuffled), a failed round invalidates the location cache
        (a dead holder's entry must not outlive the outage), backs off
        with jitter and re-looks-up — a killed holder mid-read-storm
        surfaces as a retried read, not a client-visible error."""
        vid = int(file_id.split(",")[0])
        # the token names the base fid: the volume server strips a batched
        # assign's `_N` before it compares the claim (the JAX client signs
        # the whole fid, which no `_N` chunk's read passes)
        auth = (gen_read_jwt(self.read_jwt_key, file_id.split("_")[0])
                if self.read_jwt_key else "")
        policy = self.retry
        start = time.monotonic()
        attempt = 0
        saw_failure = False
        last_err: Exception | None = None
        while True:
            was_cached = self.lookup_cached(vid) is not None
            try:
                # the relay fault seam sits INSIDE the ladder: an error
                # injection here is a failed round the retries must
                # absorb, not a bypass of them
                _FP_CHUNK.hit()
                urls = self.lookup_file_id(file_id)
            except Exception as e:
                urls, last_err = [], e
                saw_failure = True
            random.shuffle(urls)
            all_404 = bool(urls)
            for url in urls:
                headers = {"Range": range_header} if range_header else {}
                if auth:
                    headers["Authorization"] = f"BEARER {auth}"
                try:
                    status, _, body = self._pool.request(
                        "GET", url, headers=headers
                    )
                except (IOError, OSError) as e:
                    last_err = e
                    saw_failure = True
                    all_404 = False
                    continue
                if status in (200, 206):
                    if attempt or saw_failure:
                        # served, but only after a holder failed us —
                        # the "retried, not failed" share of an outage
                        self.retried_reads += 1
                    return body
                saw_failure = True
                if status == 404:
                    # a 404 from a live holder is authoritative for THAT
                    # holder; another replica may still serve it
                    last_err = IOError(f"GET {url} -> 404")
                    continue
                all_404 = False
                last_err = IOError(f"GET {url} -> {status}")
                if 400 <= status < 500 and status != 429:
                    # deterministic rejection (bad request): every holder
                    # will answer the same — fail fast instead of burning
                    # the backoff ladder + master lookups
                    raise last_err
            if all_404:
                if was_cached:
                    # the 404s may only mean our CACHED holders are
                    # stale (the volume moved): one immediate
                    # fresh-lookup round before believing them
                    self.invalidate(vid)
                    saw_failure = True
                    continue
                # every freshly-looked-up holder answered 404: the blob
                # is GONE — retrying would only slow missing-key reads
                raise last_err
            delay = policy.delay(attempt)
            attempt += 1
            if not policy.should_retry(attempt, start, time.monotonic(), delay):
                raise last_err or IOError(f"no locations for {file_id}")
            self.invalidate(vid)
            time.sleep(delay)

    def delete(self, file_id: str) -> None:
        headers = {}
        if self.jwt_key:
            # a filer-signed wildcard token (empty fid claim), as the
            # reference's filer signs with its copy of the key
            token = encode_jwt(self.jwt_key, {"fid": "", "exp": int(time.time()) + 10})
            headers["Authorization"] = f"BEARER {token}"
        last_err: Exception | None = None
        for url in self.lookup_file_id(file_id):
            status, _, body = http_request("DELETE", url, headers=headers)
            if status < 300 or status == 404:  # 404 = already gone, idempotent
                return
            last_err = IOError(f"DELETE {url} -> {status}: {body[:200]!r}")
        raise last_err or IOError(f"no locations for {file_id}")

    def close(self) -> None:
        """Close the keep-alive connections of every thread."""
        self._pool.close()
