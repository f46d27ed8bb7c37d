"""MQ client library: Publisher + group Consumer.

Behavioral port of `weed/mq/client/pub_client/` and `sub_client/`: the
publisher discovers brokers through the master's cluster membership,
follows partition-ownership redirects (including balancer moves and the
503-retry window of a fenced move), and the consumer joins a consumer
group on the coordinating broker, heartbeats, tracks assignment versions,
and iterates messages from its assigned partitions with offset commits.

The port's copy of `seaweedfs_tpu/mq/client.py`, over the port's
`server/httpd.py`. Differences from the JAX package: `close()` also closes
the client's keep-alive connections, and a `Publisher` has one (the JAX
clients leave theirs to process exit); and `Consumer.poll` returns the
messages it fetched before a partition's fetch failed, where the JAX one
raises and drops them with their offsets already advanced, so that a
commit after the failure skips them for the whole group; and a broker
that dies mid-answer (`http.client.IncompleteRead`, `RemoteDisconnected`)
surfaces as `MQError` like any other transport failure, where the JAX
client lets the raw `http.client` exception through.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.parse

from ..server.httpd import PooledHTTP, get_json, peer_url


class MQError(IOError):
    pass


class _Base:
    _BROKER_TTL = 5.0

    def __init__(self, master_url: str = "", brokers: list[str] | None = None,
                 namespace: str = "default") -> None:
        self.master_url = peer_url(master_url).rstrip("/") if master_url else ""
        self._static_brokers = [peer_url(b).rstrip("/") for b in brokers or []]
        self.namespace = namespace
        self._pool = PooledHTTP()
        self._broker_cache: tuple[float, list[str]] = (0.0, [])
        # last-known owner per sticky key (e.g. partition) so hot paths
        # skip the redirect hop; invalidated on 307/transport error
        self._owner_memo: dict = {}

    def _brokers(self) -> list[str]:
        if self._static_brokers:
            return self._static_brokers
        ts, cached = self._broker_cache
        if cached and time.time() - ts < self._BROKER_TTL:
            return cached
        ps = get_json(f"{self.master_url}/cluster/ps")
        out = [b["address"] for b in ps.get("brokers") or []]
        if not out:
            raise MQError("no live mq brokers registered")
        self._broker_cache = (time.time(), out)
        return out

    def _follow(self, method: str, path: str, payload: dict | None = None,
                memo_key=None, retries: int = 8) -> dict:
        """Issue to a broker, following moved_to redirects and the
        503-retry window of a fenced partition move; transport errors on
        pooled keep-alive sockets get one fresh-connection retry and
        surface as MQError, never raw OSError."""
        url = self._owner_memo.get(memo_key) or self._brokers()[0]
        body = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if body else None
        transport_retried = False
        for _ in range(retries):
            try:
                status, _, raw = self._pool.request(method, url + path, body,
                                                    headers)
            except (OSError, http.client.HTTPException) as e:
                # idle keep-alive socket died server-side: one clean retry
                if not transport_retried:
                    transport_retried = True
                    continue
                self._owner_memo.pop(memo_key, None)
                raise MQError(f"{path}: {e}") from e
            out = json.loads(raw) if raw else {}
            if status == 307 and out.get("moved_to"):
                url = peer_url(out["moved_to"]).rstrip("/")
                if memo_key is not None:
                    self._owner_memo[memo_key] = url
                continue
            if status == 503 and out.get("retry"):
                time.sleep(0.2)
                continue
            if status >= 400:
                self._owner_memo.pop(memo_key, None)
                raise MQError(f"{path} -> {status}: {out}")
            if memo_key is not None:
                self._owner_memo[memo_key] = url
            return out
        raise MQError(f"{path}: did not settle after {retries} tries")

    def _qs(self, **params) -> str:
        return urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None}
        )

    def close(self) -> None:
        """Close every connection this client opened."""
        self._pool.close()


class Publisher(_Base):
    """`pub_client`: create topics, publish records with key routing."""

    def create_topic(self, topic: str, partition_count: int = 4,
                     replication: int = 0, schema: dict | None = None) -> dict:
        payload: dict = {
            "namespace": self.namespace, "topic": topic,
            "partition_count": partition_count, "replication": replication,
        }
        if schema is not None:
            payload["schema"] = schema
        try:
            return self._follow("POST", "/topics/create", payload, retries=2)
        except MQError as e:
            if "409" in str(e):
                return {"ok": True, "existed": True}
            raise

    def publish(self, topic: str, value, key: str = "",
                partition: int | None = None) -> dict:
        payload: dict = {
            "namespace": self.namespace, "topic": topic, "key": key,
            "value": value,
        }
        if partition is not None:
            payload["partition"] = partition
        memo = (topic, partition) if partition is not None else None
        return self._follow("POST", "/publish", payload, memo_key=memo)


class Consumer(_Base):
    """`sub_client`: join a consumer group, heartbeat, read the assigned
    partitions, commit offsets. `poll()` returns a batch of messages from
    the current assignment; `commit()` persists progress for partitions
    this instance actually consumed."""

    HEARTBEAT_EVERY = 3.0

    def __init__(self, topic: str, group: str, master_url: str = "",
                 brokers: list[str] | None = None,
                 namespace: str = "default",
                 instance_id: str | None = None) -> None:
        super().__init__(master_url, brokers, namespace)
        self.topic = topic
        self.group = group
        self._coord = ("coord",)  # owner memo key for coordinator calls
        out = self._follow("POST", "/consumer/join", {
            "namespace": namespace, "topic": topic, "group": group,
            **({"instance_id": instance_id} if instance_id else {}),
        }, memo_key=self._coord)
        self.instance_id = out["instance_id"]
        self.version = out["version"]
        self.partitions: list[int] = out["partitions"]
        self._offsets: dict[int, int] = {}
        self._polled: set[int] = set()  # partitions THIS instance consumed
        self._last_hb = time.time()
        self._load_committed(self.partitions)

    def _load_committed(self, partitions) -> None:
        """Adopt the group's committed offsets for `partitions` (at join
        and for every partition gained in a rebalance — another instance
        may have advanced them since our join-time snapshot)."""
        qs = self._qs(namespace=self.namespace, topic=self.topic,
                      group=self.group)
        out = self._follow("GET", f"/offsets?{qs}", memo_key=self._coord)
        committed = {int(k): int(v)
                     for k, v in (out.get("offsets") or {}).items()}
        for k in partitions:
            if k in committed:
                self._offsets[k] = committed[k]

    @staticmethod
    def _is_unknown_group(e: Exception) -> bool:
        return "404" in str(e) and "unknown group" in str(e)

    def _rejoin(self) -> None:
        """The group coordinator moved (broker join/leave changes the hash
        ring) or restarted: group state is coordinator-memory, so the new
        coordinator answers 404 'unknown group'. Re-join under the SAME
        instance id and continue — a routine membership change must not
        kill the consumer. Offsets: partitions kept across the re-join
        resume from the local position (no re-delivery); gained ones adopt
        the group's committed offsets (at-least-once, as on any rebalance)."""
        self._owner_memo.pop(self._coord, None)
        kept = set(self.partitions)
        out = self._follow("POST", "/consumer/join", {
            "namespace": self.namespace, "topic": self.topic,
            "group": self.group, "instance_id": self.instance_id,
        }, memo_key=self._coord)
        self.version = out["version"]
        self.partitions = out["partitions"]
        self._polled &= set(self.partitions)
        gained = [k for k in self.partitions if k not in kept]
        if gained:
            self._load_committed(gained)
        self._last_hb = time.time()

    def _heartbeat(self) -> None:
        try:
            out = self._follow("POST", "/consumer/heartbeat", {
                "namespace": self.namespace, "topic": self.topic,
                "group": self.group, "instance_id": self.instance_id,
            }, memo_key=self._coord)
        except MQError as e:
            if self._is_unknown_group(e):
                self._rejoin()
                return
            raise
        if out.get("version", self.version) != self.version:
            qs = self._qs(namespace=self.namespace, topic=self.topic,
                          group=self.group, instance_id=self.instance_id)
            try:
                a = self._follow("GET", f"/consumer/assignments?{qs}",
                                 memo_key=self._coord)
            except MQError as e:
                if self._is_unknown_group(e):
                    self._rejoin()
                    return
                raise
            gained = [k for k in a["partitions"] if k not in self.partitions]
            self.version = a["version"]
            self.partitions = a["partitions"]
            self._polled &= set(self.partitions)
            if gained:
                self._load_committed(gained)
        self._last_hb = time.time()

    def poll(self, limit_per_partition: int = 256,
             wait: float = 0.0) -> list[dict]:
        """One pass over the assigned partitions; each message dict gains
        a 'partition' field. Offsets advance in-memory; call commit() to
        persist them for the group. `wait` (long-poll) is capped so the
        coordinator's member TTL cannot expire this instance mid-poll.
        A partition whose fetch fails keeps its offset for the next poll,
        and the messages already fetched in this pass are returned; the
        error is raised only when the pass fetched nothing."""
        wait = min(wait, self.HEARTBEAT_EVERY / 2)
        out: list[dict] = []
        failed: MQError | None = None
        for k in list(self.partitions):
            try:
                if time.time() - self._last_hb > self.HEARTBEAT_EVERY:
                    self._heartbeat()
                    if k not in self.partitions:  # rebalanced away mid-pass
                        continue
                offset = self._offsets.get(k, 0)
                qs = self._qs(namespace=self.namespace, topic=self.topic,
                              partition=k, offset=offset,
                              limit=limit_per_partition, wait=wait)
                resp = self._follow("GET", f"/subscribe?{qs}",
                                    memo_key=(self.topic, k))
            except MQError as e:
                failed = failed or e
                continue
            msgs = resp.get("messages", [])
            for m in msgs:
                m["partition"] = k
            if msgs:
                self._offsets[k] = msgs[-1]["offset"] + 1
                self._polled.add(k)
            out.extend(msgs)
        if time.time() - self._last_hb > self.HEARTBEAT_EVERY:
            try:
                self._heartbeat()
            except MQError as e:
                failed = failed or e
        if failed is not None and not out:
            raise failed
        return out

    def commit(self) -> None:
        """Persist offsets ONLY for partitions this instance consumed —
        writing the whole join-time snapshot would overwrite other
        members' newer commits. Survives a coordinator move mid-commit
        (re-join once, retry the partition on the new coordinator)."""
        for k in sorted(self._polled):
            # membership re-checked FRESH each iteration: a mid-loop
            # _rejoin may shrink self.partitions, and committing for a
            # partition now owned elsewhere would regress the new owner's
            # offsets
            if k not in self.partitions:
                continue
            payload = {
                "namespace": self.namespace, "topic": self.topic,
                "group": self.group, "partition": k,
                "offset": self._offsets[k],
            }
            try:
                self._follow("POST", "/offsets/commit", payload,
                             memo_key=self._coord)
            except MQError as e:
                if not self._is_unknown_group(e):
                    raise
                self._rejoin()
                if k in self.partitions:
                    self._follow("POST", "/offsets/commit", payload,
                                 memo_key=self._coord)

    def close(self) -> None:
        try:
            self._follow("POST", "/consumer/leave", {
                "namespace": self.namespace, "topic": self.topic,
                "group": self.group, "instance_id": self.instance_id,
            }, memo_key=self._coord, retries=2)
        except MQError:
            pass
        super().close()
