"""MQ broker server (`weed/mq/broker/broker_server.go:53`).

HTTP surface (the reference speaks gRPC `SeaweedMessaging`; verbs match):
  POST /topics/create   {namespace, topic, partition_count[, replication,
                         schema]}
  GET  /topics/list
  GET  /topics/describe?namespace=&topic=
  POST /publish         {namespace, topic, key, value[, partition]}
  GET  /subscribe       ?namespace=&topic=&partition=&offset=&limit=&wait=
  POST /offsets/commit  {namespace, topic, group, partition, offset}
  GET  /offsets         ?namespace=&topic=&group=
  POST /flush           (force segment flush — tests/shutdown)
  POST /follow/append   (owner -> follower replication; ack-before-commit)

Follower replication (`weed/mq/broker/broker_grpc_pub_follow.go`): with
topic replication=R, the partition owner synchronously copies each publish
to the next R brokers in rendezvous-rank order and acks the publisher only
after every follower acked. A follower holds the replica tail in memory;
when the ring reassigns a dead owner's partition, the new owner — by
construction the rank-1 follower — adopts its replica and flushes it to
segments before serving, so acked messages survive owner loss.

The port's copy of `seaweedfs_tpu/mq/broker.py`, over the port's
`FilerClient`, `LockRing` and `server/httpd.py`. Difference from the JAX
package: `stop()` also closes the broker's keep-alive connections to the
filer (the port's `FilerClient` pools them; the JAX one opens one a call);
a follower append rides a keep-alive connection of the follower pool's
thread, where the JAX broker opens a connection a replicated publish (on
one host that churned a connection a message through the accept loops,
and connects stalled past 10 s);
and `TopicPartition.flush` keeps a batch in the tail until its segment is
written, where the JAX one drops it first, so that a read in between skips
the batch for good and a failed segment write loses it; and a heartbeat
from a member the coordinator does not hold answers 404 `unknown group`
(the consumer re-joins), where the JAX coordinator adds it silently, so
that after a coordinator change two consumers could keep one assignment
(their versions come from different counts and can be equal) and leave
the other partitions unread.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import random
import threading
import time

from ..cluster import LockRing
from ..filer.filer_client import FilerClient
from ..server.httpd import (
    HTTPService,
    PooledHTTP,
    Request,
    Response,
    peer_url,
    post_json,
)
from .schema import SchemaError, validate_record, validate_schema_def

TOPICS_DIR = "/topics"
SEGMENT_FLUSH_COUNT = 512  # messages buffered per partition before flush


class ReplicationError(Exception):
    """Followers did not ack: the message was NOT committed."""

    def __init__(self, offset: int) -> None:
        super().__init__(f"no follower ack for offset {offset}")
        self.offset = offset


class PartitionReleased(Exception):
    """Ownership moved away mid-request; the caller must re-resolve."""


class TopicPartition:
    """In-memory tail of one partition; segments hold the flushed prefix."""

    def __init__(self, base_dir: str, fc: FilerClient) -> None:
        self.base_dir = base_dir  # /topics/<ns>/<topic>/p<k>
        self.fc = fc
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        # serializes publishes so an offset can be replicated to followers
        # BEFORE it is committed to the tail (ack-before-commit)
        self.pub_lock = threading.Lock()
        self.released = False  # set once ownership moved away; appends must fail
        # one flush at a time; the messages it is writing stay in the tail
        # (readable, and kept if the write fails) until their segment exists
        self._flush_mu = threading.Lock()
        self._flushing = 0
        self.tail: list[dict] = []  # unflushed messages
        self.tail_start = 0  # offset of tail[0]
        self._load_flushed_extent()

    def _segments(self) -> list[tuple[int, int, str]]:
        out = []
        listing = self.fc.list(self.base_dir)
        for e in listing.get("Entries") or []:
            name = e["FullPath"].rsplit("/", 1)[-1]
            if not name.endswith(".log"):
                continue
            try:
                start_s, end_s = name[:-4].split("-")
                out.append((int(start_s), int(end_s), e["FullPath"]))
            except ValueError:
                continue
        out.sort()
        return out

    def _load_flushed_extent(self) -> None:
        try:
            segs = self._segments()
        except Exception:
            segs = []
        self.tail_start = segs[-1][1] + 1 if segs else 0

    def append(self, key: str, value, ts_ns: int | None = None) -> int:
        return self.publish(key, value, replicate=None, ts_ns=ts_ns)

    def publish(
        self, key: str, value, replicate=None, ts_ns: int | None = None
    ) -> int:
        """Serialized publish. With `replicate` (msg -> bool), the message
        is handed to followers FIRST and committed to the tail only after
        they acked — a failed replication commits nothing and subscribers
        never see the offset (`broker_grpc_pub_follow.go` semantics).
        Raises ReplicationError when followers don't ack."""
        with self.pub_lock:
            if self.released:
                raise PartitionReleased()
            with self.lock:
                offset = self.tail_start + len(self.tail)
            msg = {
                "offset": offset, "key": key, "value": value,
                "ts_ns": ts_ns or time.time_ns(),
            }
            if replicate is not None and not replicate(msg):
                raise ReplicationError(offset)
            with self.cond:
                self.tail.append(msg)
                self.cond.notify_all()
                need_flush = len(self.tail) - self._flushing >= SEGMENT_FLUSH_COUNT
        if need_flush:
            self.flush()
        return offset

    def flush(self) -> int:
        """Persist the in-memory tail as one segment file. The batch leaves
        the tail only once its segment is written: a reader never finds it
        in neither place, and a failed write loses nothing."""
        with self._flush_mu:
            with self.lock:
                if not self.tail:
                    return 0
                batch = list(self.tail)
                start = self.tail_start
                self._flushing = len(batch)
            end = start + len(batch) - 1
            body = "\n".join(json.dumps(m) for m in batch).encode()
            try:
                self.fc.put(f"{self.base_dir}/{start:020d}-{end:020d}.log", body,
                            content_type="application/json")
            finally:
                with self.lock:
                    self._flushing = 0
            with self.lock:
                del self.tail[:len(batch)]
                self.tail_start = end + 1
            return len(batch)

    def read(self, offset: int, limit: int = 1024,
             wait: float = 0.0) -> list[dict]:
        out: list[dict] = []
        with self.lock:
            tail_start = self.tail_start
        if offset < tail_start:
            # serve the flushed prefix from segments
            for start, end, path in self._segments():
                if end < offset or len(out) >= limit:
                    continue
                body = self.fc.read(path)
                for line in body.decode().splitlines():
                    m = json.loads(line)
                    if m["offset"] >= offset and len(out) < limit:
                        out.append(m)
        with self.cond:
            if not out and wait > 0 and offset >= self.tail_start + len(self.tail):
                self.cond.wait(wait)
            # a batch written to a segment while this read ran is in both
            nxt = out[-1]["offset"] + 1 if out else offset
            for m in self.tail:
                if m["offset"] >= nxt and len(out) < limit:
                    out.append(m)
        return out

    def adopt(self, replica: list[dict]) -> int:
        """Fold a follower replica in after taking ownership: keep only
        messages past the flushed extent, then flush for durability.
        Takes pub_lock so an in-flight publish can't interleave offsets."""
        with self.pub_lock:
            with self.lock:
                known = self.tail_start + len(self.tail)
                added = 0
                for m in sorted(replica, key=lambda m: m["offset"]):
                    if m["offset"] == known:
                        self.tail.append(m)
                        known += 1
                        added += 1
        if added:
            self.flush()
        return added

    def high_water_mark(self) -> int:
        with self.lock:
            return self.tail_start + len(self.tail)


class BrokerServer:
    def __init__(self, filer_url: str, master_url: str = "",
                 host: str = "127.0.0.1", port: int = 17777,
                 peers: list[str] | None = None) -> None:
        self.fc = FilerClient(filer_url)
        # scheme-qualify: the CLI passes bare host:port, and a silent
        # registration failure would leave the broker invisible to
        # cluster/ps (and every client using master discovery)
        self.master_url = peer_url(master_url).rstrip("/") if master_url else ""
        self.service = HTTPService(host, port)
        self.ring = LockRing()
        self._static_peers = list(peers or [])
        self._partitions: dict[str, TopicPartition] = {}
        # follower replica tails: partition key -> {offset: message}
        self._replicas: dict[str, dict[int, dict]] = {}
        self._plock = threading.Lock()
        # balancer assignment overrides cache: "ns/topic" -> (ts, dict)
        self._assign_cache: dict[str, tuple[float, dict]] = {}
        # fenced partitions: mid-move quiesce (key -> fence deadline)
        self._fenced: dict[str, float] = {}
        # sub-coordinator state for groups this broker coordinates:
        # "ns/topic/group" -> {"members": {id: last_seen},
        #                      "assign": {partition: id}, "version": int}
        self._groups: dict[str, dict] = {}
        self._glock = threading.Lock()
        # one long-lived pool for follower fan-out: per-publish executors
        # would pay thread spawn inside pub_lock and stall process exit
        self._repl_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="mq-follow"
        )
        # its keep-alive connections to the followers, one a pool thread
        self._follow_http = PooledHTTP(timeout=3)
        self._stop = threading.Event()
        self._routes()

    def start(self) -> None:
        self.service.start()
        self.ring.set_servers(self._static_peers + [self.url])
        if self.master_url:
            self._register_once()
            threading.Thread(target=self._register_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        self.flush_all()
        self.service.stop()
        self._repl_pool.shutdown(wait=False, cancel_futures=True)
        self._follow_http.close()
        self.fc.close()

    @property
    def url(self) -> str:
        return self.service.url

    # --- membership -----------------------------------------------------------
    def _register_once(self) -> None:
        try:
            post_json(f"{self.master_url}/cluster/register",
                      {"type": "broker", "address": self.url}, timeout=5)
        except Exception:
            pass

    def _register_loop(self) -> None:
        while not self._stop.wait(5.0):
            self._register_once()

    # --- topic/partition helpers ----------------------------------------------
    @staticmethod
    def _topic_dir(ns: str, topic: str) -> str:
        return f"{TOPICS_DIR}/{ns}/{topic}"

    def _topic_conf(self, ns: str, topic: str) -> dict | None:
        e = self.fc.get_entry(f"{self._topic_dir(ns, topic)}/topic.conf")
        if e is None:
            return None
        raw = e.get("content", "")
        try:
            return json.loads(bytes.fromhex(raw)) if raw else None
        except ValueError:
            return None

    def _partition(self, ns: str, topic: str, k: int) -> TopicPartition:
        key = f"{ns}/{topic}/p{k:04d}"
        # resolve ownership BEFORE _plock: _assignments may do a filer GET
        # and a slow filer must not serialize every partition operation
        owner = self._owner_of(ns, topic, k)
        with self._plock:
            tp = self._partitions.get(key)
            created = tp is None
            if created:
                tp = TopicPartition(
                    f"{self._topic_dir(ns, topic)}/p{k:04d}", self.fc
                )
            # adopt a held follower replica whenever the ring says this
            # broker owns the partition — including a partition that was
            # pre-created while following (e.g. by /topics/describe) and
            # only now gained ownership. A describe on a follower must NOT
            # adopt (it would fork a second flusher), hence the owner gate.
            replica = None
            if owner is None or owner == self.url:
                replica = self._replicas.pop(key, None)
            if created:
                # adopt BEFORE the partition becomes visible: a concurrent
                # publish grabbing it pre-adoption would burn the offsets
                if replica:
                    tp.adopt(list(replica.values()))
                self._partitions[key] = tp
        if not created and replica:
            tp.adopt(list(replica.values()))  # adopt() takes pub_lock itself
        return tp

    def _followers_of(self, ns: str, topic: str, k: int, r: int) -> list[str]:
        ranked = self.ring.ranked_for(f"{ns}/{topic}/p{k}", 1 + r)
        return [s for s in ranked[1:] if s != self.url]

    def _assignments(self, ns: str, topic: str) -> dict:
        """Balancer-written ownership overrides (`pub_balancer/balance.go`
        moves); cached briefly, falling back to the rendezvous ring."""
        key = f"{ns}/{topic}"
        now = time.time()
        cached = self._assign_cache.get(key)
        if cached and now - cached[0] < 2.0:
            return cached[1]
        out: dict = {}
        e = self.fc.get_entry(f"{self._topic_dir(ns, topic)}/assignments.json")
        if e is not None:
            raw = e.get("content", "")
            try:
                out = json.loads(bytes.fromhex(raw)) if raw else {}
            except ValueError:
                out = {}
        self._assign_cache[key] = (now, out)
        return out

    def _owner_of(self, ns: str, topic: str, k: int) -> str | None:
        assigned = self._assignments(ns, topic).get(str(k))
        if assigned and assigned in self.ring.servers():
            return assigned
        # no override, or the assigned broker died: rendezvous decides
        # (the balancer's repair pass clears dead assignments durably)
        return self.ring.server_for(f"{ns}/{topic}/p{k}")

    def flush_all(self) -> None:
        with self._plock:
            parts = list(self._partitions.values())
        for tp in parts:
            try:
                tp.flush()
            except Exception:
                pass

    def _iter_topics(self):
        """Yield (namespace, topic) for every topic in the filer — the one
        directory walk shared by /topics/list and the balancer."""
        for ns_e in self.fc.list(TOPICS_DIR).get("Entries") or []:
            if not ns_e["IsDirectory"]:
                continue
            ns = ns_e["FullPath"].rsplit("/", 1)[-1]
            if ns.startswith("."):
                continue  # .system metadata log
            for t_e in self.fc.list(ns_e["FullPath"]).get("Entries") or []:
                if t_e["IsDirectory"]:
                    yield ns, t_e["FullPath"].rsplit("/", 1)[-1]

    # --- pub balancer (`weed/mq/pub_balancer/`) --------------------------------
    def _all_partitions(self) -> list[tuple[str, str, int]]:
        out = []
        for ns, topic in self._iter_topics():
            conf = self._topic_conf(ns, topic)
            if conf:
                for k in range(conf["partition_count"]):
                    out.append((ns, topic, k))
        return out

    def _write_assignment(self, ns: str, topic: str, k: int,
                          broker: str | None) -> None:
        path = f"{self._topic_dir(ns, topic)}/assignments.json"
        assigns = dict(self._assignments(ns, topic))
        if broker is None:
            assigns.pop(str(k), None)
        else:
            assigns[str(k)] = broker
        self.fc.put(path, json.dumps(assigns).encode(),
                    content_type="application/json")
        self._assign_cache.pop(f"{ns}/{topic}", None)

    def _release_partition(self, ns: str, topic: str, k: int,
                           fence: bool = False, ttl: float = 10.0) -> bool:
        """Flush + drop the in-memory partition so a new owner adopts a
        durable view (the move half of `balance_action.go`). pub_lock
        serializes with in-flight publishes, and the released flag makes
        any publisher that slipped past the owner check fail + re-resolve
        instead of appending to the orphan. With fence=True the partition
        also rejects publishes (503) until unfenced — the balancer RENEWS
        the fence on every release round (each call resets the deadline)
        and takes a long lease for the assignment-write phase, so a slow
        filer cannot outlive it; a dead balancer's fence releases via the
        owner check in _is_fenced. Returns whether a partition was held."""
        key = f"{ns}/{topic}/p{k:04d}"
        if fence:
            self._fenced[key] = time.time() + ttl
        with self._plock:
            tp = self._partitions.pop(key, None)
        if tp is not None or fence:
            # a no-op release on a non-owner (every misrouted publish)
            # must not bust the assignment cache — that would force a
            # filer GET of assignments.json per misrouted request
            self._assign_cache.pop(f"{ns}/{topic}", None)
        if tp is not None:
            with tp.pub_lock:
                tp.flush()
                tp.released = True
        return tp is not None

    def _is_fenced(self, ns: str, topic: str, k: int) -> bool:
        key = f"{ns}/{topic}/p{k:04d}"
        deadline = self._fenced.get(key)
        if deadline is None:
            return False
        if time.time() > deadline:
            # lease lapsed: release-on-crash via OWNER CHECK, not blindly.
            # If the durable assignment says another broker owns this
            # partition, the move completed (or is completing) — stay out
            # of the write path (the publish handler will redirect). Only
            # when the assignment still points here (or nowhere) did the
            # balancer die mid-move, and serving resumes safely.
            self._assign_cache.pop(f"{ns}/{topic}", None)
            try:
                self._owner_of(ns, topic, k)  # re-read the durable truth
            except Exception:
                return True  # filer unreachable: stay safe, stay fenced
            self._fenced.pop(key, None)
            # the publish handler's owner check (now against the fresh
            # assignment) redirects if the move completed elsewhere
            return False
        return True

    def _unfence(self, ns: str, topic: str, k: int) -> None:
        self._fenced.pop(f"{ns}/{topic}/p{k:04d}", None)

    def balance_once(self) -> dict | None:
        """One balancing action (`balance_brokers.go`
        BalanceTopicPartitionOnBrokers): move a partition from the most- to
        the least-loaded broker when the spread exceeds 1; dead-broker
        assignments are repaired first (`repair.go`)."""
        alive = self.ring.servers()
        parts = self._all_partitions()
        # repair first — it matters precisely when brokers died
        for ns, topic, k in parts:
            assigned = self._assignments(ns, topic).get(str(k))
            if assigned and assigned not in alive:
                self._write_assignment(ns, topic, k, None)
        if len(alive) < 2:
            return None
        loads: dict[str, list] = {b: [] for b in alive}
        for ns, topic, k in parts:
            owner = self._owner_of(ns, topic, k)
            if owner in loads:
                loads[owner].append((ns, topic, k))
        source = max(loads, key=lambda b: len(loads[b]))
        target = min(loads, key=lambda b: len(loads[b]))
        if len(loads[source]) - len(loads[target]) <= 1:
            return None
        ns, topic, k = random.choice(loads[source])
        # move protocol: fence the source (new publishes 503 immediately),
        # quiesce in-flight stragglers until no local partition remains —
        # every round RENEWS the fence lease — then take one LONG lease
        # (60s) covering the durable assignment write, and unfence. The
        # target can never adopt an extent missing an acked message, and a
        # source that outlives an expired short lease re-checks the durable
        # assignment before serving (_is_fenced owner check), so a slow
        # filer between quiesce and write cannot strand acked publishes.
        source_down = False
        try:
            for _ in range(5):
                out = post_json(f"{source}/partition/release",
                                {"namespace": ns, "topic": topic,
                                 "partition": k, "fence": True}, timeout=10)
                if not out.get("had"):
                    break
        except Exception:
            source_down = True  # its flushed segments are all there is
        if not source_down:
            # write-phase lease: the fc.put below may stall on a slow
            # filer; the fence must outlive it. Taken OUTSIDE the quiesce
            # try — if the source is alive but won't grant the long lease,
            # ABORT the move rather than write under a 10s fence that a
            # stall could outlive (double-serve window).
            try:
                post_json(f"{source}/partition/release",
                          {"namespace": ns, "topic": topic, "partition": k,
                           "fence": True, "ttl": 60.0}, timeout=10)
            except Exception:
                try:
                    post_json(f"{source}/partition/unfence",
                              {"namespace": ns, "topic": topic,
                               "partition": k}, timeout=10)
                except Exception:
                    pass
                return None
        self._write_assignment(ns, topic, k, target)
        try:
            post_json(f"{source}/partition/unfence",
                      {"namespace": ns, "topic": topic, "partition": k},
                      timeout=10)
        except Exception:
            pass  # fence releases via the owner check once it expires
        return {"namespace": ns, "topic": topic, "partition": k,
                "from": source, "to": target}

    # --- sub coordinator (`weed/mq/sub_coordinator/`) --------------------------
    _MEMBER_TTL = 10.0

    def _group_key(self, ns: str, topic: str, group: str) -> str:
        return f"{ns}/{topic}/{group}"

    def _group_coordinator(self, key: str) -> str | None:
        return self.ring.server_for(f"group/{key}")

    def _rebalance_group(self, state: dict, count: int) -> None:
        """Sticky assignment (`partition_consumer_mapping.go`
        doBalanceSticky): members keep their partitions; orphaned slots go
        to the least-loaded members."""
        now = time.time()
        state["members"] = {
            m: ts for m, ts in state["members"].items()
            if now - ts < self._MEMBER_TTL
        }
        members = sorted(state["members"])
        old = state.get("assign", {})
        assign: dict[int, str] = {}
        per: dict[str, int] = {m: 0 for m in members}
        if members:
            # cap sticky keeps at the fair ceiling — the reference's fill
            # pass alone would leave a new joiner idle until slots free up,
            # defeating its own "max processing power utilization" goal
            ceiling = -(-count // len(members))
            for k in range(count):
                prev = old.get(k)
                if prev in per and per[prev] < ceiling:
                    assign[k] = prev
                    per[prev] += 1
            for k in range(count):
                if k not in assign:
                    m = min(members, key=lambda x: per[x])
                    assign[k] = m
                    per[m] += 1
        if assign != old:
            state["version"] = state.get("version", 0) + 1
        state["assign"] = assign

    # --- routes ----------------------------------------------------------------
    def _routes(self) -> None:
        svc = self.service

        @svc.route("POST", r"/topics/create")
        def topics_create(req: Request) -> Response:
            p = req.json()
            ns, topic = p.get("namespace", "default"), p["topic"]
            count = int(p.get("partition_count", 4))
            replication = int(p.get("replication", 0))
            conf = {
                "namespace": ns, "topic": topic, "partition_count": count,
                "replication": replication, "created_ts": time.time(),
            }
            if p.get("schema") is not None:
                try:
                    conf["schema"] = validate_schema_def(p["schema"])
                except SchemaError as e:
                    return Response({"error": str(e)}, 400)
            conf_path = f"{self._topic_dir(ns, topic)}/topic.conf"
            if self.fc.get_entry(conf_path) is not None:
                return Response({"error": f"{ns}/{topic} exists"}, 409)
            self.fc.put(conf_path, json.dumps(conf).encode(),
                        content_type="application/json")
            return Response({"ok": True, "partition_count": count}, 201)

        @svc.route("POST", r"/topics/configure")
        def topics_configure(req: Request) -> Response:
            # `command_mq_topic_configure.go`: change a live topic's
            # partition count. Only increases are allowed — shrinking
            # would orphan data in the removed partitions. Key routing
            # re-hashes over the new count; existing partitions keep
            # their extents.
            p = req.json()
            ns, topic = p.get("namespace", "default"), p["topic"]
            conf = self._topic_conf(ns, topic)
            if conf is None:
                return Response({"error": f"{ns}/{topic} not found"}, 404)
            count = int(p.get("partition_count", conf["partition_count"]))
            if count < conf["partition_count"]:
                return Response(
                    {"error": "partition count can only grow"
                              f" (now {conf['partition_count']})"}, 400)
            conf["partition_count"] = count
            conf_path = f"{self._topic_dir(ns, topic)}/topic.conf"
            self.fc.put(conf_path, json.dumps(conf).encode(),
                        content_type="application/json")
            return Response({"ok": True, "partition_count": count})

        @svc.route("GET", r"/topics/list")
        def topics_list(req: Request) -> Response:
            topics = [
                {"namespace": ns, "topic": t} for ns, t in self._iter_topics()
            ]
            return Response({"topics": topics})

        @svc.route("GET", r"/topics/describe")
        def topics_describe(req: Request) -> Response:
            ns = req.query.get("namespace", "default")
            topic = req.query["topic"]
            conf = self._topic_conf(ns, topic)
            if conf is None:
                return Response({"error": f"{ns}/{topic} not found"}, 404)
            parts = []
            for k in range(conf["partition_count"]):
                tp = self._partition(ns, topic, k)
                parts.append({
                    "partition": k,
                    "high_water_mark": tp.high_water_mark(),
                    "owner": self._owner_of(ns, topic, k),
                })
            conf["partitions"] = parts
            return Response(conf)

        @svc.route("POST", r"/publish")
        def publish(req: Request) -> Response:
            p = req.json()
            ns, topic = p.get("namespace", "default"), p["topic"]
            conf = self._topic_conf(ns, topic)
            if conf is None:
                return Response({"error": f"{ns}/{topic} not found"}, 404)
            count = conf["partition_count"]
            key = p.get("key", "")
            if "partition" in p:
                k = int(p["partition"]) % count
            else:
                digest = hashlib.sha1(key.encode()).digest()
                k = int.from_bytes(digest[:4], "big") % count
            if self._is_fenced(ns, topic, k):
                return Response(
                    {"error": "partition moving, retry", "retry": True}, 503,
                    headers={"Retry-After": "1"},
                )
            owner = self._owner_of(ns, topic, k)
            if owner and owner != self.url:
                # ownership moved (broker joined / balancer action): make
                # any locally-held tail durable before pointing the client
                # at the new owner, or it would read a truncated partition
                self._release_partition(ns, topic, k)
                return Response({"moved_to": owner, "partition": k}, 307)
            if conf.get("schema") is not None:
                try:
                    validate_record(conf["schema"], p.get("value"))
                except SchemaError as e:
                    return Response({"error": str(e)}, 400)
            tp = self._partition(ns, topic, k)
            replication = int(conf.get("replication", 0))
            replicate = None
            if replication > 0:
                need = min(replication, max(0, len(self.ring.servers()) - 1))

                def replicate(msg, _ns=ns, _topic=topic, _k=k, _need=need):
                    # the follower also learns the flushed extent so it can
                    # trim replica offsets the owner already made durable.
                    # Posts run concurrently with a short timeout — one
                    # blackholed follower must not stall the partition's
                    # pub_lock for the full publish timeout
                    with tp.lock:
                        flushed_through = tp.tail_start
                    followers = self._followers_of(_ns, _topic, _k, replication)
                    if not followers:
                        return 0 >= _need

                    def one(follower):
                        status, _, out = self._follow_http.request(
                            "POST", f"{follower}/follow/append", json.dumps({
                                "namespace": _ns, "topic": _topic,
                                "partition": _k, "messages": [msg],
                                "flushed_through": flushed_through,
                            }).encode(), {"Content-Type": "application/json"})
                        if status >= 400:
                            raise IOError(f"follow/append -> {status}: {out[:200]!r}")
                        return 1

                    acked = 0
                    futs = [self._repl_pool.submit(one, f) for f in followers]
                    try:
                        for fut in concurrent.futures.as_completed(
                            futs, timeout=5
                        ):
                            try:
                                acked += fut.result()
                            except Exception:
                                pass
                    except concurrent.futures.TimeoutError:
                        pass  # stragglers count as un-acked
                    return acked >= _need

            try:
                offset = tp.publish(key, p.get("value"), replicate=replicate)
            except ReplicationError:
                return Response(
                    {"error": "not enough follower acks"}, 503
                )
            except PartitionReleased:
                # raced a balancer move: point the client at the new owner
                owner = self._owner_of(ns, topic, k)
                return Response(
                    {"moved_to": owner or self.url, "partition": k}, 307
                )
            return Response({"ok": True, "partition": k, "offset": offset})

        @svc.route("GET", r"/subscribe")
        def subscribe(req: Request) -> Response:
            ns = req.query.get("namespace", "default")
            topic = req.query["topic"]
            k = int(req.query.get("partition", 0))
            offset = int(req.query.get("offset", 0))
            limit = int(req.query.get("limit", 1024))
            wait = min(float(req.query.get("wait", 0)), 30.0)
            conf = self._topic_conf(ns, topic)
            if conf is None:
                return Response({"error": f"{ns}/{topic} not found"}, 404)
            owner = self._owner_of(ns, topic, k)
            if owner and owner != self.url:
                self._release_partition(ns, topic, k)  # flush stale tail
                return Response({"moved_to": owner}, 307)
            tp = self._partition(ns, topic, k)
            msgs = tp.read(offset, limit, wait)
            return Response({
                "messages": msgs,
                "next_offset": msgs[-1]["offset"] + 1 if msgs else offset,
                "high_water_mark": tp.high_water_mark(),
            })

        @svc.route("POST", r"/offsets/commit")
        def offsets_commit(req: Request) -> Response:
            p = req.json()
            ns, topic = p.get("namespace", "default"), p["topic"]
            path = (f"{self._topic_dir(ns, topic)}/offsets/"
                    f"{p['group']}.json")
            e = self.fc.get_entry(path)
            cur = {}
            if e is not None and e.get("content"):
                try:
                    cur = json.loads(bytes.fromhex(e["content"]))
                except ValueError:
                    cur = {}
            cur[str(int(p["partition"]))] = int(p["offset"])
            self.fc.put(path, json.dumps(cur).encode(),
                        content_type="application/json")
            return Response({"ok": True, "offsets": cur})

        @svc.route("GET", r"/offsets")
        def offsets_get(req: Request) -> Response:
            ns = req.query.get("namespace", "default")
            topic = req.query["topic"]
            group = req.query["group"]
            e = self.fc.get_entry(
                f"{self._topic_dir(ns, topic)}/offsets/{group}.json"
            )
            if e is None or not e.get("content"):
                return Response({"offsets": {}})
            return Response(
                {"offsets": json.loads(bytes.fromhex(e["content"]))}
            )

        @svc.route("POST", r"/balance")
        def balance(req: Request) -> Response:
            """Run balance actions until the spread is ≤1
            (`pub_balancer/balance.go` loops single moves). Exclusive:
            concurrent balancers would lose each other's assignment writes,
            so the master's cluster lock serializes runs across brokers."""
            locked = False
            if self.master_url:
                try:
                    post_json(f"{self.master_url}/cluster/lock", {
                        "name": "mq.balance", "holder": self.url,
                        "ttl": 60,
                    }, timeout=5)
                    locked = True
                except Exception:
                    return Response(
                        {"error": "another balance run holds the lock"}, 409
                    )
            try:
                actions = []
                for _ in range(64):
                    act = self.balance_once()
                    if act is None:
                        break
                    actions.append(act)
            finally:
                if locked:
                    try:
                        post_json(f"{self.master_url}/cluster/unlock", {
                            "name": "mq.balance", "holder": self.url,
                        }, timeout=5)
                    except Exception:
                        pass  # ttl expiry reclaims it
            return Response({"actions": actions})

        @svc.route("POST", r"/partition/release")
        def partition_release(req: Request) -> Response:
            p = req.json()
            had = self._release_partition(
                p.get("namespace", "default"), p["topic"], int(p["partition"]),
                fence=bool(p.get("fence")), ttl=float(p.get("ttl", 10.0)),
            )
            return Response({"ok": True, "had": had})

        @svc.route("POST", r"/partition/unfence")
        def partition_unfence(req: Request) -> Response:
            p = req.json()
            self._unfence(p.get("namespace", "default"), p["topic"],
                          int(p["partition"]))
            return Response({"ok": True})

        def _coordinator_gate(p: dict):
            key = self._group_key(
                p.get("namespace", "default"), p["topic"], p["group"]
            )
            coord = self._group_coordinator(key)
            if coord and coord != self.url:
                return key, Response({"moved_to": coord}, 307)
            return key, None

        @svc.route("POST", r"/consumer/join")
        def consumer_join(req: Request) -> Response:
            p = req.json()
            key, moved = _coordinator_gate(p)
            if moved:
                return moved
            conf = self._topic_conf(p.get("namespace", "default"), p["topic"])
            if conf is None:
                return Response({"error": "topic not found"}, 404)
            instance = p.get("instance_id") or f"c-{time.time_ns():x}"
            with self._glock:
                state = self._groups.setdefault(
                    key, {"members": {}, "assign": {}, "version": 0}
                )
                state["members"][instance] = time.time()
                self._rebalance_group(state, conf["partition_count"])
                mine = sorted(
                    k for k, m in state["assign"].items() if m == instance
                )
                version = state["version"]
            return Response({
                "instance_id": instance, "version": version,
                "partitions": mine,
            })

        @svc.route("POST", r"/consumer/leave")
        def consumer_leave(req: Request) -> Response:
            p = req.json()
            key, moved = _coordinator_gate(p)
            if moved:
                return moved
            conf = self._topic_conf(p.get("namespace", "default"), p["topic"])
            with self._glock:
                state = self._groups.get(key)
                if state is not None:
                    state["members"].pop(p.get("instance_id", ""), None)
                    if conf:
                        self._rebalance_group(state, conf["partition_count"])
            return Response({"ok": True})

        @svc.route("POST", r"/consumer/heartbeat")
        def consumer_heartbeat(req: Request) -> Response:
            p = req.json()
            key, moved = _coordinator_gate(p)
            if moved:
                return moved
            instance = p.get("instance_id")
            if not instance:
                return Response({"error": "instance_id required"}, 400)
            conf = self._topic_conf(p.get("namespace", "default"), p["topic"])
            with self._glock:
                state = self._groups.get(key)
                # a member this coordinator does not hold (it restarted or
                # took the group over, or the member expired) re-joins: its
                # version came from another count and may equal this one's
                if state is None or conf is None or instance not in state["members"]:
                    return Response({"error": "unknown group"}, 404)
                state["members"][instance] = time.time()
                self._rebalance_group(state, conf["partition_count"])
                return Response({"version": state["version"]})

        @svc.route("GET", r"/consumer/assignments")
        def consumer_assignments(req: Request) -> Response:
            p = {
                "namespace": req.query.get("namespace", "default"),
                "topic": req.query["topic"],
                "group": req.query["group"],
            }
            key, moved = _coordinator_gate(p)
            if moved:
                return moved
            instance = req.query.get("instance_id", "")
            with self._glock:
                state = self._groups.get(key)
                if state is None:
                    return Response({"error": "unknown group"}, 404)
                mine = sorted(
                    k for k, m in state["assign"].items() if m == instance
                )
                return Response({
                    "version": state["version"], "partitions": mine,
                    "members": sorted(state["members"]),
                })

        @svc.route("POST", r"/follow/append")
        def follow_append(req: Request) -> Response:
            p = req.json()
            ns, topic = p.get("namespace", "default"), p["topic"]
            k = int(p["partition"])
            key = f"{ns}/{topic}/p{k:04d}"
            flushed_through = int(p.get("flushed_through", 0))
            with self._plock:
                live = self._partitions.get(key)
                if live is not None and self._owner_of(ns, topic, k) == self.url:
                    tp = live  # ring flapped back: fold into the live copy
                else:
                    tp = None
                    replica = self._replicas.setdefault(key, {})
                    for m in p.get("messages", []):
                        replica[int(m["offset"])] = m
                    # trim what the owner already flushed durably: adoption
                    # only ever needs offsets past the flushed extent, so
                    # the replica buffer stays bounded by the flush cadence
                    for off in [o for o in replica if o < flushed_through]:
                        del replica[off]
            if tp is not None:
                tp.adopt(p.get("messages", []))
            return Response({"ok": True})

        @svc.route("POST", r"/flush")
        def flush(req: Request) -> Response:
            self.flush_all()
            return Response({"ok": True})
