"""The port's message queue held against the JAX package's.

Every scenario of the JAX package's `tests/test_mq.py` runs against the
port's broker, client and filer (all at `device="cpu"`): topics,
partitioned publish and subscribe, consumer-group offsets, durability
across a broker restart, ownership redirects between two brokers, follower
replication through an owner's crash, schemas, the balancer, the
sub-coordinator, the client library, the balancer's crash safety, the
consumer's re-join and topic growth. Partition owners come from the
rendezvous rank of the brokers' ephemeral-port URLs, so the scenarios hold
outcomes to their invariants, as the JAX tests do.

The parity cases run a JAX cluster and a port cluster side by side
(`twin()` of `test_torch_filer_meta.py`): the segment files a port
`TopicPartition` writes are byte-equal to the JAX one's for the same
publishes with the same `ts_ns`; a JAX `Consumer` reads from a port broker
and a port `Consumer` from a JAX broker, and both see the same offsets,
keys, values and committed group offsets. Owners are never compared.

Every broker a test starts is stopped, and its follower pool joined, in
that test's teardown; every consumer is closed.
"""

import json
import threading
import time

import pytest

from seaweedfs_tpu_torch.server.httpd import http_request
from tests._threads import stop_history_loops  # noqa: F401


def _post(url, payload):
    status, _, body = http_request(
        "POST", url, body=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return status, json.loads(body) if body else {}


def _get(url):
    status, _, body = http_request("GET", url)
    return status, json.loads(body) if body else {}


def stop_broker(broker) -> None:
    """Stop a broker and join its follower pool (its `stop()` leaves the
    pool's threads to finish on their own)."""
    broker.stop()
    broker._repl_pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    from seaweedfs_tpu_torch.mq import BrokerServer
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    tmp = tmp_path_factory.mktemp("mq")
    master = MasterServer(port=0)
    master.start()
    vol = VolumeServer([str(tmp / "v")], master_url=master.url, port=0, device="cpu")
    vol.start()
    vol.heartbeat_once()
    filer = FilerServer(master_url=master.url, port=0, device="cpu")
    filer.start()
    broker = BrokerServer(filer.url, master_url=master.url, port=0)
    broker.start()
    yield master, filer, broker
    stop_broker(broker)
    filer.stop()
    vol.stop()
    master.stop()


class TestTopics:
    def test_create_list_describe(self, stack):
        master, filer, broker = stack
        status, out = _post(broker.url + "/topics/create",
                            {"topic": "events", "partition_count": 3})
        assert status == 201
        status, out = _post(broker.url + "/topics/create",
                            {"topic": "events"})
        assert status == 409  # duplicate
        status, out = _get(broker.url + "/topics/list")
        assert {"namespace": "default", "topic": "events"} in out["topics"]
        status, out = _get(
            broker.url + "/topics/describe?topic=events"
        )
        assert out["partition_count"] == 3
        assert len(out["partitions"]) == 3


class TestPubSub:
    def test_publish_subscribe_ordering(self, stack):
        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "orders", "partition_count": 2})
        # same key -> same partition, ordered offsets
        offsets = []
        for i in range(10):
            status, out = _post(broker.url + "/publish", {
                "topic": "orders", "key": "customer-7",
                "value": {"seq": i},
            })
            assert status == 200, out
            offsets.append((out["partition"], out["offset"]))
        parts = {p for p, _ in offsets}
        assert len(parts) == 1
        k = parts.pop()
        assert [o for _, o in offsets] == list(range(10))

        status, out = _get(
            broker.url +
            f"/subscribe?topic=orders&partition={k}&offset=0"
        )
        assert [m["value"]["seq"] for m in out["messages"]] == list(range(10))
        assert out["next_offset"] == 10

        # resume mid-stream
        status, out = _get(
            broker.url + f"/subscribe?topic=orders&partition={k}&offset=6"
        )
        assert [m["value"]["seq"] for m in out["messages"]] == [6, 7, 8, 9]

    def test_long_poll_wakeup(self, stack):
        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "poll", "partition_count": 1})
        got = {}

        def consume():
            status, out = _get(
                broker.url + "/subscribe?topic=poll&partition=0&offset=0&wait=5"
            )
            got["messages"] = out["messages"]

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.3)
        _post(broker.url + "/publish",
              {"topic": "poll", "partition": 0, "value": "wake"})
        t.join(timeout=10)
        assert [m["value"] for m in got.get("messages", [])] == ["wake"]

    def test_consumer_group_offsets(self, stack):
        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "grp", "partition_count": 1})
        for i in range(5):
            _post(broker.url + "/publish",
                  {"topic": "grp", "partition": 0, "value": i})
        _post(broker.url + "/offsets/commit",
              {"topic": "grp", "group": "readers", "partition": 0,
               "offset": 3})
        status, out = _get(
            broker.url + "/offsets?topic=grp&group=readers"
        )
        assert out["offsets"] == {"0": 3}
        # resume from committed offset
        status, out = _get(
            broker.url + "/subscribe?topic=grp&partition=0&offset=3"
        )
        assert [m["value"] for m in out["messages"]] == [3, 4]


class TestDurability:
    def test_broker_restart_resumes_from_filer(self, stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "durable", "partition_count": 1})
        for i in range(4):
            _post(broker.url + "/publish",
                  {"topic": "durable", "partition": 0, "value": i})
        _post(broker.url + "/flush", {})

        b2 = BrokerServer(filer.url, port=0)
        b2.start()
        try:
            # continues numbering after the flushed extent
            status, out = _post(b2.url + "/publish", {
                "topic": "durable", "partition": 0, "value": 99,
            })
            assert out["offset"] == 4
            status, out = _get(
                b2.url + "/subscribe?topic=durable&partition=0&offset=0"
            )
            assert [m["value"] for m in out["messages"]] == [0, 1, 2, 3, 99]
        finally:
            stop_broker(b2)


class TestTwoBrokerOwnership:
    @pytest.fixture()
    def own_stack(self, tmp_path):
        # PRIVATE stack: the module-scoped one carries topics, assignment
        # caches, and ring state from earlier classes, which flaked this
        # test once in a full-suite run
        from seaweedfs_tpu_torch.mq import BrokerServer
        from seaweedfs_tpu_torch.server.filer import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume import VolumeServer

        master = MasterServer(port=0)
        master.start()
        vol = VolumeServer([str(tmp_path / "v")], master_url=master.url,
                           port=0, device="cpu")
        vol.start()
        vol.heartbeat_once()
        filer = FilerServer(master_url=master.url, port=0, device="cpu")
        filer.start()
        broker = BrokerServer(filer.url, master_url=master.url, port=0)
        broker.start()
        yield master, filer, broker
        stop_broker(broker)
        filer.stop()
        vol.stop()
        master.stop()

    def test_redirects_to_partition_owner(self, own_stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        master, filer, broker = own_stack
        b2 = BrokerServer(filer.url, master_url=master.url, port=0,
                          peers=[broker.url])
        b2.start()
        broker.ring.set_servers([broker.url, b2.url])
        try:
            # 32 partitions, not 8: ownership is rendezvous-hashed over the
            # brokers' (ephemeral-port) urls, so with P partitions one
            # broker owns ALL of them with probability 2^-(P-1) — at 8
            # that's a 1-in-128 flake on the 307 assertion below
            _post(broker.url + "/topics/create",
                  {"topic": "sharded", "partition_count": 32})
            statuses = set()
            published = 0
            for i in range(32):
                url = broker.url
                payload = {"topic": "sharded", "key": f"k{i}", "value": i}
                for _ in range(3):  # follow moved_to
                    status, out = _post(url + "/publish", payload)
                    statuses.add(status)
                    if status == 307:
                        url = out["moved_to"]
                        continue
                    assert status == 200
                    published += 1
                    break
            assert published == 32
            assert 307 in statuses  # both brokers own some partitions
        finally:
            broker.ring.set_servers([broker.url])
            stop_broker(b2)


class TestFollowerReplication:
    """Kill-the-owner: with replication=1, every acked publish must survive
    the owner broker dying before any flush
    (`broker_grpc_pub_follow.go` ack-before-commit semantics)."""

    def test_kill_owner_loses_nothing(self, stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        _, filer, _ = stack
        b1 = BrokerServer(filer.url, port=0)
        b1.start()
        b2 = BrokerServer(filer.url, port=0)
        b2.start()
        ring = sorted([b1.url, b2.url])
        b1.ring.set_servers(ring)
        b2.ring.set_servers(ring)
        try:
            status, _ = _post(f"{b1.url}/topics/create", {
                "topic": "crashy", "partition_count": 1, "replication": 1,
            })
            assert status == 201
            # find the owner of p0 and its follower
            owner_url = b1.ring.server_for("default/crashy/p0")
            owner = b1 if owner_url == b1.url else b2
            follower = b2 if owner is b1 else b1
            acked = []
            for i in range(25):
                status, out = _post(f"{owner.url}/publish", {
                    "topic": "crashy", "partition": 0,
                    "key": f"k{i}", "value": {"n": i},
                })
                assert status == 200, out
                acked.append(out["offset"])
            assert acked == list(range(25))
            # CRASH the owner: no flush, no graceful anything
            owner.service.stop()
            # ring heals around the survivor
            follower.ring.set_servers([follower.url])
            status, out = _get(
                f"{follower.url}/subscribe?topic=crashy&partition=0"
                f"&offset=0&limit=100"
            )
            assert status == 200, out
            got = [m["value"]["n"] for m in out["messages"]]
            assert got == list(range(25)), "acked messages lost on owner crash"
            # and the adopted messages are DURABLE (flushed to the filer)
            status, out2 = _post(f"{follower.url}/flush", {})
            seg_listing = filer.filer.list_entries("/topics/default/crashy/p0000")
            assert any(e.name.endswith(".log") for e in seg_listing)
        finally:
            stop_broker(follower)
            stop_broker(owner)

    def test_publish_fails_without_follower_ack(self, stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        _, filer, _ = stack
        b = BrokerServer(filer.url, port=0)
        b.start()
        # ring believes a second broker exists, but it is unreachable
        b.ring.set_servers(sorted([b.url, "http://127.0.0.1:1"]))
        try:
            # pick a topic whose p0 the REAL broker owns (ring is hash-based)
            topic = next(
                t for t in (f"needsack{i}" for i in range(64))
                if b.ring.server_for(f"default/{t}/p0") == b.url
            )
            _post(f"{b.url}/topics/create", {
                "topic": topic, "partition_count": 1, "replication": 1,
            })
            status, out = _post(f"{b.url}/publish", {
                "topic": topic, "partition": 0, "key": "k", "value": 1,
            })
            assert status == 503, out  # ack-before-commit: no ack, no OK
        finally:
            stop_broker(b)


class TestSchemaTopics:
    def test_schema_validation(self, stack):
        _, _, broker = stack
        status, out = _post(f"{broker.url}/topics/create", {
            "topic": "typed", "partition_count": 1,
            "schema": {"fields": [
                {"name": "id", "type": "int"},
                {"name": "name", "type": "string"},
                {"name": "score", "type": "float", "required": False},
            ]},
        })
        assert status == 201, out
        ok = {"topic": "typed", "partition": 0, "key": "a",
              "value": {"id": 1, "name": "x", "score": 2.5}}
        status, out = _post(f"{broker.url}/publish", ok)
        assert status == 200, out
        # missing required field
        status, out = _post(f"{broker.url}/publish", {
            "topic": "typed", "partition": 0, "key": "a",
            "value": {"id": 2}})
        assert status == 400 and "name" in out["error"]
        # wrong type
        status, out = _post(f"{broker.url}/publish", {
            "topic": "typed", "partition": 0, "key": "a",
            "value": {"id": "not-int", "name": "x"}})
        assert status == 400
        # unknown field
        status, out = _post(f"{broker.url}/publish", {
            "topic": "typed", "partition": 0, "key": "a",
            "value": {"id": 3, "name": "x", "bogus": 1}})
        assert status == 400
        # optional field may be omitted
        status, out = _post(f"{broker.url}/publish", {
            "topic": "typed", "partition": 0, "key": "a",
            "value": {"id": 4, "name": "y"}})
        assert status == 200

    def test_bad_schema_rejected_at_create(self, stack):
        _, _, broker = stack
        status, out = _post(f"{broker.url}/topics/create", {
            "topic": "badschema",
            "schema": {"fields": [{"name": "x", "type": "quaternion"}]},
        })
        assert status == 400 and "quaternion" in out["error"]

    def test_failed_ack_commits_nothing(self, stack):
        """Review-pinned: a 503 publish must leave no trace — no tail
        entry, no hwm advance, no duplicate on retry."""
        from seaweedfs_tpu_torch.mq import BrokerServer

        _, filer, _ = stack
        b = BrokerServer(filer.url, port=0)
        b.start()
        b.ring.set_servers(sorted([b.url, "http://127.0.0.1:1"]))
        try:
            topic = next(
                t for t in (f"noghost{i}" for i in range(64))
                if b.ring.server_for(f"default/{t}/p0") == b.url
            )
            _post(f"{b.url}/topics/create", {
                "topic": topic, "partition_count": 1, "replication": 1,
            })
            status, _ = _post(f"{b.url}/publish", {
                "topic": topic, "partition": 0, "key": "k", "value": 1})
            assert status == 503
            tp = b._partition("default", topic, 0)
            assert tp.high_water_mark() == 0  # nothing committed
            # follower comes back: retry succeeds at offset 0, no duplicate
            b.ring.set_servers([b.url])
            status, out = _post(f"{b.url}/publish", {
                "topic": topic, "partition": 0, "key": "k", "value": 1})
            assert status == 200 and out["offset"] == 0
            assert tp.high_water_mark() == 1
        finally:
            stop_broker(b)


class TestPubBalancer:
    """Partition rebalancing across brokers (`weed/mq/pub_balancer/`):
    spread converges to ≤1, moves are durable assignment overrides, and a
    dead broker's assignments get repaired."""

    def test_balance_converges_and_data_survives(self, stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "tobalance", "partition_count": 6})
        # publish a message to every partition while one broker owns all
        for k in range(6):
            status, out = _post(broker.url + "/publish", {
                "topic": "tobalance", "partition": k, "value": f"v{k}",
            })
            assert status == 200, out
        b2 = BrokerServer(filer.url, master_url=master.url, port=0,
                          peers=[broker.url])
        b2.start()
        try:
            for b in (broker, b2):
                b.ring.set_servers([broker.url, b2.url])
            status, out = _post(broker.url + "/balance", {})
            assert status == 200
            # GLOBAL spread (all topics the fixture accumulated) must be ≤1
            counts = {broker.url: 0, b2.url: 0}
            for ns, topic, k in broker._all_partitions():
                owner = broker._owner_of(ns, topic, k)
                if owner in counts:
                    counts[owner] += 1
            assert abs(counts[broker.url] - counts[b2.url]) <= 1, counts
            assert out["actions"] or min(counts.values()) > 0
            # every partition's data is readable at its (possibly new) owner
            for k in range(6):
                url = broker.url
                for _ in range(3):
                    status, out = _get(
                        f"{url}/subscribe?topic=tobalance&partition={k}"
                        f"&offset=0"
                    )
                    if status == 307:
                        url = out["moved_to"]
                        continue
                    break
                assert status == 200, out
                assert out["messages"][0]["value"] == f"v{k}"
            # kill b2: repair clears its assignments, rendezvous takes over
            dead = b2.url
            stop_broker(b2)
            broker.ring.set_servers([broker.url])
            _post(broker.url + "/balance", {})
            for k in range(6):
                assert broker._owner_of("default", "tobalance", k) != dead
        finally:
            broker.ring.set_servers([broker.url])
            try:
                stop_broker(b2)
            except Exception:
                pass


class TestSubCoordinator:
    """Consumer-group partition assignment (`weed/mq/sub_coordinator/`):
    sticky rebalance across join/leave, lazy member expiry."""

    def test_sticky_join_leave(self, stack):
        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "grouped", "partition_count": 4})
        status, a = _post(broker.url + "/consumer/join", {
            "topic": "grouped", "group": "g1", "instance_id": "alpha",
        })
        assert status == 200 and a["partitions"] == [0, 1, 2, 3]
        status, b = _post(broker.url + "/consumer/join", {
            "topic": "grouped", "group": "g1", "instance_id": "beta",
        })
        assert status == 200 and len(b["partitions"]) == 2
        # alpha's refreshed view: sticky — it kept 2 of its original 4
        status, av = _get(
            f"{broker.url}/consumer/assignments?topic=grouped&group=g1"
            f"&instance_id=alpha"
        )
        assert status == 200
        assert len(av["partitions"]) == 2
        assert set(av["partitions"]) | set(b["partitions"]) == {0, 1, 2, 3}
        assert set(av["partitions"]).isdisjoint(b["partitions"])
        assert av["version"] > a["version"]
        # beta leaves: alpha reclaims everything, keeping its own sticky
        kept = set(av["partitions"])
        status, _ = _post(broker.url + "/consumer/leave", {
            "topic": "grouped", "group": "g1", "instance_id": "beta",
        })
        assert status == 200
        status, av2 = _get(
            f"{broker.url}/consumer/assignments?topic=grouped&group=g1"
            f"&instance_id=alpha"
        )
        assert av2["partitions"] == [0, 1, 2, 3]
        assert kept <= set(av2["partitions"])

    def test_member_expiry_rebalances(self, stack, monkeypatch):
        from seaweedfs_tpu_torch.mq.broker import BrokerServer

        master, filer, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "expiring", "partition_count": 2})
        _post(broker.url + "/consumer/join", {
            "topic": "expiring", "group": "g2", "instance_id": "live",
        })
        _post(broker.url + "/consumer/join", {
            "topic": "expiring", "group": "g2", "instance_id": "ghost",
        })
        # ghost stops heartbeating; shrink the TTL instead of sleeping
        monkeypatch.setattr(BrokerServer, "_MEMBER_TTL", 0.05)
        import time as _time

        _time.sleep(0.1)
        status, hb = _post(broker.url + "/consumer/heartbeat", {
            "topic": "expiring", "group": "g2", "instance_id": "live",
        })
        assert status == 200
        status, av = _get(
            f"{broker.url}/consumer/assignments?topic=expiring&group=g2"
            f"&instance_id=live"
        )
        assert av["partitions"] == [0, 1]
        assert av["members"] == ["live"]


class TestClientLibrary:
    """Publisher/Consumer client library (`weed/mq/client/pub_client/`,
    `sub_client/`): discovery via the master, redirect-following, group
    membership, offset resume."""

    def test_publish_consume_commit_resume(self, stack):
        from seaweedfs_tpu_torch.mq import Consumer, Publisher

        master, filer, broker = stack
        pub = Publisher(master_url=master.url)
        pub.create_topic("clienttest", partition_count=3)
        for i in range(30):
            out = pub.publish("clienttest", {"n": i}, key=f"k{i}")
            assert out["ok"]
        c1 = Consumer("clienttest", "cg", master_url=master.url,
                      instance_id="one")
        assert c1.partitions == [0, 1, 2]
        msgs = c1.poll()
        assert len(msgs) == 30
        assert sorted(m["value"]["n"] for m in msgs) == list(range(30))
        c1.commit()
        # a new consumer instance in the same group resumes committed
        # offsets: nothing is redelivered
        c1.close()
        c2 = Consumer("clienttest", "cg", master_url=master.url,
                      instance_id="two")
        assert c2.poll() == []
        # new messages flow to the resumed consumer
        pub.publish("clienttest", {"n": 99}, key="fresh")
        msgs = c2.poll()
        assert [m["value"]["n"] for m in msgs] == [99]
        c2.close()
        pub.close()

    def test_two_consumers_partition_split(self, stack):
        from seaweedfs_tpu_torch.mq import Consumer, Publisher

        master, filer, broker = stack
        pub = Publisher(master_url=master.url)
        pub.create_topic("splittest", partition_count=4)
        a = Consumer("splittest", "g2", master_url=master.url,
                     instance_id="a")
        b = Consumer("splittest", "g2", master_url=master.url,
                     instance_id="b")
        a._heartbeat()  # pick up the post-join rebalance
        assert sorted(a.partitions + b.partitions) == [0, 1, 2, 3]
        assert set(a.partitions).isdisjoint(b.partitions)
        for k in range(4):
            pub.publish("splittest", f"v{k}", partition=k)
        seen = {m["partition"] for m in a.poll()} | {
            m["partition"] for m in b.poll()}
        assert seen == {0, 1, 2, 3}
        a.close()
        b.close()
        pub.close()


class TestBalancerCrashSafety:
    """VERDICT r4 #8: a balancer dying mid-move must lose no acked message
    and never leave a partition double-served. Fences are leases the
    balancer renews; an expired lease releases via the durable-assignment
    owner check, not blindly."""

    def test_balancer_dies_before_assignment_write(self, stack):
        _, _, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "crash1", "partition_count": 1})
        s, _ = _post(broker.url + "/publish",
                     {"topic": "crash1", "partition": 0, "value": "a"})
        assert s == 200
        # balancer quiesced the source with a short lease, then died —
        # no assignment was ever written
        s, out = _post(broker.url + "/partition/release",
                       {"topic": "crash1", "partition": 0, "fence": True,
                        "ttl": 0.5})
        assert s == 200
        # fenced: publishes are parked with retry semantics
        s, out = _post(broker.url + "/publish",
                       {"topic": "crash1", "partition": 0, "value": "b"})
        assert s == 503 and out.get("retry")
        time.sleep(0.7)
        # lease expired; durable assignment still points nowhere/here, so
        # the owner check releases the fence and serving resumes
        s, _ = _post(broker.url + "/publish",
                     {"topic": "crash1", "partition": 0, "value": "c"})
        assert s == 200
        qs = "topic=crash1&partition=0&offset=0&limit=10"
        s, out = _get(broker.url + f"/subscribe?{qs}")
        got = [m["value"] for m in out["messages"]]
        assert got == ["a", "c"]  # nothing acked was lost

    def test_balancer_dies_after_assignment_write(self, stack):
        from seaweedfs_tpu_torch.mq import BrokerServer

        master, filer, broker = stack
        b2 = BrokerServer(filer.url, master_url=master.url, port=0,
                          peers=[broker.url])
        b2.start()
        broker.ring.set_servers([broker.url, b2.url])
        try:
            _post(broker.url + "/topics/create",
                  {"topic": "crash2", "partition_count": 1})
            # force ownership onto broker 1 first
            broker._write_assignment("default", "crash2", 0, broker.url)
            s, _ = _post(broker.url + "/publish",
                         {"topic": "crash2", "partition": 0, "value": "x"})
            assert s == 200
            # balancer quiesced, WROTE the assignment to b2, then died
            # before unfencing
            s, _ = _post(broker.url + "/partition/release",
                         {"topic": "crash2", "partition": 0, "fence": True,
                          "ttl": 0.5})
            assert s == 200
            broker._write_assignment("default", "crash2", 0, b2.url)
            time.sleep(0.7)
            # expired lease + owner check: the old owner REDIRECTS (never
            # double-serves), the new owner serves the full extent
            s, out = _post(broker.url + "/publish",
                           {"topic": "crash2", "partition": 0, "value": "y"})
            assert s == 307 and out["moved_to"] == b2.url
            s, _ = _post(b2.url + "/publish",
                         {"topic": "crash2", "partition": 0, "value": "y"})
            assert s == 200
            qs = "topic=crash2&partition=0&offset=0&limit=10"
            s, out = _get(b2.url + f"/subscribe?{qs}")
            got = [m["value"] for m in out["messages"]]
            assert got == ["x", "y"]  # pre-move acked message adopted
        finally:
            broker.ring.set_servers([broker.url])
            stop_broker(b2)


class TestConsumerRejoin:
    def test_consumer_survives_coordinator_restart(self, stack):
        """ADVICE r4 medium: coordinator group state is in-memory; a
        restarted (or moved) coordinator answers 404 'unknown group' and
        the consumer must re-join under the same instance id instead of
        dying."""
        from seaweedfs_tpu_torch.mq.client import Consumer, Publisher

        _, _, broker = stack
        pub = Publisher(brokers=[broker.url])
        pub.create_topic("rejoin", partition_count=2)
        for i in range(6):
            pub.publish("rejoin", {"n": i}, key=f"k{i}")
        con = Consumer("rejoin", "g1", brokers=[broker.url])
        got = con.poll(wait=0.2)
        con.commit()
        assert len(got) == 6
        # coordinator "restart": wipe its in-memory group state
        broker._groups.clear()
        for i in range(6, 9):
            pub.publish("rejoin", {"n": i}, key=f"k{i}")
        # next heartbeat hits 404 'unknown group' -> silent re-join
        con._last_hb = 0.0
        got2 = []
        for _ in range(8):
            got2.extend(con.poll(wait=0.2))
            if len(got2) >= 3:
                break
        ns = sorted(m["value"]["n"] for m in got2)
        assert ns == [6, 7, 8], ns  # committed offsets survived the re-join
        con.commit()
        con.close()
        pub.close()


class TestTopicConfigure:
    def test_partition_count_grows_not_shrinks(self, stack):
        _, _, broker = stack
        _post(broker.url + "/topics/create",
              {"topic": "grow", "partition_count": 2})
        for i in range(8):
            s, _ = _post(broker.url + "/publish",
                         {"topic": "grow", "key": f"k{i}", "value": i})
            assert s == 200
        s, out = _post(broker.url + "/topics/configure",
                       {"topic": "grow", "partition_count": 4})
        assert s == 200 and out["partition_count"] == 4
        s, out = _get(broker.url + "/topics/describe?topic=grow")
        assert out["partition_count"] == 4 and len(out["partitions"]) == 4
        # publishes spread over the grown set; pre-grow data still reads
        for i in range(8, 16):
            s, _ = _post(broker.url + "/publish",
                         {"topic": "grow", "key": f"k{i}", "value": i})
            assert s == 200
        total = 0
        for k in range(4):
            s, out = _get(broker.url +
                          f"/subscribe?topic=grow&partition={k}&offset=0")
            total += len(out["messages"])
        assert total == 16
        # shrinking is refused (it would orphan partition data)
        s, out = _post(broker.url + "/topics/configure",
                       {"topic": "grow", "partition_count": 1})
        assert s == 400


# --- parity with the JAX package ---------------------------------------------------------
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port cluster, each with one broker over its own filer."""
    from seaweedfs_tpu.mq import BrokerServer as RefBrokerServer
    from seaweedfs_tpu_torch.mq import BrokerServer
    from tests.test_torch_filer_meta import twin

    with twin(str(tmp_path_factory.mktemp("mqpair"))) as (ref, port):
        brokers = [RefBrokerServer(ref.filer.url, port=0),
                   BrokerServer(port.filer.url, port=0)]
        for b in brokers:
            b.start()
        try:
            yield (ref, brokers[0]), (port, brokers[1])
        finally:
            for b in brokers:
                stop_broker(b)


def seeded_messages(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(f"key-{int(k):06d}", {"n": i, "blob": rng.bytes(24).hex()})
            for i, k in enumerate(rng.integers(0, 10**6, n))]


def filer_bytes(side, path: str) -> bytes:
    status, _, body = http_request("GET", side.filer.url + path)
    assert status == 200, path
    return body


def test_segment_files_equal_reference(pair):
    """The same publishes with the same ts_ns flush to the same segment
    files, name and bytes: one full 512-message segment flushed by the
    publish that fills it, and the tail flushed by hand."""
    from seaweedfs_tpu.mq.broker import SEGMENT_FLUSH_COUNT as REF_COUNT
    from seaweedfs_tpu.mq.broker import TopicPartition as RefTopicPartition
    from seaweedfs_tpu_torch.mq.broker import SEGMENT_FLUSH_COUNT, TopicPartition

    assert SEGMENT_FLUSH_COUNT == REF_COUNT == 512
    msgs = seeded_messages(SEGMENT_FLUSH_COUNT + 37, 5)
    base = "/topics/default/segs/p0000"
    got = []
    for (side, broker), tp_cls in zip(pair, (RefTopicPartition, TopicPartition)):
        tp = tp_cls(base, broker.fc)
        offsets = [tp.append(k, v, ts_ns=1_700_000_000_000_000_000 + i)
                   for i, (k, v) in enumerate(msgs)]
        assert offsets == list(range(len(msgs)))
        assert tp.flush() == 37
        names = sorted(e["FullPath"] for e in broker.fc.list(base)["Entries"])
        got.append({p: filer_bytes(side, p) for p in names})
        # a fresh partition resumes after the flushed extent and reads it back
        again = tp_cls(base, broker.fc)
        assert again.high_water_mark() == len(msgs)
        got[-1]["read"] = again.read(500, limit=100)
    assert list(got[1]) == [f"{base}/{0:020d}-{511:020d}.log",
                            f"{base}/{512:020d}-{548:020d}.log", "read"]
    assert got[1] == got[0]


def test_consumers_read_across_packages(pair):
    """A JAX Consumer reads from the port broker and a port Consumer from
    the JAX broker: both see the same offsets, keys and values a partition,
    and both groups commit the same offsets."""
    from seaweedfs_tpu.mq import Consumer as RefConsumer
    from seaweedfs_tpu.mq import Publisher as RefPublisher
    from seaweedfs_tpu_torch.mq import Consumer, Publisher

    (ref, ref_broker), (port, port_broker) = pair
    msgs = seeded_messages(300, 6)
    seen = []
    for pub_cls, con_cls, broker in ((RefPublisher, Consumer, ref_broker),
                                     (Publisher, RefConsumer, port_broker)):
        pub = pub_cls(brokers=[broker.url])
        pub.create_topic("cross", partition_count=3)
        acks = [pub.publish("cross", v, key=k) for k, v in msgs]
        if hasattr(pub, "close"):
            pub.close()
        con = con_cls("cross", "g", brokers=[broker.url], instance_id="only")
        got = []
        for _ in range(20):
            batch = con.poll(limit_per_partition=64)
            got += batch
            if len(got) >= len(msgs):
                break
        con.commit()
        committed = _get(f"{broker.url}/offsets?topic=cross&group=g")[1]["offsets"]
        con.close()
        assert sorted(a["partition"] for a in acks) == sorted(m["partition"] for m in got)
        seen.append(([(m["partition"], m["offset"], m["key"], m["value"]) for m in
                      sorted(got, key=lambda m: (m["partition"], m["offset"]))],
                     [(a["partition"], a["offset"]) for a in acks], committed))
    assert seen[1] == seen[0]
    assert len(seen[1][0]) == len(msgs)
    assert sum(seen[1][2].values()) == len(msgs)


def test_mq_verbs_through_the_port_shell(stack):
    """The five mq.* verbs over the port cluster, each answer equal to the
    JAX shell's verb run against the same cluster."""
    from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
    from seaweedfs_tpu.shell import run_command as ref_run
    from seaweedfs_tpu_torch.shell import CommandEnv, ShellError, run_command

    master, filer, broker = stack
    env, ref_env = CommandEnv(master.url), RefCommandEnv(master.url)
    assert run_command(env, "mq.topic.create -topic shellt -partitionCount 3") == \
        "created topic shellt (3 partitions)"
    assert ref_run(ref_env, "mq.topic.create -topic shellr") == \
        run_command(env, "mq.topic.create -topic shellp").replace("shellp", "shellr")
    listed = run_command(env, "mq.topic.list")
    assert listed == ref_run(ref_env, "mq.topic.list")
    assert {"namespace": "default", "topic": "shellt"} in json.loads(listed)
    for k in range(3):
        _post(broker.url + "/publish", {"topic": "shellt", "partition": k, "value": k})
    out = run_command(env, "mq.topic.describe -topic shellt")
    desc = json.loads(out)
    assert [p["high_water_mark"] for p in desc["partitions"]] == [1, 1, 1]
    assert {p["owner"] for p in desc["partitions"]} == {broker.url}
    assert json.loads(ref_run(ref_env, "mq.topic.describe -topic shellt")) == desc
    assert run_command(env, "mq.topic.configure -topic shellt -partitionCount 5") == \
        "topic default/shellt now has 5 partitions"
    with pytest.raises(ShellError, match="partition count can only grow"):
        run_command(env, "mq.topic.configure -topic shellt -partitionCount 2")
    with pytest.raises(ShellError, match="usage"):
        run_command(env, "mq.topic.configure -topic shellt")
    assert run_command(env, "mq.balance") == ref_run(ref_env, "mq.balance") == \
        "already balanced"
    from seaweedfs_tpu_torch.server.master import MasterServer

    lone = MasterServer(port=0)
    lone.start()
    try:
        with pytest.raises(ShellError, match="no live mq brokers"):
            run_command(CommandEnv(lone.url), "mq.topic.list")
    finally:
        lone.stop()


# --- two repairs of the port (the JAX package keeps both defects) -------------------------
class MemoryFiler:
    """The three FilerClient calls a TopicPartition makes, over a dict; a
    put can be held at a gate or made to fail."""

    def __init__(self) -> None:
        self.files: dict[str, bytes] = {}
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail = False

    def list(self, d: str) -> dict:
        return {"Entries": [{"FullPath": p} for p in sorted(self.files)
                            if p.rsplit("/", 1)[0] == d]}

    def read(self, path: str) -> bytes:
        return self.files[path]

    def put(self, path: str, body: bytes, content_type: str = "") -> dict:
        self.entered.set()
        self.gate.wait(10)
        if self.fail:
            raise IOError(f"PUT {path} -> 500")
        self.files[path] = body
        return {}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_flush_keeps_the_batch_readable_until_its_segment_exists(pkg):
    """While a segment is being written, a read from before it sees the
    batch in the port; the JAX partition has dropped it from the tail, so
    the read skips it (and a consumer's offset jumps past it)."""
    from seaweedfs_tpu.mq.broker import TopicPartition as RefTopicPartition
    from seaweedfs_tpu_torch.mq.broker import TopicPartition

    fc = MemoryFiler()
    tp = (RefTopicPartition if pkg == "ref" else TopicPartition)("/t/p0000", fc)
    for i in range(5):
        tp.append(f"k{i}", i, ts_ns=1 + i)
    fc.gate.clear()
    flusher = threading.Thread(target=tp.flush)
    flusher.start()
    assert fc.entered.wait(10)
    mid = [m["offset"] for m in tp.read(0)]
    tp.append("k5", 5, ts_ns=6)
    fc.gate.set()
    flusher.join(10)
    assert [m["offset"] for m in tp.read(0)] == [0, 1, 2, 3, 4, 5]  # once each
    assert mid == ([] if pkg == "ref" else [0, 1, 2, 3, 4])
    assert list(fc.files) == ["/t/p0000/00000000000000000000-00000000000000000004.log"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_failed_segment_write_keeps_the_messages(pkg):
    from seaweedfs_tpu.mq.broker import TopicPartition as RefTopicPartition
    from seaweedfs_tpu_torch.mq.broker import TopicPartition

    fc = MemoryFiler()
    tp = (RefTopicPartition if pkg == "ref" else TopicPartition)("/t/p0000", fc)
    for i in range(3):
        tp.append(f"k{i}", i, ts_ns=1 + i)
    fc.fail = True
    with pytest.raises(IOError):
        tp.flush()
    fc.fail = False
    kept = [m["offset"] for m in tp.read(0)]
    assert kept == ([] if pkg == "ref" else [0, 1, 2])
    assert tp.high_water_mark() == 3
    if pkg == "port":
        assert tp.flush() == 3 and [m["offset"] for m in tp.read(0)] == [0, 1, 2]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_poll_returns_what_it_fetched_before_a_failure(stack, pkg):
    """A partition whose fetch fails no longer costs the messages fetched
    before it: the port's poll returns them and keeps the failed
    partition's offset; the JAX poll raises with the first partition's
    offset already past messages it never returned."""
    from seaweedfs_tpu.mq.client import Consumer as RefConsumer
    from seaweedfs_tpu.mq.client import MQError as RefMQError
    from seaweedfs_tpu_torch.mq.client import Consumer, MQError

    _, _, broker = stack
    topic = f"pollfail-{pkg}"
    _post(broker.url + "/topics/create", {"topic": topic, "partition_count": 2})
    for k in (0, 1):
        for i in range(3):
            _post(broker.url + "/publish", {"topic": topic, "partition": k, "value": i})
    con = (RefConsumer if pkg == "ref" else Consumer)(topic, "g", brokers=[broker.url])
    try:
        assert con.partitions == [0, 1]
        con._owner_memo[(topic, 1)] = "http://127.0.0.1:1"  # p1's broker is gone
        if pkg == "ref":
            with pytest.raises(RefMQError):
                con.poll()
            assert con._offsets[0] == 3  # advanced past messages never returned
            got = con.poll()  # p0's three are gone for good
            assert [(m["partition"], m["value"]) for m in got] == [(1, 0), (1, 1), (1, 2)]
        else:
            got = con.poll()
            assert [(m["partition"], m["value"]) for m in got] == [(0, 0), (0, 1), (0, 2)]
            assert con._offsets == {0: 3}
            got = con.poll()  # p1's memo was dropped: the next pass reads it
            assert [(m["partition"], m["value"]) for m in got] == [(1, 0), (1, 1), (1, 2)]
            con._owner_memo[(topic, 0)] = "http://127.0.0.1:1"
            con._owner_memo[(topic, 1)] = "http://127.0.0.1:1"
            with pytest.raises(MQError):
                con.poll()  # nothing fetched: the error is raised
    finally:
        con.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_coordinator_change_leaves_no_partition_unread(pair, pkg):
    """The coordinator's group state is lost (a restart, or another broker
    takes the group over). One consumer re-joins first and takes every
    partition; the other then heartbeats. The port's coordinator makes it
    re-join, and the two split the partitions again. The JAX coordinator
    adds it silently at a version equal to its stale one, so it keeps its
    old partitions and both consumers hold the same two."""
    from seaweedfs_tpu_torch.mq import Consumer

    (_, ref_broker), (_, port_broker) = pair
    broker = ref_broker if pkg == "ref" else port_broker
    topic = f"coord-{pkg}"
    _post(broker.url + "/topics/create", {"topic": topic, "partition_count": 4})
    a = Consumer(topic, "g", brokers=[broker.url], instance_id="a")
    b = Consumer(topic, "g", brokers=[broker.url], instance_id="b")
    try:
        a._heartbeat()
        assert (a.partitions, b.partitions, a.version, b.version) == ([0, 1], [2, 3], 2, 2)
        broker._groups.clear()  # the coordinator's memory is gone
        b._heartbeat()  # 404 unknown group: b re-joins alone and takes all four
        assert b.partitions == [0, 1, 2, 3] and b.version == 1
        a._heartbeat()
        b._heartbeat()
        if pkg == "ref":
            assert a.partitions == b.partitions == [0, 1]  # 2 and 3 unread
        else:
            assert sorted(a.partitions + b.partitions) == [0, 1, 2, 3]
            assert set(a.partitions).isdisjoint(b.partitions)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_broker_dying_mid_answer_is_an_mq_error(pkg):
    """A broker that dies after half an answer: the port's client raises
    MQError, as for any transport failure; the JAX client lets
    http.client's IncompleteRead through."""
    import http.client
    import socket as socketlib

    from seaweedfs_tpu.mq.client import Publisher as RefPublisher
    from seaweedfs_tpu_torch.mq.client import MQError, Publisher

    srv = socketlib.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()

    def read_request(conn):
        """The whole request: headers to the blank line, then
        Content-Length bytes of body. The client writes headers and body
        separately, and a close with body bytes unread answers with an RST
        that the client would see before the half answer."""
        conn.settimeout(5)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(65536)
            if not chunk:
                return
            data += chunk
        head, _, body = data.partition(b"\r\n\r\n")
        length = 0
        for line in head.split(b"\r\n")[1:]:
            name, _, value = line.partition(b":")
            if name.strip().lower() == b"content-length":
                length = int(value.strip())
        while len(body) < length:
            chunk = conn.recv(65536)
            if not chunk:
                return
            body += chunk

    def serve():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                continue
            try:
                read_request(conn)
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Length: 69\r\n\r\n{")
            finally:
                conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.getsockname()[1]}"
    pub = (RefPublisher if pkg == "ref" else Publisher)(brokers=[url])
    try:
        if pkg == "ref":
            with pytest.raises(http.client.IncompleteRead):
                pub.publish("t", 1, key="k")
        else:
            with pytest.raises(MQError, match="IncompleteRead"):
                pub.publish("t", 1, key="k")
    finally:
        stop.set()
        t.join(5)
        srv.close()
        if hasattr(pub, "close"):
            pub.close()
