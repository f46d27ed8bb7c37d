"""The port's notification queues held against the JAX package's.

A JAX and a port cluster (`twin()` of `test_torch_filer_meta.py`), each
filer wired to its own package's queue, take the same writes, moves, links
and deletes: the `MemoryQueue` messages and the `KafkaQueue` payloads are
equal once `Norm` blanks the stamps that differ by design (times,
signatures) and ranks fids. The `FileQueue` spool holds the same bytes as
the JAX one for the same messages under one frozen day. `configure_notification`
builds every kind alike. `SqsQueue` and `GooglePubSubQueue` send the JAX
queues' requests, byte for byte, to one fake endpoint under one frozen
clock; the SQS fake verifies SigV4 server-side, as the JAX contract test
does, and a port `Filer` publishes through it.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import time
import urllib.parse

import pytest

from seaweedfs_tpu import notification as ref_notification
from seaweedfs_tpu.filer import Entry as RefEntry
from seaweedfs_tpu.filer import Filer as RefFiler
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.filer import Entry, Filer
from seaweedfs_tpu_torch.s3api.auth import canonical_request, signing_key, string_to_sign
from tests.test_torch_cloud_sinks import FROZEN_TIME, _QuietHandler, _start, _stop
from tests.test_torch_filer_meta import Norm, history, twin
from tests._threads import stop_history_loops  # noqa: F401

FROZEN_DAY = time.gmtime(FROZEN_TIME)


def norm_messages(side, messages) -> list:
    norm = Norm(side)
    return [(norm.text(k), norm(m)) for k, m in messages]


@pytest.fixture(scope="module")
def wired(tmp_path_factory):
    """Both clusters after the same history, each filer with a MemoryQueue
    of its own package."""
    queues = {"ref": ref_notification.MemoryQueue(), "port": notification.MemoryQueue()}
    with twin(str(tmp_path_factory.mktemp("notify")),
              filer_kw=lambda side, i: {"notification_queue": queues[side]}) as sides:
        for side in sides:
            history(side, "/n")
        yield sides, queues


def test_memory_queue_messages_equal_reference(wired):
    (ref, port), queues = wired
    got = norm_messages(port, queues["port"].messages)
    want = norm_messages(ref, queues["ref"].messages)
    assert got == want
    keys = [k for k, _ in got]
    assert "/n/dir/small.txt" in keys and "/n/dir/moved.bin" in keys
    assert any(m["new_entry"] is None for _, m in got)  # the recursive delete


def test_memory_queue_poll(wired):
    _, queues = wired
    q = queues["port"]
    n = len(q.messages)
    assert q.poll(n - 2) == q.messages[-2:]
    t0 = time.perf_counter()
    assert q.poll(n, timeout=0.2) == []
    assert time.perf_counter() - t0 >= 0.15
    empty = notification.MemoryQueue()
    assert empty.poll() == [] == ref_notification.MemoryQueue().poll()


def test_filer_events_equal_reference():
    """A bare `Filer` publishes create and delete (and the parent mkdirs)
    alike, as the JAX package's own notification test drives it."""
    out = []
    for filer_cls, entry_cls, pkg in ((RefFiler, RefEntry, ref_notification),
                                      (Filer, Entry, notification)):
        f = filer_cls()
        try:
            q = pkg.MemoryQueue()
            f.notification_queue = q
            f.create_entry(entry_cls(full_path="/a/b.txt", content=b"hi"))
            f.rename("/a/b.txt", "/a/c.txt")
            f.delete_entry("/a/c.txt")
            sig = f.signature
            msgs = q.messages
        finally:
            f.close()
        assert all(m["signatures"] == [sig] for _, m in msgs)
        norm = _NoNames()
        out.append([(k, norm(m)) for k, m in msgs])
    assert out[1] == out[0]
    keys = [k for k, _ in out[1]]
    assert keys.count("/a/b.txt") >= 1 and "/a/c.txt" in keys


class _NoNames(Norm):
    """`Norm` with no addresses to name (a bare Filer has none)."""

    def __init__(self) -> None:
        self.names, self.fids = {}, {}


def test_file_queue_spool_bytes_equal_reference(wired, tmp_path, monkeypatch):
    _, queues = wired
    monkeypatch.setattr(time, "gmtime", lambda *a: FROZEN_DAY)
    messages = queues["ref"].messages + [("/ü/é.txt", {"n": 1, "s": "€\n"})]
    spools = []
    for pkg, name in ((ref_notification, "ref"), (notification, "port")):
        q = pkg.FileQueue(str(tmp_path / name))
        for key, message in messages:
            q.send_message(key, message)
        assert q.read_all() == [(k, json.loads(json.dumps(m))) for k, m in messages]
        spools.append({p.name: p.read_bytes() for p in (tmp_path / name).iterdir()})
    assert list(spools[1]) == [time.strftime("%Y-%m-%d", FROZEN_DAY) + ".jsonl"]
    assert spools[1] == spools[0]


def test_file_queue_from_each_filer_equal_reference(tmp_path):
    """Each package's filer spools into its own FileQueue; read back, the
    messages are equal to the JAX ones once normalized."""
    spools = {"ref": ref_notification.FileQueue(str(tmp_path / "ref")),
              "port": notification.FileQueue(str(tmp_path / "port"))}
    with twin(str(tmp_path), filer_kw=lambda side, i: {"notification_queue": spools[side]}) \
            as sides:
        got = []
        for side in sides:
            history(side, "/f")
            got.append(norm_messages(side, spools[side.name].read_all()))
    assert got[1] == got[0] and len(got[1]) > 8


def test_configure_every_kind_alike(tmp_path, caplog):
    for kind, opts in (("memory", {}), ("log", {}),
                       ("file", {"spool_dir": str(tmp_path / "s")})):
        got = notification.configure_notification(kind, **opts)
        want = ref_notification.configure_notification(kind, **opts)
        assert got.kind == want.kind == kind
        assert type(got).__name__ == type(want).__name__
    for pkg in (notification, ref_notification):
        with pytest.raises(ValueError, match="bogus"):
            pkg.configure_notification("bogus")
        with pytest.raises(RuntimeError, match="kafka-python"):
            pkg.configure_notification("kafka", hosts=["h:9092"], topic="t")
    lines = []
    notification.LogQueue(printer=lines.append).send_message("/k", {"op": "x" * 300})
    ref_lines = []
    ref_notification.LogQueue(printer=ref_lines.append).send_message("/k", {"op": "x" * 300})
    assert lines == ref_lines and len(lines[0]) == len("notify /k: ") + 200
    with caplog.at_level(logging.DEBUG, logger="seaweedfs_tpu_torch.notification"):
        notification.LogQueue().send_message("/k", {"op": 1})
    assert caplog.records[-1].getMessage() == 'notify /k: {"op": 1}'


class FakeProducer:
    def __init__(self) -> None:
        self.sent = []

    def send(self, topic, key=None, value=None):
        self.sent.append((topic, key, value))


def test_kafka_queue_payloads_equal_reference(tmp_path):
    producers = {"ref": FakeProducer(), "port": FakeProducer()}
    queues = {"ref": ref_notification.KafkaQueue(["fake:9092"], "seaweed-events",
                                                 producer=producers["ref"]),
              "port": notification.KafkaQueue(["fake:9092"], "seaweed-events",
                                              producer=producers["port"])}
    assert queues["port"].kind == queues["ref"].kind == "kafka"
    with twin(str(tmp_path), filer_kw=lambda side, i: {"notification_queue": queues[side]}) \
            as sides:
        got = []
        for side in sides:
            history(side, "/k")
            sent = producers[side.name].sent
            assert {t for t, _, _ in sent} == {"seaweed-events"}
            got.append(norm_messages(side, [(k.decode(), json.loads(v)) for _, k, v in sent]))
    assert got[1] == got[0]
    assert any(m["new_entry"] is None for _, m in got[1])  # a delete


# --- SQS and Pub/Sub ------------------------------------------------------------------
@pytest.fixture()
def fake_sqs():
    sent: list[dict] = []
    log: list = []

    class Handler(_QuietHandler):
        def do_POST(self):
            body = self._body()
            # SigV4 recomputed server-side with the known secret
            auth = self.headers["Authorization"]
            assert auth.startswith("AWS4-HMAC-SHA256 Credential=AK/")
            scope = auth.split("Credential=AK/", 1)[1].split(",", 1)[0]
            date = scope.split("/", 1)[0]
            assert scope.endswith("/eu-west-1/sqs/aws4_request")
            headers = {"host": self.headers["Host"], "x-amz-date": self.headers["x-amz-date"],
                       "content-type": self.headers["Content-Type"]}
            canon = canonical_request("POST", self.path, [], headers, sorted(headers),
                                      hashlib.sha256(body).hexdigest())
            sig = hmac.new(signing_key("SK", date, "eu-west-1", "sqs"),
                           string_to_sign(self.headers["x-amz-date"], scope, canon).encode(),
                           hashlib.sha256).hexdigest()
            if f"Signature={sig}" not in auth:
                return self._reply(403, b"<Error/>")
            form = dict(urllib.parse.parse_qsl(body.decode()))
            if form["Action"] == "GetQueueUrl":
                assert form["QueueName"] == "events"
                port = self.server.server_address[1]
                return self._reply(200, (
                    "<GetQueueUrlResponse><GetQueueUrlResult><QueueUrl>"
                    f"http://127.0.0.1:{port}/123/events"
                    "</QueueUrl></GetQueueUrlResult></GetQueueUrlResponse>").encode(), "text/xml")
            if form["Action"] == "SendMessage":
                assert self.path == "/123/events"
                sent.append(form)
                return self._reply(200, b"<SendMessageResponse/>", "text/xml")
            return self._reply(400)

    Handler.log = log
    srv, url = _start(Handler)
    try:
        yield sent, url, log
    finally:
        _stop(srv)


SQS = dict(access_key="AK", secret_key="SK", region="eu-west-1", queue_name="events")


def test_sqs_send_signed(fake_sqs):
    sent, url, _ = fake_sqs
    q = notification.configure_notification("aws_sqs", endpoint=url, **SQS)
    assert q.kind == "aws_sqs" and q.queue_url.endswith("/123/events")
    q.send_message("/dir/f.txt", {"op": "create"})
    assert len(sent) == 1
    m = sent[0]
    assert json.loads(m["MessageBody"]) == {"op": "create"}
    assert m["MessageAttribute.1.Name"] == "key"
    assert m["MessageAttribute.1.Value.StringValue"] == "/dir/f.txt"
    assert m["DelaySeconds"] == "10"  # aws_sqs_pub.go:78


def test_sqs_wrong_secret_refused(fake_sqs):
    _, url, _ = fake_sqs
    with pytest.raises(IOError, match="sqs GetQueueUrl -> 403"):
        notification.configure_notification("aws_sqs", endpoint=url,
                                            **{**SQS, "secret_key": "bad"})


def test_sqs_requests_equal_reference(fake_sqs, monkeypatch):
    sent, url, log = fake_sqs
    monkeypatch.setattr(time, "gmtime", lambda *a: FROZEN_DAY)
    seen = []
    for pkg in (ref_notification, notification):
        log.clear()
        q = pkg.configure_notification("aws_sqs", endpoint=url, **SQS)
        q.send_message("/dir/ü.txt", {"op": "create", "n": [1, 2]})
        q.send_message("/dir/b.txt", {"op": "delete"})
        seen.append(list(log))
    assert len(seen[0]) == 3
    assert seen[1] == seen[0]


def test_filer_events_flow_to_sqs(fake_sqs):
    sent, url, _ = fake_sqs
    f = Filer()
    try:
        f.notification_queue = notification.configure_notification(
            "aws_sqs", endpoint=url, **SQS)
        f.create_entry(Entry(full_path="/n/a.txt"))
        f.delete_entry("/n/a.txt")
    finally:
        f.close()
    keys = [m["MessageAttribute.1.Value.StringValue"] for m in sent]
    assert keys.count("/n/a.txt") >= 2


@pytest.fixture()
def fake_pubsub():
    published: list[dict] = []
    topics: set[str] = set()
    log: list = []

    class Handler(_QuietHandler):
        def do_GET(self):
            self._body()
            ok = self.path.strip("/").removeprefix("v1/") in topics
            self._reply(200 if ok else 404, b"{}")

        def do_PUT(self):
            self._body()
            topics.add(self.path.strip("/").removeprefix("v1/"))
            self._reply(200, b"{}")

        def do_POST(self):
            assert self.path.endswith(":publish")
            published.append(json.loads(self._body()))
            self._reply(200, b'{"messageIds": ["1"]}')

    Handler.log = log
    srv, url = _start(Handler)
    try:
        yield published, topics, url, log
    finally:
        _stop(srv)


def test_pubsub_publish_and_autocreate(fake_pubsub):
    published, topics, url, _ = fake_pubsub
    q = notification.configure_notification(
        "google_pub_sub", project="proj", topic="seaweed", endpoint=url)
    assert "projects/proj/topics/seaweed" in topics
    q.send_message("/k.txt", {"op": "delete"})
    msg = published[0]["messages"][0]
    assert json.loads(base64.b64decode(msg["data"])) == {"op": "delete"}
    assert msg["attributes"]["key"] == "/k.txt"
    with pytest.raises(ValueError, match="credentials"):
        notification.configure_notification("google_pub_sub", project="p", topic="t")


def test_pubsub_requests_equal_reference(fake_pubsub):
    published, topics, url, log = fake_pubsub
    seen = []
    for pkg in (ref_notification, notification):
        log.clear()
        topics.clear()
        q = pkg.configure_notification("google_pub_sub", project="proj", topic="seaweed",
                                       endpoint=url, token_provider=lambda: "tok")
        q.send_message("/k.txt", {"op": "delete"})
        q.send_message("/dir/ü", {"op": "create"})
        seen.append(list(log))
    assert [r[0] for r in seen[0]] == ["GET", "PUT", "POST", "POST"]
    assert seen[1] == seen[0]


def test_pubsub_credentials_file_reaches_the_port_provider(fake_pubsub, tmp_path, monkeypatch):
    """`google_application_credentials` builds the OAuth2 provider from the
    port's own `replication/cloud_sinks.py`, with the Pub/Sub scope."""
    pytest.importorskip("cryptography", reason="the JWT grant needs RSA")
    from seaweedfs_tpu_torch.replication import cloud_sinks

    calls = []

    def provider(creds, token_url=None, scope=None):
        calls.append((creds, scope))
        return lambda: "tok-from-file"

    monkeypatch.setattr(cloud_sinks, "service_account_token_provider", provider)
    creds = {"client_email": "svc@proj", "private_key": "pem"}
    path = tmp_path / "key.json"
    path.write_text(json.dumps(creds))
    published, _, url, log = fake_pubsub
    q = notification.configure_notification(
        "google_pub_sub", project="proj", topic="t", endpoint=url,
        google_application_credentials=str(path))
    q.send_message("/x", {"op": 1})
    assert calls == [(creds, "https://www.googleapis.com/auth/pubsub")]
    assert dict(log[-1][2])["Authorization"] == "Bearer tok-from-file"
