"""Notification bus: pluggable publish of filer metadata mutations.

Behavioral port of `weed/notification/configuration.go` + per-backend dirs
(log, kafka, aws_sqs, google_pub_sub, gocdk_pub_sub): the filer publishes
each entry mutation as an EventNotification message keyed by its full path;
`weed filer.replicate` consumes the queue and applies events to sinks.

Backends here:
  - `LogQueue` — print-only (reference `notification/log/`)
  - `MemoryQueue` — in-process buffer (tests, embedded replicate loops)
  - `FileQueue` — durable JSON-lines spool directory; a consumer tails it
    (stand-in for kafka/sqs with the same at-least-once contract)
  - `KafkaQueue` — gated on a kafka client being importable (not baked in)

Configured via `configure_notification()` from `notification.toml`'s
equivalent (`[notification.<kind>] enabled=true`).

The port's copy of `seaweedfs_tpu/notification/__init__.py`; a queue plugs
into the port filer's `notification_queue=` as is. Difference from the JAX
package: `LogQueue` logs through `logging` at DEBUG (the JAX one through
its `glog` at verbosity 1).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable

log = logging.getLogger(__name__)


class NotificationQueue:
    kind = "none"

    def send_message(self, key: str, message: dict) -> None:
        raise NotImplementedError


class LogQueue(NotificationQueue):
    kind = "log"

    def __init__(self, printer: Callable[[str], None] | None = None) -> None:
        self._print = printer or log.debug

    def send_message(self, key: str, message: dict) -> None:
        self._print(f"notify {key}: {json.dumps(message)[:200]}")


class MemoryQueue(NotificationQueue):
    kind = "memory"

    def __init__(self) -> None:
        self.messages: list[tuple[str, dict]] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def send_message(self, key: str, message: dict) -> None:
        with self._cond:
            self.messages.append((key, message))
            self._cond.notify_all()

    def poll(self, start: int = 0, timeout: float = 0.0) -> list[tuple[str, dict]]:
        with self._cond:
            if len(self.messages) <= start and timeout > 0:
                self._cond.wait(timeout)
            return self.messages[start:]


class FileQueue(NotificationQueue):
    """Append-only JSON-lines spool, one file per day; `read_from(offset)`
    lets a consumer resume from a byte cursor (at-least-once)."""

    kind = "file"

    def __init__(self, spool_dir: str) -> None:
        self.dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        self._lock = threading.Lock()

    def _spool_path(self) -> str:
        return os.path.join(
            self.dir, time.strftime("%Y-%m-%d", time.gmtime()) + ".jsonl"
        )

    def send_message(self, key: str, message: dict) -> None:
        line = json.dumps({"key": key, "message": message}) + "\n"
        with self._lock:
            with open(self._spool_path(), "a") as f:
                f.write(line)

    def read_all(self) -> list[tuple[str, dict]]:
        out: list[tuple[str, dict]] = []
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".jsonl"):
                continue
            with open(os.path.join(self.dir, name)) as f:
                for line in f:
                    if line.strip():
                        d = json.loads(line)
                        out.append((d["key"], d["message"]))
        return out


class KafkaQueue(NotificationQueue):
    kind = "kafka"

    def __init__(self, hosts: list[str], topic: str, producer=None) -> None:
        self.topic = topic
        if producer is not None:
            self._producer = producer  # injected (contract tests use a fake)
            return
        try:
            from kafka import KafkaProducer
        except ImportError as e:
            raise RuntimeError(
                "kafka notification backend requires kafka-python"
            ) from e
        self._producer = KafkaProducer(bootstrap_servers=hosts)

    def send_message(self, key: str, message: dict) -> None:
        self._producer.send(
            self.topic, key=key.encode(), value=json.dumps(message).encode()
        )


def configure_notification(kind: str, **opts) -> NotificationQueue:
    if kind == "log":
        return LogQueue()
    if kind == "memory":
        return MemoryQueue()
    if kind == "file":
        return FileQueue(opts["spool_dir"])
    if kind == "kafka":
        return KafkaQueue(opts["hosts"], opts["topic"])  # pragma: no cover
    if kind == "aws_sqs":
        from .cloud import SqsQueue

        return SqsQueue(
            opts.get("access_key", ""), opts.get("secret_key", ""),
            opts.get("region", "us-east-1"), opts["queue_name"],
            endpoint=opts.get("endpoint"),
        )
    if kind == "google_pub_sub":
        from .cloud import GooglePubSubQueue

        provider = opts.get("token_provider")
        if provider is None and opts.get("google_application_credentials"):
            # config files can only carry strings: build the OAuth2 provider
            # from the service-account key path, like the reference's
            # google_application_credentials option
            from ..replication.cloud_sinks import service_account_token_provider

            with open(opts["google_application_credentials"]) as fh:
                creds = json.load(fh)
            provider = service_account_token_provider(
                creds, scope="https://www.googleapis.com/auth/pubsub"
            )
        return GooglePubSubQueue(
            opts["project"], opts["topic"],
            token_provider=provider,
            endpoint=opts.get("endpoint", "https://pubsub.googleapis.com"),
        )
    raise ValueError(f"unknown notification kind {kind!r}")
