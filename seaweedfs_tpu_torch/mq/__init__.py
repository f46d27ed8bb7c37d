"""SeaweedMQ subset: stateless brokers persisting topics into the filer.

Behavioral port of `weed/mq` (`broker/broker_server.go:53`,
`pub_balancer/`, `sub_coordinator/`, `weed/pb/mq.proto:13-52`):

  - topics live under `/topics/<namespace>/<topic>/` in the filer; each
    partition is a sequence of JSON-lines segment files plus the broker's
    in-memory tail (same layering as the filer's own metadata log)
  - brokers are stateless: all durable state is in the filer, so a broker
    restart (or a different broker) resumes from the flushed segments
  - partition→broker ownership uses rendezvous hashing over live brokers
    (the reference's pub_balancer assigns partitions; a non-owner answers
    `moved_to` so publishers re-target)
  - consumer groups commit offsets per (topic, group, partition), stored in
    the filer too (`sub_coordinator/` offset files)

The port's copy of `seaweedfs_tpu/mq/`, over the port's filer.
"""

from .broker import BrokerServer, TopicPartition  # noqa: F401
from .client import Consumer, MQError, Publisher  # noqa: F401
