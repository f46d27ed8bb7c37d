"""`weed-tpu scaffold` — print starter TOML configs
(`weed/command/scaffold.go` + `weed/command/scaffold/*.toml`). The port's
copy of `seaweedfs_tpu/command/scaffold.py`: every template byte-equal."""

from __future__ import annotations

import argparse

TEMPLATES = {
    "security": '''\
# security.toml — JWT signing + IP guard
# put this file to ./ , ~/.seaweedfs/ , or /etc/seaweedfs/

[jwt.signing]
key = ""                      # base64 or raw secret; empty = auth disabled
expires_after_seconds = 10

[jwt.signing.read]
key = ""
expires_after_seconds = 60

[guard]
white_list = []               # e.g. ["127.0.0.1", "10.0.0.0/8"]

[tls]                         # mutual TLS for every listener + client
ca = ""                       # e.g. "/etc/seaweedfs/ca.pem"; empty = plain HTTP
cert = ""                     # this node's certificate (signed by ca)
key = ""                      # this node's private key
allowed_commonNames = ""      # e.g. "master1,volume*"; "" = any CA-signed cert
''',
    "filer": '''\
# filer.toml — filer metadata store
[filer.options]
recursive_delete = false

[memory]                      # non-durable, dev only
enabled = true

[sqlite]
enabled = false
dbFile = "./filer.db"

[leveldb]                     # embedded WAL+snapshot KV store
enabled = false
dir = "./filerldb"

[lsm]                         # embedded LSM/SSTable store (leveldb-class;
enabled = false               # cold metadata stays on disk)
dir = "./filerlsm"
''',
    "master": '''\
# master.toml — volume growth + sequencer
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1

[master.sequencer]
type = "raft"                 # raft | snowflake
''',
    "notification": '''\
# notification.toml — filer mutation event bus
[notification.log]
enabled = false

[notification.file]
enabled = false
spool_dir = "./notify-spool"

[notification.kafka]
enabled = false
hosts = ["localhost:9092"]
topic = "seaweedfs_filer"
''',
    "replication": '''\
# replication.toml — filer.replicate sinks
[source.filer]
enabled = true
grpcAddress = "localhost:8888"

[sink.local]
enabled = false
directory = "/backup"

[sink.filer]
enabled = false
grpcAddress = "localhost:8889"
''',
    "shell": '''\
# shell.toml — admin shell defaults
[cluster]
default = "localhost"

[cluster.localhost]
master = "localhost:9333"
filer = "localhost:8888"
''',
}


def run(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu scaffold")
    p.add_argument("-config", default="filer",
                   choices=sorted(TEMPLATES.keys()))
    p.add_argument("-output", default="", help="write to dir instead of stdout")
    opts = p.parse_args(args)
    body = TEMPLATES[opts.config]
    if opts.output:
        import os

        path = os.path.join(opts.output, f"{opts.config}.toml")
        with open(path, "w") as f:
            f.write(body)
        print(f"wrote {path}")
    else:
        print(body, end="")
    return 0
