"""`weed-tpu filer.sync` + `filer.replicate` + `filer.backup` +
`filer.remote.sync` (reference: `weed/command/filer_sync.go:119-385`,
`filer_replication.go`, `filer_backup.go`, `filer_remote_sync.go`).

filer.sync: continuous bidirectional (or -oneWay) active-active sync between
two filers using metadata subscription with signature loop-prevention.
filer.replicate: consume a notification spool and apply to a sink.
filer.backup: mirror a filer tree into a local directory, then keep
following the metadata stream.
filer.remote.sync: follow a remote-mounted directory's metadata stream on a
filer and write local changes back to the remote store.

The port's copy of `seaweedfs_tpu/command/filer_sync.py`, over the port's
`replication/` and `notification/`. With `-once`, `filer.replicate`,
`filer.backup` and `filer.remote.sync` close their filer clients before
they return (the port's `FilerClient` keeps connections alive; the JAX
one opens one a call); the code is otherwise the JAX code as it stands.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from ..filer.filer_client import FilerClient
from ..notification import FileQueue
from ..remote_storage import make_remote_client
from ..replication import FilerSink, FilerSyncer, LocalSink, Replicator, S3Sink
from ..server.httpd import http_request


def run_filer_sync(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu filer.sync")
    p.add_argument("-a", required=True, help="filer A url")
    p.add_argument("-b", required=True, help="filer B url")
    p.add_argument("-isActivePassive", action="store_true",
                   help="one-way A->B only")
    p.add_argument("-interval", type=float, default=1.0)
    opts = p.parse_args(args)

    stop = threading.Event()
    ab = FilerSyncer(opts.a, opts.b)
    threads = [threading.Thread(
        target=ab.run_forever, args=(opts.interval, stop), daemon=True
    )]
    print(f"sync {opts.a} -> {opts.b} (sig {ab.source_signature})")
    if not opts.isActivePassive:
        ba = FilerSyncer(opts.b, opts.a)
        threads.append(threading.Thread(
            target=ba.run_forever, args=(opts.interval, stop), daemon=True
        ))
        print(f"sync {opts.b} -> {opts.a} (sig {ba.source_signature})")
    for t in threads:
        t.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop.set()
    return 0


def run_filer_replicate(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu filer.replicate")
    p.add_argument("-notification.spool", dest="spool", required=True,
                   help="file-queue spool dir to consume")
    p.add_argument("-source", required=True, help="source filer url")
    p.add_argument("-sink.local", dest="sink_local", default=None,
                   help="mirror into this directory")
    p.add_argument("-sink.filer", dest="sink_filer", default=None,
                   help="replicate to this filer url")
    p.add_argument("-sink.s3.endpoint", dest="sink_s3_endpoint", default=None,
                   help="replicate into an S3 endpoint (any S3 API, incl. "
                        "this framework's own gateway)")
    p.add_argument("-sink.s3.bucket", dest="sink_s3_bucket", default="backup")
    p.add_argument("-sink.s3.prefix", dest="sink_s3_prefix", default="")
    p.add_argument("-sink.s3.accessKey", dest="sink_s3_ak", default="")
    p.add_argument("-sink.s3.secretKey", dest="sink_s3_sk", default="")
    p.add_argument("-sink.azure.account", dest="sink_az_account", default=None,
                   help="replicate into an Azure Blob container")
    p.add_argument("-sink.azure.key", dest="sink_az_key", default="")
    p.add_argument("-sink.azure.container", dest="sink_az_container",
                   default="backup")
    p.add_argument("-sink.azure.endpoint", dest="sink_az_endpoint",
                   default=None)
    p.add_argument("-sink.gcs.bucket", dest="sink_gcs_bucket", default=None,
                   help="replicate into a GCS bucket (JSON API)")
    p.add_argument("-sink.gcs.credentials", dest="sink_gcs_creds", default="",
                   help="service-account JSON key file")
    p.add_argument("-sink.gcs.endpoint", dest="sink_gcs_endpoint",
                   default="https://storage.googleapis.com")
    p.add_argument("-sink.b2.accountId", dest="sink_b2_account", default=None,
                   help="replicate into a Backblaze B2 bucket")
    p.add_argument("-sink.b2.applicationKey", dest="sink_b2_key", default="")
    p.add_argument("-sink.b2.bucket", dest="sink_b2_bucket", default="backup")
    p.add_argument("-sink.b2.endpoint", dest="sink_b2_endpoint",
                   default="https://api.backblazeb2.com")
    p.add_argument("-interval", type=float, default=1.0)
    p.add_argument("-once", action="store_true", help="drain spool and exit")
    opts = p.parse_args(args)

    if opts.sink_local:
        sink = LocalSink(opts.sink_local)
    elif opts.sink_filer:
        sink = FilerSink(opts.sink_filer)
    elif opts.sink_s3_endpoint:
        sink = S3Sink(
            opts.sink_s3_endpoint, opts.sink_s3_bucket,
            access_key=opts.sink_s3_ak, secret_key=opts.sink_s3_sk,
            prefix=opts.sink_s3_prefix,
        )
    elif opts.sink_az_account:
        from ..replication.cloud_sinks import AzureSink

        sink = AzureSink(opts.sink_az_account, opts.sink_az_key,
                         opts.sink_az_container,
                         endpoint=opts.sink_az_endpoint)
    elif opts.sink_gcs_bucket:
        from ..replication.cloud_sinks import (
            GcsSink,
            service_account_token_provider,
        )

        if not opts.sink_gcs_creds:
            print("-sink.gcs.bucket needs -sink.gcs.credentials "
                  "(service-account JSON key file)")
            return 1
        with open(opts.sink_gcs_creds) as fh:
            creds = json.load(fh)
        sink = GcsSink(opts.sink_gcs_bucket,
                       service_account_token_provider(creds),
                       endpoint=opts.sink_gcs_endpoint)
    elif opts.sink_b2_account:
        from ..replication.cloud_sinks import B2Sink

        sink = B2Sink(opts.sink_b2_account, opts.sink_b2_key,
                      opts.sink_b2_bucket, endpoint=opts.sink_b2_endpoint)
    else:
        print("need a -sink.{local,filer,s3,azure,gcs,b2} target")
        return 1
    src = FilerClient(opts.source)
    rep = Replicator(sink, read_content=lambda path, entry: src.read(path))
    queue = FileQueue(opts.spool)
    seen = 0
    while True:
        msgs = queue.read_all()
        for _, message in msgs[seen:]:
            try:
                rep.replicate(message)
            except Exception as e:
                print(f"replicate error: {e}")
        seen = len(msgs)
        if opts.once:
            src.close()
            sink.close()
            return 0
        time.sleep(opts.interval)


def run_filer_backup(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu filer.backup")
    p.add_argument("-filer", required=True)
    p.add_argument("-output", required=True, help="local mirror directory")
    p.add_argument("-path", default="/", help="subtree to back up")
    p.add_argument("-interval", type=float, default=1.0)
    p.add_argument("-once", action="store_true",
                   help="full copy + drain, then exit")
    opts = p.parse_args(args)

    client = FilerClient(opts.filer)
    sink = LocalSink(opts.output)
    rep = Replicator(sink, read_content=lambda path, entry: client.read(path))

    # initial full walk (the reference starts from a timestamp; we snapshot)
    def walk(dir_path: str) -> None:
        for e in client.list(dir_path).get("Entries") or []:
            full = e["FullPath"]
            if not full.startswith(opts.path) and not opts.path.startswith(full):
                continue
            if e["IsDirectory"]:
                sink.create_entry(full, {"is_directory": True}, None)
                walk(full)
            else:
                sink.create_entry(full, {}, client.read(full))

    start_ns = time.time_ns()
    walk("/")
    print(f"initial backup of {opts.path} complete")
    syncer = FilerSyncer.__new__(FilerSyncer)  # follow stream into LocalSink
    syncer.source = client
    syncer.source_url = opts.filer
    syncer.target_signature = -1  # never skip
    syncer.replicator = rep
    syncer.cursor_ns = start_ns
    if opts.once:
        try:
            syncer.run_once()
        finally:
            client.close()
        return 0
    while True:
        try:
            syncer.run_once(wait=opts.interval)
        except Exception as e:
            print(f"backup follow error: {e}")
            time.sleep(opts.interval)


def run_filer_remote_sync(args: list[str]) -> int:
    """`weed-tpu filer.remote.sync`: follow a mounted directory's metadata
    stream and write local changes back to the remote store
    (`weed/command/filer_remote_sync.go`). Cache-fill updates echo one
    idempotent write per object; stub creations (no chunks/content) are
    skipped."""
    p = argparse.ArgumentParser(prog="weed-tpu filer.remote.sync")
    p.add_argument("-filer", required=True)
    p.add_argument("-dir", required=True, help="mounted directory")
    p.add_argument("-interval", type=float, default=1.0)
    p.add_argument("-once", action="store_true")
    p.add_argument("-timeAgo", type=float, default=0.0,
                   help="start from this many seconds in the past")
    opts = p.parse_args(args)

    filer_url = opts.filer.rstrip("/")
    client = FilerClient(filer_url)
    mount_dir = opts.dir.rstrip("/")

    status, _, body = http_request("GET", f"{filer_url}/__remote__/mounts")
    mounts = json.loads(body)["mounts"]
    if mount_dir not in mounts:
        print(f"{mount_dir} is not remote-mounted on {filer_url}")
        return 1
    mount = mounts[mount_dir]

    # conf lives on the filer; fetch it via the configure listing
    status, _, body = http_request(
        "GET", f"{filer_url}/etc/remote/remote.conf"
    )
    confs = json.loads(body)
    remote = make_remote_client(confs[mount["config"]])
    base = mount.get("path", "").strip("/")

    def remote_key(full_path: str) -> str:
        rel = full_path[len(mount_dir):].lstrip("/")
        return f"{base}/{rel}".lstrip("/") if base else rel

    cursor = time.time_ns() - int(opts.timeAgo * 1e9)

    def run_once(wait: float = 0.0) -> int:
        nonlocal cursor
        status, _, body = http_request(
            "GET",
            f"{filer_url}/__meta__/events?since_ns={cursor}&wait={wait}",
            timeout=wait + 30,
        )
        out = json.loads(body)
        applied = 0
        for ev in out["events"]:
            new, old = ev.get("new_entry"), ev.get("old_entry")
            if new is not None:
                path = new["full_path"]
                if not path.startswith(mount_dir + "/"):
                    continue
                if new.get("is_directory"):
                    continue
                if not new.get("chunks") and not new.get("content"):
                    continue  # remote stub, nothing local to push
                try:
                    data = client.read(path)
                except OSError:
                    continue  # deleted/overwritten since the event was logged
                remote.write_file(remote_key(path), data)
                applied += 1
            elif old is not None:
                path = old["full_path"]
                if not path.startswith(mount_dir + "/"):
                    continue
                if old.get("is_directory"):
                    continue
                remote.delete_file(remote_key(path))
                applied += 1
        cursor = out["next_ts_ns"]
        return applied

    print(f"write-back {mount_dir} -> {mount['config']}")
    if opts.once:
        try:
            run_once()
        finally:
            client.close()
        return 0
    while True:
        try:
            run_once(wait=opts.interval)
        except Exception as e:
            print(f"remote sync error: {e}")
            time.sleep(opts.interval)
