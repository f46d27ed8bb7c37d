"""`weed-tpu filer.remote.sync` (reference:
`weed/command/filer_remote_sync.go`): follow a remote-mounted directory's
metadata stream on a filer and write local changes back to the remote
store.

The port's copy of `run_filer_remote_sync` from
`seaweedfs_tpu/command/filer_sync.py`. Not ported yet: `run_filer_sync`,
`run_filer_replicate` and `run_filer_backup`, which need `replication/` and
`notification/` (ROADMAP 10d-3b).
"""

from __future__ import annotations

import argparse
import json
import time

from ..filer.filer_client import FilerClient
from ..remote_storage import make_remote_client
from ..server.httpd import http_request


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
