"""`backup` / `compact` / `export` — offline volume tools (reference:
`weed/command/backup.go`, `compact.go`, `export.go`). The port's copy of
`seaweedfs_tpu/command/volume_tools.py`: `backup` pulls a whole volume over
`/admin/volume/raw`, then only the needles appended since over
`/admin/tail`."""

from __future__ import annotations

import argparse
import os


def run_compact(args: list[str]) -> int:
    """Offline vacuum of a local volume (`weed/command/compact.go`)."""
    p = argparse.ArgumentParser(prog="compact")
    p.add_argument("-dir", default=".")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(opts.dir, opts.collection, opts.volumeId)
    before = v.size()
    garbage = v.garbage_level()
    v.compact()
    v.commit_compact()
    after = v.size()
    v.close()
    print(
        f"volume {opts.volumeId}: {before} -> {after} bytes "
        f"(garbage was {garbage:.1%})"
    )
    return 0


def run_export(args: list[str]) -> int:
    """Dump live needles to a tar or directory (`weed/command/export.go`)."""
    import tarfile
    import time

    p = argparse.ArgumentParser(prog="export")
    p.add_argument("-dir", default=".")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-o", default="", help="output .tar (default: stdout list)")
    p.add_argument("-outputDir", default="", help="extract into a directory")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(opts.dir, opts.collection, opts.volumeId)
    tar = tarfile.open(opts.o, "w") if opts.o else None
    count = 0
    for key, offset, size in v.nm.ascending_visit():
        n = v.read_needle(key)
        name = (
            n.name.decode("utf-8", "replace")
            if n.has_name() and n.name else f"{key:x}"
        )
        if tar is not None:
            info = tarfile.TarInfo(name=f"vol{opts.volumeId}/{name}")
            info.size = len(n.data)
            info.mtime = n.last_modified or int(time.time())
            import io

            tar.addfile(info, io.BytesIO(n.data))
        elif opts.outputDir:
            dst = os.path.join(opts.outputDir, name)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            with open(dst, "wb") as f:
                f.write(n.data)
        else:
            print(f"{key:x}\t{name}\t{len(n.data)}")
        count += 1
    if tar is not None:
        tar.close()
        print(f"exported {count} needles -> {opts.o}")
    elif opts.outputDir:
        print(f"exported {count} needles -> {opts.outputDir}")
    v.close()
    return 0


def run_backup(args: list[str]) -> int:
    """Incrementally mirror a live volume to a local dir
    (`weed/command/backup.go`: full copy first, then AppendAtNs-tail)."""
    p = argparse.ArgumentParser(prog="backup")
    p.add_argument("-server", required=True, help="volume server host:port")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dir", default=".", help="local backup directory")
    opts = p.parse_args(args)

    from seaweedfs_tpu_torch.server.httpd import http_request
    from seaweedfs_tpu_torch.storage.volume import Volume, volume_file_name

    server = opts.server
    if not server.startswith("http"):
        server = f"http://{server}"
    base = volume_file_name(opts.dir, opts.collection, opts.volumeId)
    os.makedirs(opts.dir, exist_ok=True)

    def pull(ext: str, dest: str) -> None:
        offset = 0
        with open(dest + ".pull", "wb") as f:
            while True:
                url = (
                    f"{server}/admin/volume/raw?volume={opts.volumeId}"
                    f"&ext={ext}&collection={opts.collection}"
                    f"&offset={offset}&size={16 * 1024 * 1024}"
                )
                status, headers, body = http_request("GET", url, timeout=120)
                if status != 200:
                    raise IOError(f"pull {ext}: {status} {body[:200]!r}")
                f.write(body)
                offset += len(body)
                total = int(headers.get("X-Total-Size", offset))
                if offset >= total or not body:
                    break
        os.replace(dest + ".pull", dest)

    if not os.path.exists(base + ".dat"):
        pull(".dat", base + ".dat")
        pull(".idx", base + ".idx")
        print(f"full backup of volume {opts.volumeId} -> {base}.dat")
        return 0

    # incremental: ship only needles appended after our last timestamp
    v = Volume(opts.dir, opts.collection, opts.volumeId)
    since = v.last_append_at_ns
    v.close()
    status, _, delta = http_request(
        "GET",
        f"{server}/admin/tail?volume={opts.volumeId}&since_ns={since}",
        timeout=120,
    )
    if status != 200:
        raise IOError(f"tail: {status} {delta[:200]!r}")
    if delta:
        with open(base + ".dat", "ab") as f:
            f.write(delta)
        # rebuild the idx from the dat (the same scan as `fix`)
        from seaweedfs_tpu_torch.command.fix import run as fix_run

        fix_run(["-dir", opts.dir, "-collection", opts.collection,
                 "-volumeId", str(opts.volumeId)])
    print(
        f"incremental backup of volume {opts.volumeId}: +{len(delta)} bytes"
    )
    return 0
