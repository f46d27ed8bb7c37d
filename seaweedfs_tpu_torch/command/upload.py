"""`weed-tpu upload` / `download` (reference: `weed/command/upload.go`,
`download.go`): assign + direct volume-server PUT/GET. The port's copy of
`seaweedfs_tpu/command/upload.py`, over the port's `filer/wdclient.WeedClient`."""

from __future__ import annotations

import argparse
import mimetypes
import os


def run(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu upload")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-replication", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("files", nargs="+")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.filer.wdclient import WeedClient

    client = WeedClient(opts.master)
    import json

    results = []
    for path in opts.files:
        with open(path, "rb") as f:
            data = f.read()
        mime = mimetypes.guess_type(path)[0] or ""
        out = client.upload(
            data,
            replication=opts.replication,
            collection=opts.collection,
            ttl=opts.ttl,
            filename=os.path.basename(path),
            mime=mime,
        )
        results.append(
            {"fileName": os.path.basename(path), "fid": out["fid"],
             "url": f"{out['url']}/{out['fid']}", "size": len(data)}
        )
    print(json.dumps(results, indent=2))
    return 0


def run_download(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="weed-tpu download")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-dir", default=".")
    p.add_argument("fids", nargs="+")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.filer.wdclient import WeedClient

    client = WeedClient(opts.master)
    for fid in opts.fids:
        data = client.fetch(fid)
        out = os.path.join(opts.dir, fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
    return 0
