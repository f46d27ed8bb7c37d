"""s3.* commands (reference `weed/shell/command_s3_bucket_create.go`,
`_delete.go`, `_list.go`, `_quota.go`, `command_s3_clean_uploads.go`,
`command_s3_configure.go`, `command_s3_circuitbreaker.go`).

The port's copy of `seaweedfs_tpu/shell/commands_s3.py`, over the port's
`server/httpd.py`."""

from __future__ import annotations

import json
import time

from ..server.httpd import http_request
from .env import CommandEnv, ShellError
from .registry import command, parse_flags

BUCKETS_DIR = "/buckets"


def _filer(env: CommandEnv) -> str:
    return env.require_filer()


@command("s3.bucket.list", "list S3 buckets (collections under /buckets)")
def cmd_s3_bucket_list(env: CommandEnv, args: list[str]) -> str:
    status, _, body = env.filer_read(BUCKETS_DIR, "limit=10000")
    if status == 404:
        return "(no buckets)"
    listing = json.loads(body)
    lines = []
    for e in listing.get("Entries") or []:
        if e["IsDirectory"]:
            lines.append(e["FullPath"].rsplit("/", 1)[-1])
    return "\n".join(lines) if lines else "(no buckets)"


@command("s3.bucket.create", "-name <bucket>")
def cmd_s3_bucket_create(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    name = flags["name"]
    env.post(f"{_filer(env)}{BUCKETS_DIR}/{name}?mkdir=true")
    return f"created bucket {name}"


@command("s3.bucket.delete", "-name <bucket> — delete the bucket and all objects")
def cmd_s3_bucket_delete(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    name = flags["name"]
    status, _, _ = env.filer_read(f"{BUCKETS_DIR}/{name}", "metadata=true")
    if status == 404:
        raise ShellError(f"bucket {name!r} not found")
    http_request(
        "DELETE", f"{_filer(env)}{BUCKETS_DIR}/{name}?recursive=true", timeout=60)
    return f"deleted bucket {name}"


@command("s3.bucket.quota", "-name <bucket> [-sizeMB n] — set/show bucket quota")
def cmd_s3_bucket_quota(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    name = flags["name"]
    path = f"{BUCKETS_DIR}/{name}"
    status, _, body = env.filer_read(path, "metadata=true")
    if status == 404:
        raise ShellError(f"bucket {name!r} not found")
    entry = json.loads(body)
    if "sizeMB" in flags:
        entry.setdefault("extended", {})["quota.bytes"] = str(
            int(flags["sizeMB"]) * 1024 * 1024
        )
        http_request(
            "PUT", f"{_filer(env)}{path}?meta.entry=true",
            body=json.dumps(entry).encode(),
            headers={"Content-Type": "application/json"}, timeout=60)
        return f"bucket {name} quota set to {flags['sizeMB']}MB"
    quota = (entry.get("extended") or {}).get("quota.bytes", "")
    return f"bucket {name} quota: {quota or '(none)'}"


@command("s3.clean.uploads", "[-timeAgo 24h] — abort stale multipart staging dirs")
def cmd_s3_clean_uploads(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    age_spec = flags.get("timeAgo", "24h")
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}
    unit = age_spec[-1] if age_spec[-1] in mult else "h"
    num = float(age_spec.rstrip("smhd") or 24)
    cutoff = time.time() - num * mult[unit]

    status, _, body = env.filer_read(BUCKETS_DIR, "limit=10000")
    if status == 404:
        return "(no buckets)"
    removed = []
    for e in json.loads(body).get("Entries") or []:
        if not e["IsDirectory"]:
            continue
        uploads_dir = e["FullPath"] + "/.uploads"
        status2, _, body2 = env.filer_read(uploads_dir, "limit=10000")
        if status2 != 200:
            continue
        for u in json.loads(body2).get("Entries") or []:
            if u.get("Mtime", 0) < cutoff:
                http_request(
                    "DELETE", f"{_filer(env)}{u['FullPath']}?recursive=true", timeout=60)
                removed.append(u["FullPath"])
    return f"removed {len(removed)} stale multipart uploads" + (
        "\n" + "\n".join(removed) if removed else ""
    )


@command("s3.configure",
         "-user <name> -access_key <ak> -secret_key <sk> [-actions Read,Write]"
         " [-buckets b1,b2] [-delete] — manage S3 identities")
def cmd_s3_configure(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = "/etc/iam/identity.json"
    status, _, body = env.filer_read(path)
    config = json.loads(body) if status == 200 and body else {"identities": []}
    identities = config.setdefault("identities", [])
    if not flags.get("user"):
        return json.dumps(config, indent=2)
    name = flags["user"]
    identities[:] = [i for i in identities if i.get("name") != name]
    if flags.get("delete") != "true":
        actions = flags.get("actions", "Read,Write,List").split(",")
        if flags.get("buckets"):
            actions = [
                f"{a}:{b}"
                for a in actions
                for b in flags["buckets"].split(",")
            ]
        identities.append({
            "name": name,
            "credentials": [{
                "accessKey": flags.get("access_key", ""),
                "secretKey": flags.get("secret_key", ""),
            }],
            "actions": actions,
        })
    http_request(
        "PUT", f"{_filer(env)}{path}",
        body=json.dumps(config, indent=2).encode(),
        headers={"Content-Type": "application/json"}, timeout=60)
    verb = "removed" if flags.get("delete") == "true" else "configured"
    return f"{verb} identity {name!r} ({len(identities)} identities total)"


@command("s3.circuitbreaker",
         "[-global.readLimit n] [-global.writeLimit n] — show/update the S3 "
         "gateway concurrency limits config")
def cmd_s3_circuitbreaker(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = "/etc/s3/circuit_breaker.json"
    status, _, body = env.filer_read(path)
    config = json.loads(body) if status == 200 and body else {"global": {}}
    changed = False
    for k, target in (("global.readLimit", "readLimit"),
                      ("global.writeLimit", "writeLimit")):
        if k in flags:
            config.setdefault("global", {})[target] = int(flags[k])
            changed = True
    if changed:
        http_request(
            "PUT", f"{_filer(env)}{path}",
            body=json.dumps(config).encode(),
            headers={"Content-Type": "application/json"}, timeout=60)
    return json.dumps(config, indent=2)


@command("s3.bucket.quota.enforce",
         "[-apply] — check every bucket's usage vs quota; -apply flips"
         " over-quota buckets read-only (and under-quota ones writable)")
def cmd_s3_bucket_quota_enforce(env: CommandEnv, args: list[str]) -> str:
    """`command_s3_bucket_quota_check.go`: walk the buckets, compare used
    bytes against the quota.bytes extended attribute, and (with -apply)
    set/clear the s3-read-only attribute the gateway's write paths honor."""
    flags = parse_flags(args)
    apply = "apply" in flags

    def usage(path: str) -> int:
        """Billable bytes under `path`: paginated (no silent truncation on
        giant directories) and excluding dot-dirs like the .uploads
        multipart staging area (its parts are not object data)."""
        import urllib.parse as _u

        total = 0
        last = ""
        while True:
            qs = "limit=10000" + (
                f"&lastFileName={_u.quote(last)}" if last else "")
            status, _, body = env.filer_read(path, qs)
            if status == 404:
                return total  # directory vanished mid-walk
            if status != 200:
                # a truncated sum could flip an over-quota bucket back to
                # writable — fail the bucket's check instead
                raise ShellError(f"listing {path} -> {status}")
            entries = json.loads(body).get("Entries") or []
            for e in entries:
                name = e["FullPath"].rsplit("/", 1)[-1]
                if e["IsDirectory"]:
                    if not name.startswith("."):
                        total += usage(e["FullPath"])
                else:
                    total += int(e.get("FileSize") or 0)
            if len(entries) < 10000:
                return total
            last = entries[-1]["FullPath"].rsplit("/", 1)[-1]

    status, _, body = env.filer_read(BUCKETS_DIR, "limit=10000")
    if status == 404:
        return "(no buckets)"
    lines = []
    for e in json.loads(body).get("Entries") or []:
        if not e["IsDirectory"] or e["FullPath"].rsplit(
                "/", 1)[-1].startswith("."):
            continue
        path = e["FullPath"]
        name = path.rsplit("/", 1)[-1]
        st, _, meta = env.filer_read(path, "metadata=true")
        entry = json.loads(meta)
        ext = entry.get("extended") or {}
        quota = int(ext.get("quota.bytes") or 0)
        if quota <= 0:
            continue
        try:
            used = usage(path)
        except ShellError as e:
            lines.append(f"{name}: usage check failed ({e}); skipped")
            continue
        over = used > quota
        readonly = bool(ext.get("s3-read-only"))
        action = ""
        if apply and over and not readonly:
            entry.setdefault("extended", {})["s3-read-only"] = "quota"
            action = " -> marked READ-ONLY"
        elif apply and not over and readonly and ext.get(
                "s3-read-only") == "quota":
            entry["extended"].pop("s3-read-only", None)
            action = " -> writable again"
        if action:
            http_request(
                "PUT", f"{_filer(env)}{path}?meta.entry=true",
                body=json.dumps(entry).encode(),
                headers={"Content-Type": "application/json"}, timeout=60)
        lines.append(
            f"{name}: used {used} / quota {quota}"
            f" ({'OVER' if over else 'ok'}){action}")
    return "\n".join(lines) or "(no buckets with quotas)"
