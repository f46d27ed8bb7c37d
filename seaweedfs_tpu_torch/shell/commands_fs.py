"""fs.* commands against the filer (reference `weed/shell/command_fs_ls.go`,
`command_fs_du.go`, `command_fs_cat.go`, `command_fs_rm.go`,
`command_fs_meta_save.go` / `_load.go`, `command_fs_verify.go`).

The port's copy of `seaweedfs_tpu/shell/commands_fs.py`, every verb, over
the port's filer (`server/filer.py`) through `CommandEnv`'s filer handle.
"""

from __future__ import annotations

import datetime
import json

from ..filer.filer_conf import FILER_CONF_PATH, FilerConf
from ..server.httpd import http_request, post_json
from ..storage.types import TTL
from .env import CommandEnv, ShellError
from .registry import command, parse_flags


def _list_dir(env: CommandEnv, path: str) -> list[dict]:
    status, _, body = env.filer_read(path if path.startswith("/") else "/" + path)
    if status == 404:
        raise ShellError(f"{path}: no such file or directory")
    out = json.loads(body)
    return out.get("Entries") or []


def _walk(env: CommandEnv, path: str):
    """Depth-first over the filer namespace."""
    for e in _list_dir(env, path):
        yield e
        if e["IsDirectory"]:
            yield from _walk(env, e["FullPath"])


@command("fs.ls", "[-l] <dir> — list a filer directory")
def cmd_fs_ls(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = flags.get("", "/")
    entries = _list_dir(env, path)
    if "l" in flags:
        return "\n".join(
            f"{'d' if e['IsDirectory'] else '-'} {e['FileSize']:>12} "
            f"{e['FullPath']}"
            for e in entries
        )
    return "\n".join(e["FullPath"].rsplit("/", 1)[-1] for e in entries)


@command("fs.du", "<dir> — directory byte/file counts")
def cmd_fs_du(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = flags.get("", "/")
    total_bytes = files = dirs = 0
    for e in _walk(env, path):
        if e["IsDirectory"]:
            dirs += 1
        else:
            files += 1
            total_bytes += e["FileSize"]
    return f"{total_bytes} bytes, {files} files, {dirs} directories under {path}"


@command("fs.tree", "<dir> — recursive listing")
def cmd_fs_tree(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    root = flags.get("", "/")
    lines = []
    depth0 = root.rstrip("/").count("/")
    for e in _walk(env, root):
        depth = e["FullPath"].count("/") - depth0 - 1
        name = e["FullPath"].rsplit("/", 1)[-1]
        lines.append("  " * depth + name + ("/" if e["IsDirectory"] else ""))
    return "\n".join(lines)


@command("fs.cat", "<file> — print file content")
def cmd_fs_cat(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = flags.get("")
    if not path:
        raise ShellError("usage: fs.cat <file>")
    status, _, body = env.filer_read(path)
    if status != 200:
        raise ShellError(f"{path}: {status}")
    return body.decode("utf-8", "replace")


@command("fs.rm", "[-r] <path> — delete a file or directory tree")
def cmd_fs_rm(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = flags.get("")
    if not path:
        raise ShellError("usage: fs.rm [-r] <path>")
    url = f"{env.require_filer()}{path}"
    if "r" in flags:
        url += "?recursive=true"
    status, _, body = http_request("DELETE", url, timeout=60)
    if status >= 400:
        raise ShellError(f"rm {path}: {status} {body[:100]!r}")
    return f"removed {path}"


@command("fs.mkdir", "<dir> — create a directory")
def cmd_fs_mkdir(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    path = flags.get("")
    status, _, _ = http_request(
        "POST", f"{env.require_filer()}{path}?mkdir=true", b"", timeout=60)
    if status >= 400:
        raise ShellError(f"mkdir {path}: {status}")
    return f"created {path}"


@command("fs.mv", "<src> <dst> — move/rename within the filer")
def cmd_fs_mv(env: CommandEnv, args: list[str]) -> str:
    positional = [a for a in args if not a.startswith("-")]
    if len(positional) != 2:
        raise ShellError("usage: fs.mv <src> <dst>")
    src, dst = positional
    status, _, body = http_request(
        "POST", f"{env.require_filer()}{dst}?mv.from={src}", b"", timeout=60)
    if status >= 400:
        raise ShellError(f"mv: {status} {body[:200]!r}")
    return f"moved {src} -> {dst}"


@command("fs.meta.save", "-o <file.json> [dir] — dump filer metadata "
         "(ref command_fs_meta_save.go; JSON-lines instead of protobuf)")
def cmd_fs_meta_save(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    root = flags.get("", "/")
    out_path = flags.get("o", "filer_meta.jsonl")
    count = 0
    with open(out_path, "w") as f:
        for e in _walk(env, root):
            status, _, body = env.filer_read(e["FullPath"], "metadata=true")
            if status != 200:
                continue
            f.write(json.dumps(json.loads(body)) + "\n")
            count += 1
    return f"saved {count} entries to {out_path}"


@command("fs.meta.load", "<file.json> — restore filer metadata entries")
def cmd_fs_meta_load(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    in_path = flags.get("")
    if not in_path:
        raise ShellError("usage: fs.meta.load <file.jsonl>")
    count = 0
    with open(in_path) as f:
        for line in f:
            if not line.strip():
                continue
            entry = json.loads(line)
            path = entry["full_path"]
            if entry.get("is_directory"):
                http_request("POST", f"{env.require_filer()}{path}?mkdir=true", b"", timeout=60)
            else:
                # restore the metadata record (chunks point at existing blobs)
                http_request(
                    "POST",
                    f"{env.require_filer()}{path}?meta.entry=true",
                    json.dumps(entry).encode(),
                    {"Content-Type": "application/json"}, timeout=60)
            count += 1
    return f"loaded {count} entries"


@command("fs.verify", "[dir] — check every chunk of every file is readable "
         "(ref command_fs_verify.go)")
def cmd_fs_verify(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    root = flags.get("", "/")
    ok = bad = 0
    lines = []
    for e in _walk(env, root):
        if e["IsDirectory"]:
            continue
        status, _, _ = env.filer_read(e["FullPath"])
        if status == 200:
            ok += 1
        else:
            bad += 1
            lines.append(f"UNREADABLE {e['FullPath']} ({status})")
    lines.append(f"verified {ok + bad} files: {ok} ok, {bad} broken")
    return "\n".join(lines)


@command("fs.cd", "<dir> — change the shell's working directory")
def cmd_fs_cd(env: CommandEnv, args: list[str]) -> str:
    target = args[0] if args else "/"
    if not target.startswith("/"):
        target = env.cwd.rstrip("/") + "/" + target
    target = target.rstrip("/") or "/"
    status, _, body = env.filer_read(target, "metadata=true")
    if status != 200:
        raise ShellError(f"{target}: not found")
    if not json.loads(body).get("is_directory"):
        raise ShellError(f"{target}: not a directory")
    env.cwd = target
    return target


@command("fs.pwd", "print the shell's working directory")
def cmd_fs_pwd(env: CommandEnv, args: list[str]) -> str:
    return env.cwd


@command("fs.meta.cat", "<path> — print one entry's raw metadata json")
def cmd_fs_meta_cat(env: CommandEnv, args: list[str]) -> str:
    if not args:
        raise ShellError("usage: fs.meta.cat <path>")
    path = args[0]
    if not path.startswith("/"):
        path = env.cwd.rstrip("/") + "/" + path
    status, _, body = env.filer_read(path, "metadata=true")
    if status != 200:
        raise ShellError(f"{path}: not found")
    return json.dumps(json.loads(body), indent=2)

@command("fs.dedup.gc", "garbage-collect unreferenced dedup'd chunk blobs")
def cmd_fs_dedup_gc(env: CommandEnv, args: list[str]) -> str:
    """Triggers the filer's dedup GC (`filer/dedup.py` semantics): walk the
    namespace, delete every indexed blob no entry references, drop its index
    entry. New capability vs the reference (it has no CDC dedup)."""
    status, _, body = http_request("POST", f"{env.require_filer()}/__dedup__/gc", b"", timeout=60)
    out = json.loads(body)
    if status >= 400:
        raise ShellError(out.get("error", f"gc failed: {status}"))
    return (
        f"scanned {out['scanned']} index entries, dropped {out['dropped']} "
        f"({out['bytes_freed']} bytes freed, {out['errors']} errors)"
    )


@command("fs.meta.notify",
         "[dir] — resend directory+file metadata to the notification queue"
         " (bootstrap a downstream replicator)")
def cmd_fs_meta_notify(env: CommandEnv, args: list[str]) -> str:
    directory = args[0] if args else env.cwd
    out = post_json(f"{env.require_filer()}/__meta__/notify",
                    {"directory": directory})
    return f"sent {out['sent']} entries under {directory}"


@command("fs.meta.changeVolumeId",
         "-dir <dir> -fromVolumeId <x> -toVolumeId <y> — rewrite volume ids"
         " inside chunk fids (after volume relocation)")
def cmd_fs_meta_change_volume_id(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    directory = flags.get("dir", env.cwd)
    try:
        mapping = {flags["fromVolumeId"]: flags["toVolumeId"]}
    except KeyError:
        raise ShellError(
            "usage: fs.meta.changeVolumeId -dir <dir>"
            " -fromVolumeId <x> -toVolumeId <y>")
    out = post_json(f"{env.require_filer()}/__meta__/change_volume_id",
                    {"directory": directory, "mapping": mapping})
    return f"rewrote {out['changed']} entries under {directory}"


@command("fs.configure",
         "[-locationPrefix /p [-collection c] [-replication xyz] [-ttl 7d]"
         " [-readOnly] [-delete] [-apply]] — per-path storage rules"
         " (/etc/seaweedfs/filer.conf); no flags shows the current rules")
def cmd_fs_configure(env: CommandEnv, args: list[str]) -> str:
    """`command_fs_configure.go`: view/edit the filer's per-location
    storage rules. Without -apply the resulting document is printed but
    NOT saved (the reference's try-before-apply semantics); with -apply
    it is written to /etc/seaweedfs/filer.conf, which every filer
    hot-reloads via its metadata subscription."""
    flags = parse_flags(args)
    filer = env.require_filer()
    status, _, body = http_request("GET", filer + FILER_CONF_PATH, timeout=60)
    conf = FilerConf.from_bytes(body if status == 200 else b"")
    prefix = flags.get("locationPrefix")
    if prefix is None:
        return conf.to_bytes().decode()
    if "delete" in flags:
        conf.delete(prefix)
    else:
        rule = {"location_prefix": prefix}
        if "collection" in flags:
            rule["collection"] = flags["collection"]
        if "replication" in flags:
            rule["replication"] = flags["replication"]
        if "ttl" in flags:
            try:  # validate at SAVE time: a bad persisted rule would
                TTL.parse(flags["ttl"])  # break every write under the prefix
            except (ValueError, KeyError):
                raise ShellError(f"invalid -ttl {flags['ttl']!r}"
                                 " (e.g. 5m, 3h, 7d)")
            rule["ttl"] = flags["ttl"]
        if "readOnly" in flags:
            rule["read_only"] = True
        conf.upsert(rule)
    doc = conf.to_bytes()
    if "apply" not in flags:
        return doc.decode() + "\n(not saved; add -apply)"
    st, _, resp = http_request(
        "PUT", filer + FILER_CONF_PATH, doc,
        {"Content-Type": "application/json"}, timeout=60)
    if st >= 300:
        raise ShellError(f"save failed: {st} {resp[:120]!r}")
    return doc.decode() + "\n(saved)"


@command("fs.log.purge",
         "[-modifyDayAgo 365] — delete filer meta-log segments older than"
         " N days")
def cmd_fs_log_purge(env: CommandEnv, args: list[str]) -> str:
    """`command_fs_log.go` fs.log.purge: the metadata event log persists
    as dated segment files under /topics/.system/log/<yyyy-mm-dd>/...;
    drop whole day-directories past the retention window. Day names come
    from UTC (filer_notify segment_path uses gmtime), so the cutoff is
    computed in UTC too."""
    flags = parse_flags(args)
    days = int(flags.get("modifyDayAgo", 365))
    cutoff = (datetime.datetime.now(datetime.timezone.utc).date()
              - datetime.timedelta(days=days)).isoformat()
    filer = env.require_filer()
    status, _, body = env.filer_read("/topics/.system/log", "limit=100000")
    if status != 200:
        return "(no meta-log segments)"
    purged, failed = [], []
    for e in json.loads(body).get("Entries") or []:
        day = e["FullPath"].rsplit("/", 1)[-1]
        if e["IsDirectory"] and day < cutoff:
            st, _, _ = http_request(
                "DELETE", f"{filer}{e['FullPath']}?recursive=true", timeout=60)
            (purged if st < 300 else failed).append(day)
    out = f"purged {len(purged)} day(s)" + (
        ": " + ", ".join(sorted(purged)) if purged else "")
    if failed:
        out += f"\nFAILED to purge {len(failed)}: " + ", ".join(
            sorted(failed))
    return out


@command("fs.merge.volumes",
         "-fromVolumeId <x> -toVolumeId <y> [-dir /] [-apply] — move chunks"
         " between volumes and rewrite metadata (consolidate small volumes)")
def cmd_fs_merge_volumes(env: CommandEnv, args: list[str]) -> str:
    """`command_fs_merge_volumes.go`: re-home every chunk of volume X into
    volume Y (needle key/cookie preserved), dry-run unless -apply."""
    flags = parse_flags(args)
    try:
        payload = {
            "directory": flags.get("dir", "/"),
            "from_vid": flags["fromVolumeId"],
            "to_vid": flags["toVolumeId"],
            "apply": "apply" in flags,
        }
    except KeyError:
        raise ShellError("usage: fs.merge.volumes -fromVolumeId <x>"
                         " -toVolumeId <y> [-dir /] [-apply]")
    try:
        out = post_json(f"{env.require_filer()}/__meta__/merge_volumes",
                        payload)
    except IOError as e:
        raise ShellError(str(e))
    msg = (f"{out['planned']} chunk(s) in volume {payload['from_vid']}"
           f" under {payload['directory']}")
    if out["applied"]:
        msg += f"; moved {out['moved']} to volume {payload['to_vid']}"
        if out["skipped"]:
            msg += f"; SKIPPED (key collision): {', '.join(out['skipped'])}"
    else:
        msg += " (dry run; add -apply)"
    return msg
