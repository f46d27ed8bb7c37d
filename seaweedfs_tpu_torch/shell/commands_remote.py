"""remote.* commands (reference `weed/shell/command_remote_configure.go`,
`command_remote_mount.go`, `command_remote_cache.go`, `_uncache.go`,
`_meta_sync.go`, `_unmount.go`).

The port's copy of `seaweedfs_tpu/shell/commands_remote.py`, over the
port filer's `/__remote__/*` routes."""

from __future__ import annotations

import json

from .env import CommandEnv, ShellError
from .registry import command, parse_flags


def _filer_post(env: CommandEnv, path: str, payload: dict) -> dict:
    return env.post(f"{env.require_filer()}{path}", payload)


@command("remote.configure",
         "-name <conf> -kind local|s3 [-root dir] [-bucket b] [-prefix p] — "
         "register a remote storage config on the filer")
def cmd_remote_configure(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    if "name" not in flags:
        # list mode
        out = env.get(f"{env.require_filer()}/__remote__/mounts")
        return json.dumps(out, indent=2)
    conf = {"kind": flags.get("kind", "local")}
    for k in ("root", "bucket", "prefix", "region", "endpoint"):
        if k in flags:
            conf[k] = flags[k]
    out = _filer_post(env, "/__remote__/configure",
                      {"name": flags["name"], "conf": conf})
    return f"remote config {flags['name']!r} saved (configs: {out['configs']})"


@command("remote.mount",
         "-dir </path> -config <name> [-path remote/subdir] — mount a remote "
         "store as a read-through cached directory")
def cmd_remote_mount(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    out = _filer_post(env, "/__remote__/mount", {
        "dir": flags["dir"], "config": flags["config"],
        "path": flags.get("path", ""),
    })
    return f"mounted {flags['dir']} ({out['synced']} entries synced)"


@command("remote.unmount", "-dir </path>")
def cmd_remote_unmount(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    _filer_post(env, "/__remote__/unmount", {"dir": flags["dir"]})
    return f"unmounted {flags['dir']}"


@command("remote.meta.sync", "-dir </path> — re-sync metadata from the remote")
def cmd_remote_meta_sync(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    out = _filer_post(env, "/__remote__/meta_sync", {"dir": flags["dir"]})
    return f"synced {out['synced']} entries under {flags['dir']}"


@command("remote.cache", "-dir </path> — prefetch remote content into the "
         "local cluster")
def cmd_remote_cache(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    out = _filer_post(env, "/__remote__/cache", {"dir": flags["dir"]})
    return f"cached {out['cached']} objects under {flags['dir']}"


@command("remote.uncache", "-dir </path> — drop locally cached chunks, keep "
         "remote metadata")
def cmd_remote_uncache(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    out = _filer_post(env, "/__remote__/uncache", {"dir": flags["dir"]})
    return f"uncached {out['uncached']} objects under {flags['dir']}"


@command("remote.mount.buckets",
         "-remote <config> — mount every bucket of a configured remote"
         " under /buckets/<name> and pull its metadata")
def cmd_remote_mount_buckets(env: CommandEnv, args: list[str]) -> str:
    flags = parse_flags(args)
    conf = flags.get("remote") or flags.get("config")
    if not conf:
        raise ShellError("usage: remote.mount.buckets -remote <config>")
    try:
        out = _filer_post(env, "/__remote__/mount_buckets", {"config": conf})
    except IOError as e:
        raise ShellError(str(e))
    names = out.get("mounted") or []
    return f"mounted {len(names)} buckets: " + ", ".join(names)
