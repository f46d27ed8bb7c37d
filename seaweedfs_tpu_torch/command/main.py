"""`weed-tpu` command dispatch (reference: `weed/weed.go:50`, `weed/command/`).

Subcommands are registered lazily; each module under
seaweedfs_tpu_torch.command exposes `run(args) -> int` and `HELP`. The
port's copy of `seaweedfs_tpu/command/main.py`: the same verbs, each
pointed at the port's module, and `SEAWEEDFS_SENTRY_DSN` initialising the
port's `util/sentry.py`. Run it as
`python -m seaweedfs_tpu_torch.command.main <verb> [flags]` (or the
`weed-tpu-torch` script); the server verbs run on the CUDA card unless
`-device cpu` is given (`server_cmds.py`).
"""

from __future__ import annotations

import importlib
import os
import sys

COMMANDS: dict[str, tuple[str, str, str]] = {
    # name -> (module, function, one-line help)
    "version": ("seaweedfs_tpu_torch.command.version", "run", "print version"),
    "master": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_master",
        "start the cluster master (assign/lookup/heartbeats)",
    ),
    "volume": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_volume",
        "start a volume server (blob storage data plane)",
    ),
    "filer": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_filer",
        "start a filer (file namespace over the blob store)",
    ),
    "server": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_server",
        "start master + volume server (+ -filer, -s3) in one process",
    ),
    "s3": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_s3",
        "start the S3 gateway against a filer",
    ),
    "ftp": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_ftp",
        "start the FTP gateway against a filer",
    ),
    "iam": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_iam",
        "start the IAM management API against a filer",
    ),
    "shell": (
        "seaweedfs_tpu_torch.shell.shell", "run",
        "interactive admin shell (ec.*, volume.*, fs.*)",
    ),
    "benchmark": (
        "seaweedfs_tpu_torch.command.benchmark", "run",
        "write/read load generator with latency percentiles",
    ),
    "upload": ("seaweedfs_tpu_torch.command.upload", "run", "upload files via assign+PUT"),
    "download": ("seaweedfs_tpu_torch.command.upload", "run_download", "download a fid"),
    "backup": (
        "seaweedfs_tpu_torch.command.volume_tools", "run_backup",
        "incrementally back up a live volume to a local directory",
    ),
    "compact": (
        "seaweedfs_tpu_torch.command.volume_tools", "run_compact",
        "offline-vacuum a local volume",
    ),
    "export": (
        "seaweedfs_tpu_torch.command.volume_tools", "run_export",
        "list or extract a volume's needles (tar / directory)",
    ),
    "scaffold": (
        "seaweedfs_tpu_torch.command.scaffold", "run",
        "print starter TOML configs (security/filer/master/...)",
    ),
    "fix": (
        "seaweedfs_tpu_torch.command.fix", "run",
        "rebuild a volume .idx from its .dat",
    ),
    "mount": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_mount",
        "FUSE-mount a filer as a local filesystem",
    ),
    "mq.broker": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_mq_broker",
        "start a message-queue broker against a filer",
    ),
    "webdav": (
        "seaweedfs_tpu_torch.command.server_cmds", "run_webdav",
        "start the WebDAV gateway against a filer",
    ),
    "filer.sync": (
        "seaweedfs_tpu_torch.command.filer_sync", "run_filer_sync",
        "continuous bidirectional sync between two filers",
    ),
    "filer.replicate": (
        "seaweedfs_tpu_torch.command.filer_sync", "run_filer_replicate",
        "consume a notification spool and replicate to a sink",
    ),
    "filer.remote.sync": (
        "seaweedfs_tpu_torch.command.filer_sync", "run_filer_remote_sync",
        "write back changes under a remote-mounted directory",
    ),
    "filer.backup": (
        "seaweedfs_tpu_torch.command.filer_sync", "run_filer_backup",
        "mirror a filer tree into a local directory and follow changes",
    ),
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("weed-tpu: TPU-native distributed object store\n\ncommands:")
        for name, (_, _, help_line) in sorted(COMMANDS.items()):
            print(f"  {name:18s} {help_line}")
        return 0
    name, *rest = argv
    if name not in COMMANDS:
        print(f"unknown command {name!r}; see `weed-tpu help`", file=sys.stderr)
        return 2
    dsn = os.environ.get("SEAWEEDFS_SENTRY_DSN", "")
    if dsn:  # reference: sentry.Init at each command's startup
        from seaweedfs_tpu_torch.util.sentry import init_sentry

        init_sentry(dsn, environment=os.environ.get("SEAWEEDFS_ENV", ""))
    module, fn_name, _ = COMMANDS[name]
    mod = importlib.import_module(module)
    return int(getattr(mod, fn_name)(rest) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
