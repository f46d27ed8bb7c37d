"""Command registry + line runner (reference `weed/shell/commands.go`).

The port's copy of `seaweedfs_tpu/shell/registry.py`, whole."""

from __future__ import annotations

import shlex
from typing import Callable

from .env import CommandEnv, ShellError

COMMANDS: dict[str, tuple[Callable, str]] = {}

# commands that mutate cluster layout demand the exclusive admin lock,
# like the reference's `lock`-guarded commands
LOCK_REQUIRED: set[str] = set()


def command(name: str, help_text: str = "", needs_lock: bool = False):
    def deco(fn):
        COMMANDS[name] = (fn, help_text)
        if needs_lock:
            LOCK_REQUIRED.add(name)
        return fn

    return deco


def parse_flags(argv: list[str]) -> dict[str, str]:
    """-volumeId 3 -collection x -force -> {volumeId: "3", collection: "x",
    force: "true"} (the reference uses Go flag sets per command)."""
    out: dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-"):
            key = arg.lstrip("-")
            if "=" in key:
                key, _, val = key.partition("=")
                out[key] = val
            elif i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                out[key] = argv[i + 1]
                i += 1
            else:
                out[key] = "true"
        else:
            out.setdefault("", arg)  # positional
        i += 1
    return out


def dry_run_flag(flags: dict) -> bool:
    """The uniform -dryRun/-apply convention every repair verb shares
    (volume.fix.replication / ec.rebuild / volume.balance / volume.vacuum,
    and through them the maintenance executors): -dryRun renders the plan
    without mutating anything, -apply (the default) executes it."""
    dry = "dryRun" in flags
    if dry and "apply" in flags:
        raise ShellError("pass only one of -dryRun / -apply")
    return dry


def render_plan(verb: str, actions: list[str]) -> str:
    """Uniform dry-run output: what -apply would do, one action per line."""
    if not actions:
        return f"{verb} (dry run): nothing to do"
    head = f"{verb} (dry run): {len(actions)} action(s) planned:"
    return "\n".join([head] + ["  " + a for a in actions])


def run_command(env: CommandEnv, line: str) -> str:
    argv = shlex.split(line)
    if not argv:
        return ""
    name, args = argv[0], argv[1:]
    if name == "help":
        if args and args[0] in COMMANDS:
            return f"{args[0]}: {COMMANDS[args[0]][1]}"
        return "\n".join(sorted(COMMANDS))
    entry = COMMANDS.get(name)
    if entry is None:
        raise ShellError(f"unknown command {name!r} (try: help)")
    fn, _ = entry
    if name in LOCK_REQUIRED and not env.locked:
        raise ShellError(f"{name} requires the admin lock — run `lock` first")
    return fn(env, args)
