"""lock/unlock (reference `weed/shell/command_lock_unlock.go`).

The port's copy of `lock` and `unlock` from
`seaweedfs_tpu/shell/commands_cluster.py`; the file's other commands
(`cluster.*`, `collection.*`) are not ported."""

from __future__ import annotations

from .env import CommandEnv
from .registry import command


@command("lock", "acquire the exclusive admin lock on the master")
def cmd_lock(env: CommandEnv, args: list[str]) -> str:
    env.acquire_lock()
    return "lock acquired"


@command("unlock", "release the admin lock")
def cmd_unlock(env: CommandEnv, args: list[str]) -> str:
    env.release_lock()
    return "lock released"
