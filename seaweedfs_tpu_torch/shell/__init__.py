"""Admin shell (reference: `weed/shell/` — interactive cluster commands
driven over master/volume RPC; here over their HTTP admin APIs).

The port's copy of `seaweedfs_tpu/shell/` with the commands of
`commands_cluster` (`lock`, `unlock`) and `commands_ec` (`ec.encode`,
`ec.decode`, `ec.rebuild`, `ec.balance`). Not ported: the other command
files (`commands_{volume,fs,maintenance,remote,s3}.py`) and the rest of
`commands_cluster.py`.

Usage:
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    env = CommandEnv(master_url)
    print(run_command(env, "lock"))
    print(run_command(env, "ec.encode -collection photos"))
"""

from .env import CommandEnv, ShellError
from .registry import COMMANDS, run_command

# command modules register themselves on import
from . import commands_cluster  # noqa: E402,F401
from . import commands_ec  # noqa: E402,F401

__all__ = ["CommandEnv", "ShellError", "COMMANDS", "run_command"]
