"""Admin shell (reference: `weed/shell/` — interactive cluster commands
driven over master/volume RPC; here over their HTTP admin APIs).

The port's copy of `seaweedfs_tpu/shell/` with the commands of
`commands_cluster` (`lock`, `unlock`, `cluster.ps`, `collection.list`,
`collection.delete`, `volume.list`, `volume.status`, `cluster.scrub`,
`cluster.faults`, `mount.configure`, and the `mq.*` verbs), `commands_ec` (`ec.encode`,
`ec.decode`, `ec.rebuild`, `ec.balance`), `commands_fs` (every `fs.*` verb,
over a filer), `commands_maintenance` (`cluster.maintenance`),
`commands_remote` (every `remote.*` verb, over a filer), `commands_s3`
(every `s3.*` verb, over a filer) and `commands_volume` (every `volume.*`
verb). Not ported: the rest of `commands_cluster.py`.

Usage:
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    env = CommandEnv(master_url)  # or CommandEnv(master_url, filer_url)
    print(run_command(env, "lock"))
    print(run_command(env, "ec.encode -collection photos"))
"""

from .env import CommandEnv, ShellError
from .registry import COMMANDS, run_command

# command modules register themselves on import
from . import commands_cluster  # noqa: E402,F401
from . import commands_ec  # noqa: E402,F401
from . import commands_fs  # noqa: E402,F401
from . import commands_maintenance  # noqa: E402,F401
from . import commands_remote  # noqa: E402,F401
from . import commands_s3  # noqa: E402,F401
from . import commands_volume  # noqa: E402,F401

__all__ = ["CommandEnv", "ShellError", "COMMANDS", "run_command"]
