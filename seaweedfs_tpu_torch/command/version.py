"""`weed-tpu version` (`weed/command/version.go`): the port's copy of
`seaweedfs_tpu/command/version.py`, read from the port's own `__version__`."""

from __future__ import annotations

import seaweedfs_tpu_torch

HELP = "print version"


def run(args: list[str]) -> int:
    print(f"seaweedfs-tpu {seaweedfs_tpu_torch.__version__}")
    return 0
