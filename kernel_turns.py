#!/usr/bin/env python3
"""Time two checkouts' CUDA kernels in turns on one GPU.

    python3 kernel_turns.py OTHER_ROOT [--turns old,new,new,old] [--seed N]

"new" is the port in this checkout; "old" is the port in OTHER_ROOT (for
example the parent commit, unpacked with `git archive` into the git-ignored
`cmp/`), loaded under another package name so that both live in one
process, on one card. Each turn times every kernel at its paths' shapes
with chip_smoke.py's `gf256_shape_times` and `hash_shape_times`: each
kernel is first checked against this checkout's plain version, then timed
by device time beside one call's event time, the plain version's time and
the bound. Prints one JSON line per turn, then
the card's name and power limit. Exits non-zero when CUDA is not available.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

import chip_smoke
from seaweedfs_tpu_torch.ops import _build

# kernel -> (module of the port, wrapper)
WRAPPER_OF = {
    "gf256_matmul": ("ops.rs_cuda", "gf256_matmul"),
    "crc32c_batch": ("ops.crc32c_kernel", "crc32c_batch_kernel"),
    "md5_batch": ("ops.md5_kernel", "md5_batch_kernel"),
    "gear_hash": ("ops.cdc", "gear_hash_kernel"),
}


def port_wrappers(package: str) -> dict:
    """The kernel wrappers of an imported port package."""
    return {k: getattr(importlib.import_module(f"{package}.{mod}"), fn)
            for k, (mod, fn) in WRAPPER_OF.items()}


def import_other(root: Path, alias: str = "other_seaweedfs_tpu_torch") -> str:
    """Imports the port in `root` as package `alias`; returns the alias."""
    init = root / "seaweedfs_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return alias


def turn(dev: torch.device, seed: int, wrappers: dict, md5_ops_per_block: int) -> dict:
    """Every kernel of `wrappers` at its paths' shapes."""
    rows = {"gf256_matmul": chip_smoke.gf256_shape_times(dev, seed, wrappers["gf256_matmul"])}
    rows.update(chip_smoke.hash_shape_times(dev, seed, wrappers, md5_ops_per_block))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    other = import_other(args.other.resolve())
    other_build = importlib.import_module(f"{other}.ops._build")
    _build.build()
    other_build.build()
    # the MD5 bound counts this checkout's instructions a block, for both
    md5_ops = chip_smoke.sass_loop_ops(_build.MD5_BATCH, "md5_batch_kernel")["ops"]
    wrappers = {"new": port_wrappers("seaweedfs_tpu_torch"), "old": port_wrappers(other)}
    for i, name in enumerate(args.turns.split(",")):
        print(json.dumps({"turn": i, "port": name,
                          "kernels": turn(dev, args.seed, wrappers[name], md5_ops)}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
