#!/usr/bin/env python3
"""What metering costs the filer: chip_smoke.py's `filer` phase from several trees, one after
another on one card.

    python3 metering_cost.py TREE [TREE ...] [--files N] [--large-mib MIB] [--seed N]

Each TREE is the root of a checkout of this repository (`.` for this one; unpack the parent
commit with `git archive` into the git-ignored `cmp/parent`). Each runs in a subprocess of its
own: it builds that tree's kernels, reads its `md5_batch_kernel`'s SASS as chip_smoke.py does,
and runs that tree's `filer_phase` on cuda (a master, two volume servers and a filer; 4 KiB files
from 16 waiting threads, then 4 uploads of `--large-mib`). Give the trees in an order that cancels
drift, e.g. `cmp/parent . . cmp/parent`. Prints one JSON line a run (files/s, PUT p50/p99, large
GB/s, the phase's wall), the card's name and power limit, and a last line with the parent-first
mean of each tree's runs. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CHILD = r"""
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
os.makedirs(os.path.join(tree, "build"), exist_ok=True)  # chip_smoke's scratch
import torch
import chip_smoke as cs
from seaweedfs_tpu_torch.ops import _build
t0 = time.perf_counter()
_build.build()
for src in _build.SOURCES:
    _build.load(src)
md5_ops = cs.sass_loop_ops(_build.MD5_BATCH, "md5_batch_kernel")["ops"]
build_s = time.perf_counter() - t0
fl = cs.filer_phase(torch.device("cuda", 0), int(sys.argv[2]), int(sys.argv[3]) * cs.MIB,
                    md5_ops, int(sys.argv[4]))
keys = ("files_per_s", "put_p50_ms", "put_p99_ms", "large_gbps", "get_p50_ms", "get_p99_ms",
        "hash_batches", "wall_s")
print("RESULT " + json.dumps({"tree": sys.argv[1], "build_s": build_s,
                              **{k: fl[k] for k in keys}}), flush=True)
"""

KEYS = ("files_per_s", "put_p50_ms", "put_p99_ms", "large_gbps", "wall_s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--files", type=int, default=2048)
    ap.add_argument("--large-mib", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("metering_cost: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    runs = []
    for tree in args.trees:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CHILD, tree, str(args.files),
                              str(args.large_mib), str(args.seed)],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"metering_cost: {tree} exited {out.returncode}", file=sys.stderr)
            return 1
        run = json.loads(lines[-1][len("RESULT "):])
        run["process_s"] = time.perf_counter() - t0
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for tree in dict.fromkeys(args.trees):
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {k: sum(r[k] for r in mine) / len(mine) for k in KEYS}
        summary[tree]["runs"] = len(mine)
    print(json.dumps({"nvidia_smi": smi, "mean": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
