"""Time chip_smoke.py's phases at two depths in turns ("new", "old", "old", "new") in one
process on one GPU: the spans the depth cuts of the script save to make room for its fastlane
phase. filer_dedup: 5 uploads of 64 MiB against 6 (a cut timed and not taken: its saving lies
within the spread of two turns at one depth); sync_mq: 2,048 messages against 4,096;
gateways: 128 WebDAV files and 128 MiB of remote objects against 256 and 256 MiB; cdc: 16
uploads of 64 MiB against 32; and the fastlane phase's own cut: 32,768 engine files (8,192
per-file assigns, 4,096 through the Python path) against 131,072 (32,768, 16,384). Run from
the checkout's root on a machine with a CUDA GPU: `python3 depth_turns.py [PHASE ...]` (every
phase when none is named); it prints one JSON line a turn with each phase's seconds, and the
fastlane phase's req/s by run."""
import json
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from seaweedfs_tpu_torch.ops import _build  # noqa: E402

_build.build()
for src in _build.SOURCES:
    _build.load(src)
dev = torch.device("cuda", 0)
md5_ops = cs.sass_loop_ops(_build.MD5_BATCH, "md5_batch_kernel")["ops"]
# phase -> ({"new": depth, "old": depth}, run(depth))
PHASES = {
    "filer_dedup": ({"new": 5, "old": 6}, lambda n: cs.filer_dedup_phase(dev, n, 0)),
    "sync_mq": ({"new": 2048, "old": 4096},
                lambda n: cs.sync_mq_phase(dev, 128, n, md5_ops, 0)),
    "gateways": ({"new": 128, "old": 256},
                 lambda n: cs.gateways_phase(dev, n, 256, 256 * cs.MIB, 512 * cs.MIB, 256,
                                             n * cs.MIB, md5_ops, 0)),
    "cdc": ({"new": 16, "old": 32}, lambda n: cs.cdc_phase(dev, n, 1024 * cs.MIB, 0)),
    "fastlane": ({"new": 1 << 15, "old": 1 << 17},
                 lambda n: cs.fastlane_phase(dev, n, n // 4, n // 8, 128 * cs.MIB, 1 << 13,
                                             64 * cs.MIB, 0)),
}
names = sys.argv[1:] or list(PHASES)
print(json.dumps({"smi": cs.nvidia_smi()}), flush=True)
for tag in ("new", "old", "old", "new"):
    row = {"depths": tag}
    for name in names:
        depths, run = PHASES[name]
        row[name] = depths[tag]
        t = time.perf_counter()
        res = run(depths[tag])
        row[name + "_s"] = time.perf_counter() - t
        if name == "fastlane":
            row["fastlane_req_per_s"] = {
                k: res[k]["req_per_sec"] for k in ("engine_write", "engine_read", "assign_write",
                                                   "python_write", "python_read")}
    print(json.dumps(row), flush=True)
