"""Time chip_smoke.py's dedup, online and cluster phases at two depths in turns ("new", "old",
"old", "new") in one process on one GPU: online 512 MiB, cluster 512 MiB and dedup 1 GiB
against 1024 MiB, 1024 MiB and 2 GiB, the span each depth cut of the script saves. Run from
the checkout's root on a machine with a CUDA GPU: `python3 depth_turns.py`; it prints one JSON
line a turn with each phase's seconds."""
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
print(json.dumps({"smi": cs.nvidia_smi()}), flush=True)
for tag, (on_mib, cl_mib, dd_gib) in (("new", (512, 512, 1)), ("old", (1024, 1024, 2)),
                                      ("old", (1024, 1024, 2)), ("new", (512, 512, 1))):
    row = {"depths": tag}
    for name, fn in (("dedup", lambda: cs.dedup_phase(dev, dd_gib * 1024 * cs.MIB // cs.DEDUP_SEGMENT, 0)),
                     ("online", lambda: cs.online_phase(dev, on_mib * cs.MIB, 0)),
                     ("cluster", lambda: cs.cluster_phase(dev, cl_mib * cs.MIB, 0))):
        t = time.perf_counter()
        fn()
        row[name + "_s"] = time.perf_counter() - t
    print(json.dumps(row), flush=True)
