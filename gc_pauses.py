#!/usr/bin/env python3
"""The cyclic collector's pauses in each phase of a tree's chip_smoke.py.

    python3 gc_pauses.py TREE [chip_smoke.py's arguments]

TREE is the root of a checkout of this repository (`.` for this one; unpack the parent commit
with `git archive` into the git-ignored `cmp/parent`). Runs that tree's chip_smoke.py in this
process with the collector's pauses recorded, and after each phase's JSON line prints one more,
`{"gc_of": phase, "collections": [gen 0, gen 1, gen 2], "full_max_ms": ..., "full_total_ms": ...,
"objects": ...}`: the pauses since the previous phase's line, counted as chip_smoke.py's own `gc`
field counts them, so a tree whose script has no such field compares with one that has. Exits
with chip_smoke.py's code.
"""

from __future__ import annotations

import gc
import json
import os
import runpy
import sys
import time


class PhaseLines:
    """Passes stdout through and, after each line that starts a phase's JSON
    object, writes the collector's pauses since the previous one."""

    def __init__(self, out) -> None:
        self.out = out
        self.buf = ""
        self.pauses: list = []
        self.start = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.start = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self.start))

    def take(self) -> dict:
        pauses, self.pauses = self.pauses, []
        full = [d for g, d in pauses if g == 2]
        return dict(collections=[sum(1 for g, _ in pauses if g == k) for k in range(3)],
                    full_max_ms=max(full, default=0.0) * 1e3,
                    full_total_ms=sum(full) * 1e3, objects=len(gc.get_objects()))

    def write(self, s: str) -> int:
        self.out.write(s)
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            if line.startswith('{"phase"'):
                phase = json.loads(line)["phase"]
                self.out.write(json.dumps({"gc_of": phase, **self.take()}) + "\n")
        return len(s)

    def flush(self) -> None:
        self.out.flush()

    def __getattr__(self, name: str):
        return getattr(self.out, name)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    script = os.path.join(tree, "chip_smoke.py")
    here = os.path.dirname(os.path.abspath(__file__))
    # the tree's own package, not this checkout's
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    os.chdir(tree)
    sys.argv = [script] + sys.argv[2:]
    sys.stdout = PhaseLines(sys.stdout)
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
