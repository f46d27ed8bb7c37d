"""Named fault points: inject errors and latency at the port's seams.

The port's copy of the part of `seaweedfs_tpu/util/faults.py` that the
pipelined rebuild plane's seam, the filer's chunk relay and the volume
server's replica fan-out need:
`FaultInjected`, `FaultSpec`, `FaultPoint.draw` / `hit`, `act` for the
`error` and `latency` modes, `register`, `point`, `arm`, `disarm` and
`disarm_all`. Tests arm a point to kill one hop of a rebuild chain
mid-run, to fail a filer's chunk read, or to fail a replica push.

`ALL_POINTS` is the closed set of seam names the port registers;
`register()` rejects anything else, so a typo'd seam cannot silently never
fire. In-process test clusters share one registry, so a spec may carry
`key=` to scope a fault to one server's seam invocations (the seam passes
its identity).

    _FP = faults.register("repair.partial_fetch")  # module import time
    ...
    _FP.hit(key=me)   # raise/sleep per the armed spec, or no-op

Disarmed, a seam check is one attribute load and a None test.

Not ported: the torn, corrupt, partition and disk_full modes, the
injection metric, the events journal, `arm_from_spec` and the HTTP arming
gate.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

ALL_POINTS = (
    "repair.partial_fetch",   # pipelined-rebuild partial-sum hop (/admin/ec/
                              # partial*): error = a chain hop dies mid-rebuild
    "filer.chunk.read",       # filer -> volume chunk relay (WeedClient.fetch)
    "volume.replicate.fanout",  # a replicated write's push to the other
                                # holders: error = the write is not acked
)

MODES = ("error", "latency")


class FaultInjected(IOError):
    """An `error`-mode fault fired. Derives from IOError so seams that
    already treat IO failures as recoverable treat injections the same
    way."""


@dataclass
class FaultSpec:
    """One armed fault. `count` < 0 means unlimited; a positive count
    decrements per firing and auto-disarms at zero. `rate` in (0, 1]
    fires probabilistically. `key` scopes the fault to seam invocations
    passing the same discriminator (in-process multi-server tests)."""

    mode: str
    rate: float = 1.0
    ms: float = 0.0       # latency mode: injected delay
    count: int = -1       # firings remaining; <0 = unlimited
    key: str = ""         # scope discriminator ("" = every invocation)
    after: int = 0        # skip the first N would-fire draws (onset
                          # delay: "die on the 4th chunk, not the 1st")


class FaultPoint:
    """One named seam. `spec` is None when disarmed."""

    __slots__ = ("name", "spec", "fired")

    def __init__(self, name: str) -> None:
        self.name = name
        self.spec: FaultSpec | None = None
        self.fired = 0

    def draw(self, key: str | None = None) -> FaultSpec | None:
        """Decide whether the armed fault fires for this invocation and
        count it; returns the spec (caller acts) or None."""
        spec = self.spec
        if spec is None:
            return None
        if spec.key and key is not None and key != spec.key:
            return None
        if spec.rate < 1.0 and random.random() >= spec.rate:
            return None
        with _lock:
            if self.spec is not spec:  # disarmed/re-armed under us
                return None
            if spec.after > 0:  # onset delay: let the first N draws pass
                spec.after -= 1
                return None
            if spec.count == 0:
                return None
            if spec.count > 0:
                spec.count -= 1
                if spec.count == 0:
                    self.spec = None
            self.fired += 1
        return spec

    def hit(self, key: str | None = None) -> None:
        """The standard seam check: no-op disarmed; armed, raises
        (`error`) or sleeps (`latency`) when the draw fires."""
        if self.spec is None:
            return
        spec = self.draw(key)
        if spec is not None:
            act(self.name, spec)


def act(name: str, spec: FaultSpec) -> None:
    """Perform a drawn spec's behavior (raise or sleep)."""
    if spec.mode == "latency":
        time.sleep(spec.ms / 1000.0)
    elif spec.mode == "error":
        raise FaultInjected(f"injected fault at {name}")


_lock = threading.Lock()
_points: dict[str, FaultPoint] = {}


def register(name: str) -> FaultPoint:
    """Seam registration. Idempotent; the name must be in ALL_POINTS."""
    if name not in ALL_POINTS:
        raise ValueError(f"undeclared fault point {name!r}"
                         f" (add it to faults.ALL_POINTS)")
    with _lock:
        p = _points.get(name)
        if p is None:
            p = _points[name] = FaultPoint(name)
        return p


def point(name: str) -> FaultPoint:
    """Lookup-or-register — the arming side's handle."""
    return register(name)


def arm(name: str, mode: str, rate: float = 1.0, ms: float = 0.0,
        count: int = -1, key: str = "", after: int = 0) -> FaultSpec:
    """Arm one point. Validates the mode and numeric ranges; replaces
    any existing spec on the point."""
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r} (one of {MODES})")
    rate, ms, count, after = float(rate), float(ms), int(count), int(after)
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"rate {rate} not in (0, 1]")
    if ms < 0 or ms != ms:
        raise ValueError(f"bad latency {ms}")
    if after < 0:
        raise ValueError(f"after {after} < 0")
    spec = FaultSpec(mode=mode, rate=rate, ms=ms, count=count, key=key,
                     after=after)
    p = point(name)
    with _lock:
        p.spec = spec
    return spec


def disarm(name: str) -> bool:
    """Disarm one point; True if it was armed."""
    p = point(name)
    with _lock:
        was = p.spec is not None
        p.spec = None
    return was


def disarm_all() -> int:
    """Back to the zero-injection steady state; returns how many points
    were armed."""
    n = 0
    with _lock:
        for p in _points.values():
            if p.spec is not None:
                p.spec = None
                n += 1
    return n
